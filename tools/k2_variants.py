"""Device times of K2 on the tensor cores at whisper-medium's head-dim-64
shapes (the encoder's self-attention, 64 heads x 1 500 x 1 500, and the
prefill's cross-attention, 64 x 16 x 1 500, non-causal), with the dh-128
rows of `tools/kernel_ab.py --family flash` beside them, for variants of
`csrc/flash_fwd_sm90.cu`: the design choices of its dh-64 instance tried
against each other, and cuts of one piece of its kv step (whose results
are wrong: only the time is read) that show where the step's time goes.

Each variant is a copy of src/repro_torch under build/k2_variants/<name>
with the edits of `VARIANTS`; each run builds the K2 sources of one tree
alone and times it in its own process (profiler device time a call over
50 calls, `kernel_ab.kernel_ms`); the unmodified tree runs first and
last. Prints one JSON line per run; "matches_plain" says whether the
encoder call agreed with its plain version (bf16 tolerance, reports).

    python3 tools/k2_variants.py                     # every variant
    python3 tools/k2_variants.py --only wgs2,ring3   # some of them
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "kernels/csrc/flash_fwd_sm90.cu"
OUT = ROOT / "build" / "k2_variants"

_WGS = ("constexpr int fwd_wgs() { return DH == 64 ? 3 : 2; }",)
_S_VERIFY = """    verify_frag<kB>(sd, w.ck_col, w.ck_row, g.tau_qk_coef * qmax * mx.x,
                    (float)(it + 1), g.corrects, q_start, kv_start, w.vf,
                    w.rep, t, bar);
"""
_D_VERIFY = """    verify_frag<DH>(dl, w.ck_col, w.ck_row, g.tau_coef * eff_kv * mx.y,
                    eff_kv, g.corrects, q_start, 0, w.vf, w.rep, t, bar);
"""
#: (start, end) of the S step's and the delta's checksum code, cut whole
_S_CHECKS = ("    float km, vm = 0.0f;\n", "    const float2 mx = wg_max2")
_D_CHECKS = ("    if constexpr (DH == 64) {\n      p_checks(",
             "    wgmma_wait<0>();\n    fence_frag(dl);")

#: name -> [(old text, new text)] or [((start, end), new text)]: a span
#: from start up to end (exclusive) replaced.
VARIANTS = {
    # the dh-64 instance with two consumer warpgroups a CTA (the dh-128
    # instances' count) and with four (640 threads, 96 registers; no
    # setmaxnreg, whose register pool the launch bound leaves no room for)
    "wgs2": [(_WGS[0], "constexpr int fwd_wgs() { return 2; }")],
    "wgs4": [(_WGS[0], "constexpr int fwd_wgs() { return DH == 64 ? 4 : 2; }"),
             ('static_assert(NWG == 2 || NWG == 3, "two or three consumer '
              'warpgroups");', 'static_assert(NWG >= 2 && NWG <= 4, "");'),
             ("    else\n      asm volatile(\"setmaxnreg.dec",
              "    else if constexpr (NWG == 3)\n      asm volatile(\"setmaxnreg.dec"),
             ("  else\n    asm volatile(\"setmaxnreg.inc",
              "  else if constexpr (NWG == 3)\n    asm volatile(\"setmaxnreg.inc")],
    # three ring stages of K and V in place of two
    "ring3": [("constexpr int kRing = 2;", "constexpr int kRing = 3;")],
    # P by the fast exponential
    "fast_exp": [("? expf(fminf(s[idx] - m_new[hf], 0.0f))",
                  "? __expf(fminf(s[idx] - m_new[hf], 0.0f))")],
    # cuts: no verification of S, of the delta; none of S's checksums
    # (K^T e, K·(e^T Q), V e, Q·(K^T e)), of the delta's; all four
    "cut_s_verify": [(_S_VERIFY, "")],
    "cut_d_verify": [(_D_VERIFY, "")],
    "cut_s_checks": [(_S_CHECKS, "    float km = 1.0f, vm = 1.0f;\n")],
    "cut_d_checks": [(_D_CHECKS, "")],
    "cut_all_abft": [(_S_VERIFY, ""), (_D_VERIFY, ""),
                     (_S_CHECKS, "    float km = 1.0f, vm = 1.0f;\n"),
                     (_D_CHECKS, "")],
}


def make_variant(name: str, edits) -> Path:
    """Copy src/repro_torch to build/k2_variants/<name> with the edits."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "repro_torch" / KERNEL
    text = path.read_text()
    for old, new in edits:
        if isinstance(old, tuple):
            a = text.index(old[0])
            text = text[:a] + new + text[text.index(old[1], a):]
        else:
            if old not in text:
                raise SystemExit(f"{name}: edit anchor not found: {old[:60]!r}")
            text = text.replace(old, new)
    path.write_text(text)
    return dst


def time_tree(src: str) -> dict:
    """Build one tree's K2 sources and time its calls (run in a child)."""
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    from kernel_ab import kernel_ms
    from repro_torch.core.policy import ONLINE_BLOCK
    from repro_torch.kernels import build, flashft
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA device")
    build.SOURCES = ("flash_fwd_sm90", "flash_ft")
    ft = ONLINE_BLOCK.replace(backend="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    times, ok = {}, None
    for label, bh, sq, skv, dh, n_rep, causal, stats in (
            ("whisper encoder 64x1500x1500 dh 64", 64, 1500, 1500, 64, 1,
             False, False),
            ("whisper cross 64x16x1500 dh 64", 64, 16, 1500, 64, 1, False,
             False),
            ("prefill 4x128 28/4 dh 128", 112, 128, 128, 128, 7, True, False),
            ("train 2x512 24/8 stats dh 128", 48, 512, 512, 128, 3, True,
             True)):
        q = rand(bh, sq, dh)
        k, v = rand(bh // n_rep, skv, dh), rand(bh // n_rep, skv, dh)
        kw = dict(ft=ft, scale=dh ** -0.5, tau_dh=128, n_rep=n_rep,
                  causal=causal, save_stats=stats)
        if ok is None:
            got = flashft.flash_ft_fwd(q, k, v, **kw)
            want = flashft.flash_ft_plain(q, k, v, **kw)
            err = (got[0].float() - want[0].float()).abs().max().item()
            ok = (err <= 2 ** -7 * want[0].float().abs().max().item()
                  and torch.equal(got[-1][..., :4], want[-1][..., :4]))
        times[label] = kernel_ms(
            torch, lambda: flashft.flash_ft_fwd(q, k, v, **kw), iters=50)
    return {"card": torch.cuda.get_device_name(0), "matches_plain": ok,
            "times": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_tree(args.time)))
        return 0
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; one of {list(VARIANTS)}")
    trees = [("unmodified", ROOT / "src")]
    trees += [(n, make_variant(n, VARIANTS[n])) for n in names]
    trees.append(("unmodified", ROOT / "src"))
    rc = 0
    for name, tree in trees:
        res = subprocess.run([sys.executable, __file__, "--time", str(tree)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(json.dumps({"variant": name, "error": res.stderr[-2000:]}))
            rc = 1
            continue
        print(json.dumps({"variant": name,
                          **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
