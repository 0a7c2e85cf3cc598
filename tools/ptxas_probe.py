"""Registers, spills and wgmma serialisation of the port's Hopper GEMM
kernels, per instance, from ptxas and the SASS: compile only, on a machine
with the CUDA toolkit (no device is used).

    python3 tools/ptxas_probe.py                         # K1, K7 and K8 sources
    python3 tools/ptxas_probe.py --csrc build/parent/src/repro_torch/kernels/csrc
    python3 tools/ptxas_probe.py --ablations             # + the C7518 cut-downs

For each source it prints one JSON line {"source", "variant", "seconds",
"kernels": {instance: {...}}} with, per kernel: registers, spill stores and
loads (bytes, ptxas -v), whether ptxas reported C7518 ("wgmma.mma_async
instructions are serialized due to ... WG.DP in divergent path") for it,
and from `cuobjdump -sass`: the HGMMA count, the WARPGROUP.DEPBAR count
(a wait on the wgmma group; serialised wgmmas carry one per HGMMA), the
local-memory STL / LDL count and how many of those lie inside the
mainloop (the shortest backward branch around every HGMMA; None if no
such branch is found).

--ablations compiles K1 at FT off, block and tile with 128- and 64-row
tiles from a copy of the sources in which one piece of code is cut (`ABLATIONS`; the results are wrong, only the compile is
looked at), to find which piece makes ptxas serialise the wgmmas. All
compiles run at once, one nvcc each. Outputs go under build/ptxas_probe/.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ptxas_probe"
SOURCES = ("ft_gemm_sm90", "ft_gemm_level_sm90", "grouped_sm90")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v")

#: One K1 level at one tile height, from the header alone.
PROBE = """#include "ft_gemm_sm90.cuh"
extern "C" int probe(int ak, int bk, const void* ta, const void* tb,
                     const void* g, void* st) {
  return (int)launch_level<PROBE_LV, PROBE_BM>(
      ak, bk, *static_cast<const CUtensorMap*>(ta),
      *static_cast<const CUtensorMap*>(tb),
      *static_cast<const Sm90Args*>(g), static_cast<cudaStream_t>(st));
}
"""

_SETMAX_DEC = ('  if constexpr (BM == 128) asm volatile("setmaxnreg.dec.sync.'
               'aligned.u32 40;\\n");\n')
_SETMAX_INC = ('  if constexpr (BM == 128) asm volatile("setmaxnreg.inc.sync.'
               'aligned.u32 232;\\n");\n')
#: name -> (levels it applies to, [(file, old text, new text)]).
ABLATIONS = {
    "base": ((0, 1, 2), []),
    # (the 64-row instances run no setmaxnreg: the same code as base)
    "no_setmaxnreg": ((0, 2), [("ft_gemm_sm90.cuh", _SETMAX_DEC, ""),
                               ("ft_gemm_sm90.cuh", _SETMAX_INC, "")]),
    "setmaxnreg_at_64": ((0, 2), [
        ("ft_gemm_sm90.cuh", _SETMAX_DEC, _SETMAX_DEC.replace(
            "if constexpr (BM == 128) ", "")),
        ("ft_gemm_sm90.cuh", _SETMAX_INC, _SETMAX_INC.replace(
            "if constexpr (BM == 128) ", ""))]),
    "wait0_always": ((0, 2), [("ft_gemm_sm90.cuh",
                               "    if (drain) wgmma_wait<0>();\n"
                               "    else wgmma_wait<1>();\n",
                               "    wgmma_wait<0>();\n")]),
    "no_splitk_store": ((0, 2), [("ft_gemm_sm90.cuh",
                                 "  if (g.splits > 1) {\n",
                                 "  if (false) {\n")]),
    "no_act_grad_store": ((0,), [("ft_gemm_sm90.cuh",
                                  "  if (g.act_grad != nullptr) {\n"
                                  "    consumer_sync<NT>();\n",
                                  "  if (false) {\n"
                                  "    consumer_sync<NT>();\n")]),
    "no_bias": ((0,), [("ft_gemm_sm90.cuh",
                        "  if (g.bias != nullptr) {\n"
                        "    for (int n = tid; n < kBN; n += NT)\n",
                        "  if (false) {\n"
                        "    for (int n = tid; n < kBN; n += NT)\n")]),
    "warpgroup0_smem": ((0,), [("ft_gemm_sm90.cuh",
                                "const uint32_t sa = smem_u32(pa) + "
                                "wg * kBoxBytes;",
                                "const uint32_t sa = smem_u32(pa);")]),
    "no_epilogue_stage": ((0,), [("ft_gemm_sm90.cuh",
                                  "  stage_tile(acc, stage, PITCH, g.act, "
                                  "false, tid);\n",
                                  "")]),
    "tile_no_step_verify": ((2,), [("ft_gemm_sm90.cuh",
                                    "} else if (g.verify_step && it + 1 < "
                                    "nst) {",
                                    "} else if (false) {")]),
    "tile_no_band_dot": ((2,), [("ft_gemm_sm90.cuh",
                                 "      if constexpr (TILE) opc.dot(pb, "
                                 "&bx.ks[it & 1][0][0], tid);\n"
                                 "      else opb.dot(ka, tid);\n",
                                 "      opb.dot(ka, tid);\n")]),
    "tile_no_final_verify": ((2,), [("ft_gemm_sm90.cuh",
                                     "  if constexpr (TILE)\n"
                                     "    verify_bands<BM, NT, false, false>"
                                     "(acc, opa, opb, opc, sc, bx, g, tid,\n"
                                     "                                       "
                                     "row0, col0, (float)g.K);\n",
                                     "")]),
}


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit(f"ptxas_probe: {name} not found (the CUDA toolkit)")


def _short(mangled: str, filt: str) -> str:
    """`kernel<args>` of a mangled kernel name."""
    name = subprocess.run([filt, mangled], capture_output=True,
                          text=True).stdout.strip() or mangled
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut]


def parse_ptxas(log: str):
    """{mangled: {regs, spill_st, spill_ld, c7518}} from ptxas -v."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"\(C7518\).*in the function '([^']+)'", line)
        if m:
            out.setdefault(m.group(1), {})["c7518"] = True
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur]["spill_st"] = int(m.group(1))
            out[cur]["spill_ld"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["regs"] = int(m.group(1))
    return out


def parse_sass(sass: str):
    """{mangled: {hgmma, depbar, stl_ldl, stl_ldl_in_loop}}: the loop is
    the shortest backward branch's span that holds every HGMMA (the
    mainloop over stages, its k-step verifications included)."""
    out, name, ops, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        hg = [a for a, op, _ in ops if op.startswith("HGMMA")]
        ls = [a for a, op, _ in ops if op.startswith(("STL", "LDL"))]
        loop = None
        for a, op, text in ops:
            if not op.startswith("BRA") or not hg:
                continue
            m = re.search(r"0x([0-9a-f]+)", text)
            t = (int(m.group(1), 16) if m else
                 labels.get((re.search(r"\((\.L_x_\d+)\)", text)
                             or [None, None])[1]))
            if t is not None and t <= hg[0] and a >= hg[-1] and (
                    loop is None or a - t < loop[1] - loop[0]):
                loop = (t, a)
        out[name] = dict(hgmma=len(hg),
                         depbar=sum(op.startswith("WARPGROUP.DEPBAR")
                                    for _, op, _ in ops),
                         stl_ldl=len(ls),
                         stl_ldl_in_loop=(None if loop is None else
                                          sum(loop[0] <= a <= loop[1]
                                              for a in ls)))

    pending = []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, ops, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)(.*)", line)
        if m and name:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            ops.append((addr, m.group(2), m.group(3)))
    close()
    return out


def compile_one(src: Path, tag: str, defines=(), include=None):
    nvcc = _tool("nvcc")
    cubin = OUT / f"{tag}.cubin"
    cmd = [nvcc, *FLAGS, *defines, "-o", str(cubin), str(src)]
    if include:
        cmd[1:1] = ["-I", str(include)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        return dict(tag=tag, error=(p.stdout + p.stderr)[-4000:])
    ptx = parse_ptxas(p.stdout + p.stderr)
    sass = parse_sass(subprocess.run([_tool("cuobjdump"), "-sass",
                                      str(cubin)], capture_output=True,
                                     text=True).stdout)
    filt = _tool("cu++filt")
    kernels = {}
    for mangled in sorted(set(ptx) | set(sass)):
        row = {"regs": None, "spill_st": 0, "spill_ld": 0, "c7518": False,
               **ptx.get(mangled, {}), **sass.get(mangled, {})}
        kernels[_short(mangled, filt)] = row
    return dict(tag=tag, seconds=round(secs, 1), kernels=kernels)


def ablation_tree(name: str, csrc: Path) -> Path:
    """A copy of csrc with the ablation's cuts applied."""
    tree = OUT / f"csrc_{name}"
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(csrc, tree)
    for fname, old, new in ABLATIONS[name][1]:
        path = tree / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"ptxas_probe: ablation {name}: the cut text is "
                             f"not found once in {fname}")
        path.write_text(text.replace(old, new))
    (tree / "probe.cu").write_text(PROBE)
    return tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(CSRC),
                    help="the kernels' csrc directory (default: this "
                         "checkout's)")
    ap.add_argument("--sources", default=",".join(SOURCES))
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--tag", default="", help="prefix of the output names")
    args = ap.parse_args()
    csrc = Path(args.csrc).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(csrc / f"{s}.cu", f"{args.tag}{s}", (), None, s, "full")
            for s in args.sources.split(",") if s]
    if args.ablations:
        for name, (levels, _) in ABLATIONS.items():
            tree = ablation_tree(name, csrc)
            shapes = [(lv, bm) for lv in levels for bm in (128, 64)]
            for lv, bm in shapes:
                jobs.append((tree / "probe.cu",
                             f"{args.tag}probe_{name}_lv{lv}_bm{bm}",
                             (f"-DPROBE_LV={lv}", f"-DPROBE_BM={bm}"), tree,
                             f"K1 level {lv}, BM {bm}", name))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = [(j, pool.submit(compile_one, j[0], j[1], j[2], j[3]))
                for j in jobs]
        failed = False
        for (src, tag, _, _, label, variant), fut in futs:
            res = fut.result()
            failed |= "error" in res
            print(json.dumps({"source": label, "variant": variant,
                              "csrc": str(csrc), **res}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
