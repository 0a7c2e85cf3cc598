"""Device times of the port's tensor-core kernels at their main-path
shapes, clean (FT block, no campaign), for one checkout of the port: the
GEMM family (K1, K5, K7, K8; K1 also FT off) or the flash family (K2 at
qwen2-7b's prefill and phi4-mini's training shape and at head dim 64 at
whisper-medium's encoder self-attention and cross-attention prefill, K3
and K4 at phi4-mini's training shape, K6 at the serving engine's 8 slots;
each also on its SIMT instance, pinned as `chip_smoke.py` pins it): the side
of an A/B comparison of two commits on one card. Prints one JSON line
{"src": ..., "times": {label: ms}}.

    python3 tools/kernel_ab.py --src build/parent/src   # an older checkout
    python3 tools/kernel_ab.py --src src                # this one
    python3 tools/kernel_ab.py --src src --family flash # K2, K3, K4, K6
    python3 tools/kernel_ab.py --src src --family levels  # K1, K7, K8 by level

The levels family times K1, K7 and K8 at FT off and at each level (block,
tile, inner), each FT level with a verification after every k-step
(verify "step", the default) and at the end only ("final"), so the cost
of the per-step verifications stands apart from the checksums'.

Run the two in turns in one call on the chip (parent, change, change,
parent) and compare within the call: each process builds its checkout's
kernels into that checkout's build/ at first use. Device time is the summed
duration of the call's kernels under `torch.profiler`, per call, over 20
calls after 3 warm-up calls; operands are Gaussian bf16 from a fixed seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def kernel_ms(torch, fn, iters=20, warmup=3):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise SystemExit("the profiler saw no device time")
    return total / iters / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--family", choices=("gemm", "flash", "levels"),
                    default="gemm")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.policy import ONLINE_BLOCK
    from repro_torch.kernels import ft_gemm, grouped_gemm
    from repro_torch.kernels import grouped as kgrouped
    ft = ONLINE_BLOCK.replace(backend="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    if args.family in ("flash", "levels"):
        times = (flash_times if args.family == "flash" else level_times)(
            torch, ft, rand, gen)
        print(json.dumps({"src": args.src, "family": args.family,
                          "card": torch.cuda.get_device_name(0),
                          "times": times}))
        return 0
    times = {}
    k1 = [("K1 decode w_gate+silu 4x3584x18944", 4, 3584, 18944, ("silu",),
           False),
          ("K1 prefill w_gate+silu 512x3584x18944", 512, 3584, 18944,
           ("silu",), False),
          ("K1 train w_gate+silu act_grad 1024x3072x8192", 1024, 3072, 8192,
           ("silu",), True),
          ("K1 square 4096", 4096, 4096, 4096, (), False)]
    for label, m, k, n, chain, ag in k1:
        a, b = rand(m, k), rand(k, n, scale=0.02)
        for name, f in (("block", ft), ("off", None)):
            times[f"{label} {name}"] = kernel_ms(torch, lambda: ft_gemm.ft_gemm(
                a, b, chain=chain, ft=f, save_act_grad=ag and f is not None))
    # K1's dw = x^T g of training (an A whose m dim has unit stride)
    x, g = rand(1024, 3072), rand(1024, 8192, scale=0.02)
    times["K1 train dw x^T g 3072x1024x8192 block"] = kernel_ms(
        torch, lambda: ft_gemm.ft_gemm(x.T, g, ft=ft))
    # K5: decode attention's products against a 256-position cache
    q, kc = rand(4, 4, 7, 128), rand(4, 4, 256, 128)
    times["K5 dec_qk 4x4x(7x256x128) block"] = kernel_ms(
        torch, lambda: ft_gemm.ft_gemm(q, kc.transpose(-1, -2), ft=ft))
    # K7 and K8: qwen3-moe-235b-a22b's expert GEMMs (128 experts, 4096 ->
    # 1536, top-8)
    e, d, f = 128, 4096, 1536
    for label, rows in (("decode gate 64 rows", 64),
                        ("train gate 8192 rows", 8192)):
        ids = torch.randint(0, e, (rows,), generator=gen, device="cuda")
        lay = kgrouped.make_layout(ids, e, 16)
        buf = kgrouped.scatter_rows(rand(rows, d), lay)
        w = rand(e, d, f, scale=0.02)
        times[f"K7 {label} block"] = kernel_ms(
            torch, lambda: grouped_gemm.ft_gemm_grouped(
                buf, w, lay.gid, lay.row_end, ft=ft))
        if rows == 8192:
            gb = kgrouped.scatter_rows(rand(rows, f), lay)
            times["K8 train dw 8192 rows block"] = kernel_ms(
                torch, lambda: grouped_gemm.tgmm(buf, gb, lay.row_end,
                                                 bm=16, ft=ft), iters=5)
    print(json.dumps({"src": args.src, "card": torch.cuda.get_device_name(0),
                      "times": times}))
    return 0


def level_times(torch, ft, rand, gen):
    """K1 (training's w_gate+silu with act_grad, its dw on x.T, the 4 096
    square, qwen2-7b's decode w_gate+silu), K7 (qwen3-moe's decode gate
    and training dbuf) and K8 (qwen3-moe's training dw of the gate, f32
    out) at FT off and at block / tile / inner, verifying every k-step (K8:
    every 64-row stage) and at the end only."""
    from repro_torch.kernels import ft_gemm, grouped_gemm
    from repro_torch.kernels import grouped as kgrouped
    cases = [(None, "off")] + [
        (ft.replace(level=lv, verify=vf), f"{lv} {vf}")
        for lv in ("block", "tile", "inner") for vf in ("step", "final")]
    times = {}
    x, g = rand(1024, 3072), rand(1024, 8192, scale=0.02)
    w = rand(3072, 8192, scale=0.02)
    sq_a, sq_b = rand(4096, 4096), rand(4096, 4096, scale=0.02)
    dec_a, dec_b = rand(4, 3584), rand(3584, 18944, scale=0.02)
    e, d, f, rows = 128, 4096, 1536, 64
    ids = torch.randint(0, e, (rows,), generator=gen, device="cuda")
    lay = kgrouped.make_layout(ids, e, 16)
    buf = kgrouped.scatter_rows(rand(rows, d), lay)
    wg = rand(e, d, f, scale=0.02)
    ids8 = torch.randint(0, e, (8192,), generator=gen, device="cuda")
    lay8 = kgrouped.make_layout(ids8, e, 16)
    gbuf = kgrouped.scatter_rows(rand(8192, f), lay8)
    wd = rand(e, d, f, scale=0.02).transpose(-1, -2)   # dbuf = g · wᵀ
    xbuf = kgrouped.scatter_rows(rand(8192, d), lay8)  # dw = xᵀ g per expert
    for fc, name in cases:
        calls = {
            "K1 act_grad 1024x3072x8192": lambda: ft_gemm.ft_gemm(
                x, w, chain=("silu",), ft=fc, save_act_grad=fc is not None),
            "K1 dw x^T g 3072x1024x8192": lambda: ft_gemm.ft_gemm(
                x.T, g, ft=fc),
            "K1 square 4096": lambda: ft_gemm.ft_gemm(sq_a, sq_b, ft=fc),
            "K1 decode w_gate+silu 4x3584x18944": lambda: ft_gemm.ft_gemm(
                dec_a, dec_b, chain=("silu",), ft=fc),
            "K7 decode gate 64 rows": lambda: grouped_gemm.ft_gemm_grouped(
                buf, wg, lay.gid, lay.row_end, ft=fc),
            "K7 train dbuf 8192 rows": lambda: grouped_gemm.ft_gemm_grouped(
                gbuf, wd, lay8.gid, lay8.row_end, ft=fc),
            "K8 train dw 8192 rows": lambda: grouped_gemm.tgmm(
                xbuf, gbuf, lay8.row_end, bm=16, ft=fc),
        }
        for label, fn in calls.items():
            times[f"{label} {name}"] = kernel_ms(
                torch, fn, iters=5 if label.startswith("K8") else 20)
    return times


def flash_times(torch, ft, rand, gen):
    """K2, K3, K4 and K6 clean, through their wrappers (the plans pick the
    tensor-core instances and K4's and K6's ranges), and each again on its
    SIMT instance (pinned blocks; K6 pinned with ``simt``)."""
    from repro_torch.kernels import flashft
    times = {}
    # K2: qwen2-7b's prefill (4 x 128 tokens, 28 heads / 4 kv heads) and
    # phi4-mini's training forward (2 x 512, 24 / 8, with the statistics)
    for label, b, s, h, kvh, stats in (("prefill 4x128 28/4", 4, 128, 28, 4,
                                        False),
                                       ("train 2x512 24/8 stats", 2, 512, 24,
                                        8, True)):
        q, k, v = rand(b * h, s, 128), rand(b * kvh, s, 128), \
            rand(b * kvh, s, 128)
        kw = dict(ft=ft, scale=128 ** -0.5, tau_dh=128, n_rep=h // kvh,
                  causal=True, save_stats=stats)
        times[f"K2 {label}"] = kernel_ms(
            torch, lambda: flashft.flash_ft_fwd(q, k, v, **kw))
        times[f"K2 simt {label}"] = kernel_ms(
            torch, lambda: flashft.flash_ft_fwd(q, k, v, bq=64, bkv=64, **kw))
    # K2 at head dim 64: whisper-medium's prefill (4 x 16 heads, MHA) over
    # 1 500 frames, the encoder's self-attention and the cross-attention
    for label, sq in (("whisper encoder 64x1500x1500 dh 64", 1500),
                      ("whisper cross 64x16x1500 dh 64", 16)):
        q, k, v = rand(64, sq, 64), rand(64, 1500, 64), rand(64, 1500, 64)
        kw = dict(ft=ft, scale=64 ** -0.5, tau_dh=128, causal=False)
        times[f"K2 {label}"] = kernel_ms(
            torch, lambda: flashft.flash_ft_fwd(q, k, v, **kw))
        times[f"K2 simt {label}"] = kernel_ms(
            torch, lambda: flashft.flash_ft_fwd(q, k, v, bq=64, bkv=64, **kw),
            iters=5)
    # K3 and K4: phi4-mini's training backward
    kw = dict(ft=ft, scale=128 ** -0.5, tau_dh=128, n_rep=3, causal=True)
    q, k, v, g = (rand(*shape) for shape in ((48, 512, 128), (16, 512, 128),
                                             (16, 512, 128), (48, 512, 128)))
    o, m, l, _ = flashft.flash_ft_fwd(q, k, v, save_stats=True, **kw)
    di = (g.float() * o.float()).sum(-1)
    times["K3 train 2x512 24/8"] = kernel_ms(
        torch, lambda: flashft.flash_ft_dq(q, k, v, g, m, l, di, **kw))
    times["K4 train 2x512 24/8 (with its reduce)"] = kernel_ms(
        torch, lambda: flashft.flash_ft_dkv(q, k, v, g, m, l, di, **kw))
    pin = dict(kw, bq=64, bkv=64)
    times["K3 simt train 2x512 24/8"] = kernel_ms(
        torch, lambda: flashft.flash_ft_dq(q, k, v, g, m, l, di, **pin))
    times["K4 simt train 2x512 24/8"] = kernel_ms(
        torch, lambda: flashft.flash_ft_dkv(q, k, v, g, m, l, di, **pin))
    # K6: the engine's 8 slots of qwen2-7b (4 kv heads x 7 query rows,
    # padded to 16), pages of 64, lengths up to 1024 (with its combine)
    lengths = (0, 1, 63, 64, 65, 300, 777, 1024)
    page, kvh = 64, 4
    mp = -(-max(lengths) // page)
    n_pages = 1 + len(lengths) * mp
    kp, vp = rand(n_pages, kvh, page, 128), rand(n_pages, kvh, page, 128)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :len(lengths) * mp] + 1).view(len(lengths), mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = torch.zeros(len(lengths) * kvh, 16, 128, device="cuda",
                     dtype=torch.bfloat16)
    qd[:, :7] = rand(len(lengths) * kvh, 7, 128)
    for label, simt in (("", False), ("simt ", True)):
        times[f"K6 {label}engine 8 slots 4x7 page 64"] = kernel_ms(
            torch, lambda: flashft.flash_ft_decode(
                qd, kp, vp, lens, table, ft=ft, scale=128 ** -0.5,
                tau_dh=128, simt=simt))
    return times


if __name__ == "__main__":
    sys.exit(main())
