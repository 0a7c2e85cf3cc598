"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                    # every phase, as run on the card
    python3 chip_smoke.py --phases env,kernels

Phases (each prints its own lines; any failed check exits non-zero):

  env          card name and power limit (nvidia-smi), torch / CUDA
               versions, the nvcc build of every kernel source with its
               -Xptxas -v register / shared-memory / spill lines;
  kernels      each CUDA kernel against its plain PyTorch version on the card
               at the serving path's shapes in bf16 (qwen2-7b, 4 requests of
               128 tokens): max error, report agreement, a deterministic SEU
               on integer-valued operands (corrected, located), and CUDA-event
               times of the kernel, its plain version and one PyTorch library
               call computing the same product without ABFT;
  serve_check  qwen2-7b at full width, depth cut to 2 layers: prefill and 2
               decode steps (the same tokens fed to both) through the kernels
               and through their plain versions; logits agree within 2e-2 of
               max|logit|, no detection; then each path fed its own greedy
               tokens, printed with the top-2 margins (not checked);
  serve        `repro_torch.train.serve.generate` on qwen2-7b at full width
               and depth (random bf16 weights from a seed): 4 requests x 128
               prompt tokens, 32 greedy tokens, once under a dispatch guard
               (every kernel's launch count from that run, no library matmul
               / attention call on the FT path), once timed without it.

The last two lines are {"kernels": [...]} and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import torch
import torch.utils._python_dispatch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import qwen2_7b                        # noqa: E402
from repro_torch.configs.base import RunConfig                  # noqa: E402
from repro_torch.core import telemetry                          # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK               # noqa: E402
from repro_torch.kernels import build, flashft, ft_gemm         # noqa: E402
from repro_torch.models import transformer                      # noqa: E402
from repro_torch.train import serve                             # noqa: E402

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FT = ONLINE_BLOCK.replace(backend="pallas")
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 4, 128, 32, 256
#: kernel vs plain: one bf16 ulp at the top of the output's range (the two
#: sum in different orders in f32, then round to bf16).
BF16_TOL = 2.0 ** -7

KERNELS = {
    "ft_gemm_2d": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/ft_gemm.cu",
                       replaces="src/repro/kernels/templates/registry.py:48",
                       counter=ft_gemm.FT_GEMM_2D),
    "ft_gemm_batched": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/ft_gemm.cu",
                            replaces="src/repro/kernels/templates/"
                                     "registry.py:520",
                            counter=ft_gemm.FT_GEMM_BATCHED),
    "flash_ft": dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_ft.cu",
                     replaces="src/repro/kernels/flashft.py:114",
                     counter=flashft.FLASH_FT),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops: float, nbytes: float):
    t_op, t_by = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------

def phase_env() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    builds = build.build_all()
    print(f"nvcc build of {len(builds)} sources (in parallel): "
          f"{time.perf_counter() - t0:.1f} s wall")
    for rec in builds.values():
        print(f"  {rec.name}.cu: {rec.seconds:.1f} s -> {rec.path.name}")
        fn = None
        for line in rec.log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "Used" in line or "spill" in line:
                print(f"    {fn[:60] if fn else ''}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _rand(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _ints(gen, *shape):
    return torch.randint(-2, 3, shape, generator=gen, device="cuda"
                         ).to(torch.bfloat16)


def _plain_gemm(a, b, **kw):
    return ft_gemm.ft_gemm_plain(a, b, tiles=ft_gemm.pick_tiles(a.shape[-2]),
                                 **kw)


def _cmp_outputs(name, got, want, rep_k=None, rep_p=None):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    check(err <= BF16_TOL * scale,
          f"{name}: max|kernel - plain| {err:.3g} <= {BF16_TOL:.4f} x "
          f"{scale:.3g}")
    if rep_k is not None:
        check(torch.equal(rep_k[..., 0], rep_p[..., 0])
              and torch.equal(rep_k[..., 7], rep_p[..., 7]),
              f"{name}: report det / k fields equal")
        tau_rel = ((rep_k[..., 6] - rep_p[..., 6]).abs()
                   / rep_p[..., 6].abs().clamp_min(1e-30)).max().item()
        check(tau_rel <= 1e-5, f"{name}: report tau within 1e-5 ({tau_rel:.2g})")
        check(bool((rep_k[..., 5] < rep_k[..., 6]).all())
              and float(rep_k[..., 0].sum()) == 0.0,
              f"{name}: clean run, max residual below tau, no detection")
    return err


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = qwen2_7b.CONFIG
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    qd, kvd = cfg.qkv_dims
    m_pre, m_dec = BATCH * PROMPT, BATCH
    rows = {}

    # ---- K1: the 2-D ABFT GEMM at the projection shapes ------------------
    k1_cases = [  # (label, M, N, K, chain)
        ("prefill wq+bias", m_pre, qd, d, ("bias",)),
        ("prefill w_gate+silu", m_pre, dff, d, ("silu",)),
        ("prefill w_down", m_pre, d, dff, ()),
        ("decode wk+bias", m_dec, kvd, d, ("bias",)),
        ("decode w_gate+silu", m_dec, dff, d, ("silu",)),
        ("decode w_down", m_dec, d, dff, ()),
        ("decode lm_head", m_dec, v, d, ()),
    ]
    k1_err, k1_rows = 0.0, []
    for label, m, n, k, chain in k1_cases:
        a = _rand(gen, m, k)
        b = _rand(gen, k, n, scale=0.02)
        bias = _rand(gen, n, scale=0.02) if "bias" in chain else None
        kw = dict(chain=chain, bias=bias, ft=FT)
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        out_p, rep_p = _plain_gemm(a, b, **kw)
        k1_err = max(k1_err, _cmp_outputs(f"K1 {label}", out, out_p, rep,
                                          rep_p))
        iters = 3 if m == m_pre or n == v else 10
        ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, **kw), iters)
        ms_off = time_ms(lambda: ft_gemm.ft_gemm(a, b, chain=chain, bias=bias,
                                                 ft=None), iters)
        plain_ms = time_ms(lambda: _plain_gemm(a, b, **kw), 1, warmup=0)
        lib = ((lambda: torch.addmm(bias, a, b)) if bias is not None
               else (lambda: torch.matmul(a, b)))
        lib_ms = time_ms(lib, iters)
        nbytes = 2 * (m * k + k * n + m * n + (n if bias is not None else 0))
        b_ms, b_by = bound(2.0 * m * n * k, nbytes)
        k1_rows.append(dict(shape=label, M=m, N=n, K=k, ms=ms, ft_off_ms=ms_off,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 {label} ({m}x{n}x{k}): kernel {ms:.3f} ms, FT off "
              f"{ms_off:.3f} ms (FT overhead {ms / ms_off:.3f}x), plain "
              f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    # Deterministic SEUs on integer-valued operands at the decode wq shape:
    # one at the last k step (verified after the bias fold), one mid-way.
    a, b, bias = _ints(gen, m_dec, d), _ints(gen, d, qd), _ints(gen, qd)
    clean, _ = ft_gemm.ft_gemm(a, b, chain=("bias",), bias=bias, ft=FT)
    for row, col, step in ((m_dec - 1, qd - 1, d // 32 - 1), (1, 700, 5)):
        out, rep = ft_gemm.ft_gemm(a, b, chain=("bias",), bias=bias, ft=FT,
                                   inj=(1, -1, row, col, step), inj_mag=1000.0)
        bn = ft_gemm.pick_tiles(m_dec)[1]
        cell = rep[0, col // bn]
        check(torch.equal(out, clean) and float(rep[..., 0].sum()) == 1.0
              and int(cell[2]) == row and int(cell[3]) == col
              and abs(float(cell[4]) - 1000.0) < 1e-3,
              f"K1 SEU at (row {row}, col {col}, step {step}) corrected bit "
              f"for bit and located")
    rows["ft_gemm_2d"] = dict(max_abs_err=k1_err, detail=k1_rows,
                              headline="decode w_gate+silu")

    # ---- K5: the batched ABFT GEMM at the decode attention operands ------
    # As `blocks.decode_attention` passes them: the grouped queries / probs
    # (B, KVH, rep, ·) against strided views of the (B, S, KVH, dh) cache.
    kvh, rep_n = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    b_kv, dh = BATCH * kvh, cfg.head_dim

    def k5_operands(make):
        k_cache, v_cache = (make(gen, BATCH, MAX_LEN, kvh, dh)
                            for _ in range(2))
        return {"dec_qk": (make(gen, BATCH, kvh, rep_n, dh),
                           k_cache.permute(0, 2, 3, 1)),
                "dec_pv": (make(gen, BATCH, kvh, rep_n, MAX_LEN),
                           v_cache.transpose(1, 2))}

    k5_err, k5_rows = 0.0, []
    for label, (a, b) in k5_operands(_rand).items():
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        out, rep = ft_gemm.ft_gemm(a, b, ft=FT)
        out_p, rep_p = _plain_gemm(a, b, ft=FT)
        k5_err = max(k5_err, _cmp_outputs(f"K5 {label}", out, out_p, rep,
                                          rep_p))
        ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT), 20)
        b_dense = b.contiguous()
        ms_dense = time_ms(lambda: ft_gemm.ft_gemm(a, b_dense, ft=FT), 20)
        plain_ms = time_ms(lambda: _plain_gemm(a, b, ft=FT), 2)
        lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
        b_ms, b_by = bound(2.0 * b_kv * m * n * k,
                           2 * b_kv * (m * k + k * n + m * n))
        k5_rows.append(dict(shape=label, batch=b_kv, M=m, N=n, K=k, ms=ms,
                            contiguous_b_ms=ms_dense, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"  K5 {label} ({BATCH}x{kvh}x{m}x{n}x{k}, B a strided view "
              f"of the cache): kernel {ms:.4f} ms (contiguous B "
              f"{ms_dense:.4f} ms), plain {plain_ms:.3f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    a, b = k5_operands(_ints)["dec_pv"]
    clean, _ = ft_gemm.ft_gemm(a, b, ft=FT)
    out, rep = ft_gemm.ft_gemm(a, b, ft=FT, inj=(1, -1, rep_n - 1, dh - 1, 3),
                               inj_mag=500.0)
    cell = rep[:, :, 0, 0]
    check(torch.equal(out, clean) and float(rep[..., 0].sum()) == b_kv
          and bool((cell[..., 2] == rep_n - 1).all())
          and bool((cell[..., 3] == dh - 1).all()),
          "K5 SEU broadcast into every slice, corrected bit for bit, located")
    rows["ft_gemm_batched"] = dict(max_abs_err=k5_err, detail=k5_rows,
                                   headline="dec_qk")

    # ---- K2: flash attention at the prefill shape -------------------------
    bh, g = BATCH * cfg.n_heads, BATCH * cfg.n_kv_heads
    q, k, vv = (_rand(gen, bh, PROMPT, dh), _rand(gen, g, PROMPT, dh),
                _rand(gen, g, PROMPT, dh))
    fkw = dict(ft=FT, scale=dh ** -0.5, tau_dh=dh, n_rep=bh // g, causal=True)
    out, rep = flashft.flash_ft_fwd(q, k, vv, **fkw)
    out_p, rep_p = flashft.flash_ft_plain(q, k, vv, **fkw)
    k2_err = _cmp_outputs("K2 prefill flash", out, out_p)
    check(float(rep[..., 0].sum()) == 0.0 and torch.equal(rep[..., 7],
                                                           rep_p[..., 7]),
          "K2 report: no detection, k fields equal")
    ms = time_ms(lambda: flashft.flash_ft_fwd(q, k, vv, **fkw), 20)
    plain_ms = time_ms(lambda: flashft.flash_ft_plain(q, k, vv, **fkw), 2)
    # SDPA yardstick on the same heads, KV repeated before timing.
    q4 = q.view(BATCH, cfg.n_heads, PROMPT, dh)
    k4, v4 = (x.view(BATCH, cfg.n_kv_heads, PROMPT, dh).repeat_interleave(
        bh // g, dim=1) for x in (k, vv))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True)
    lib_ms = time_ms(sdpa, 20)
    pairs = PROMPT * (PROMPT + 1) // 2
    b_ms, b_by = bound(4.0 * dh * pairs * bh,
                       2 * dh * PROMPT * (2 * bh + 2 * g))
    print(f"  K2 prefill flash ({bh} heads / {g} kv heads, S {PROMPT}, dh "
          f"{dh}, causal): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    qi, ki, vi = _ints(gen, bh, PROMPT, dh), _ints(gen, g, PROMPT, dh), \
        _ints(gen, g, PROMPT, dh)
    clean, _ = flashft.flash_ft_fwd(qi, ki, vi, **fkw)
    out, rep = flashft.flash_ft_fwd(qi, ki, vi, inj=(1, bh - 1, 1, 1, 63, 127),
                                    inj_mag=300.0, **fkw)
    cell = rep[bh - 1, 1]
    _cmp_outputs("K2 SEU corrected output vs clean", out, clean)
    check(float(rep[..., 0].sum()) == 1.0 and int(cell[2]) == 127
          and int(cell[3]) == 127,
          "K2 SEU in the PV delta located at (row 127, col 127)")
    rows["flash_ft"] = dict(max_abs_err=k2_err, detail=[dict(
        shape="prefill flash", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)], headline="prefill flash")
    return rows


# ---------------------------------------------------------------------------
# serve_check / serve
# ---------------------------------------------------------------------------

@contextmanager
def plain_kernels():
    """Swap each kernel wrapper for its plain version on the card (the
    comparison side of serve_check)."""
    saved = ft_gemm.ft_gemm, flashft.flash_ft_fwd

    def gemm(a, b, *, tiles=None, **kw):
        return ft_gemm.ft_gemm_plain(
            a, b, tiles=tiles or ft_gemm.pick_tiles(a.shape[-2]), **kw)

    def flash(q, k, v, *, bq=None, bkv=None, **kw):
        return flashft.flash_ft_plain(q, k, v, bq=bq or flashft.BLOCK,
                                      bkv=bkv or flashft.BLOCK, **kw)

    ft_gemm.ft_gemm, flashft.flash_ft_fwd = gemm, flash
    try:
        yield
    finally:
        ft_gemm.ft_gemm, flashft.flash_ft_fwd = saved


def phase_serve_check():
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=2)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    params = transformer.init(cfg, seed=1, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    # The same decode tokens for both paths: on random weights the logits
    # are near-flat, so each path's own argmax could pick another token.
    steps = torch.randint(0, cfg.vocab_size, (2, BATCH, 1), generator=gen)
    prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)

    def run_path(feed):
        """Prefill and 2 decode steps; ``feed`` None feeds each step the
        path's own greedy tokens."""
        with telemetry.ft_scope() as scope:
            cache = transformer.init_cache(cfg, BATCH, MAX_LEN)
            logits, cache = prefill_fn(params, prompts.cuda(), cache)
            out = [logits.float().reshape(BATCH, -1)]
            for i in range(2):
                tok = (torch.argmax(out[-1], -1)[:, None] if feed is None
                       else feed[i].cuda())
                logits, cache = decode_fn(params, tok, cache)
                out.append(logits.float().reshape(BATCH, -1))
            return out, scope.totals()

    got, tot_k = run_path(steps)
    with plain_kernels():
        want, tot_p = run_path(steps)
    for i, (g_, w_) in enumerate(zip(got, want)):
        err = (g_ - w_).abs().max().item()
        scale = w_.abs().max().item()
        check(bool(torch.isfinite(g_).all()) and err <= 2e-2 * scale,
              f"serve_check step {i}: max|kernel - plain| logits {err:.3g} "
              f"<= 2e-2 x {scale:.3g}")
    check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
          f"serve_check: zero detections (kernels {tot_k}, plain {tot_p})")
    # Each path fed its own greedy tokens (not checked: a flip is allowed
    # where the top-2 margin is below the kernel-vs-plain error).
    greedy_k, _ = run_path(None)
    with plain_kernels():
        greedy_p, _ = run_path(None)
    for i, (g_, w_) in enumerate(zip(greedy_k, greedy_p)):
        top2 = torch.topk(g_, 2, dim=-1).values
        print(f"  greedy step {i}: kernel argmax "
              f"{torch.argmax(g_, -1).tolist()}, plain argmax "
              f"{torch.argmax(w_, -1).tolist()}, kernel top-2 margin "
              f"{[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}, "
              f"max|kernel - plain| {(g_ - w_).abs().max().item():.3g}")


class LibraryCallGuard(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every dispatched library matmul / attention op."""
    BANNED = ("mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv",
              "linear", "scaled_dot_product_attention",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.BANNED:
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


def phase_serve(layers: int):
    cfg = qwen2_7b.CONFIG
    if layers != cfg.n_layers:
        print(f"  depth cut: {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.2f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(0)).numpy()
    sc = serve.ServeConfig(max_len=MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    # The main path's run, under the guard: launch counts and dispatched ops.
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard()
    with telemetry.ft_scope() as scope, guard:
        tokens = serve.generate(params, prompts, cfg, run, sc,
                                max_new_tokens=NEW_TOKENS, device="cuda")
        torch.cuda.synchronize()
    launches = {n: k["counter"].launches for n, k in KERNELS.items()}
    totals = scope.totals()
    # The timed run, without the guard's per-op Python (the first served
    # as warm-up); it must give the same greedy tokens.
    t0 = time.perf_counter()
    again = serve.generate(params, prompts, cfg, run, sc,
                           max_new_tokens=NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  generate: {tokens.shape} tokens in {wall:.2f} s "
          f"({tokens.size / wall:.2f} new tokens/s), peak memory "
          f"{peak:.1f} GiB")
    print(f"  launches (guarded run): {launches}; FT totals {totals}")
    check((again == tokens).all(), "the timed run repeats the greedy tokens")
    check(tokens.shape == (BATCH, NEW_TOKENS) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          "generate returned in-vocabulary tokens of the expected shape")
    check(not guard.hits, f"no library matmul / attention op dispatched "
          f"({sorted(set(guard.hits))})")
    per_step = cfg.n_layers * 7 + 1
    check(launches == {"ft_gemm_2d": per_step * (NEW_TOKENS + 1),
                       "ft_gemm_batched": 2 * cfg.n_layers * NEW_TOKENS,
                       "flash_ft": cfg.n_layers},
          f"launch counts: K1 {per_step} per prefill and per decode step, K5 "
          f"{2 * cfg.n_layers} per decode step, K2 {cfg.n_layers} per prefill")
    check(totals["detected"] == 0, "zero detections on the serving path")

    # Phase times through the same entry points: medians of 3 prefills and
    # of 8 decode steps, each timed alone.
    prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
    prompts_d = torch.as_tensor(prompts).cuda()
    pre = []
    for _ in range(3):
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, prompts_d, cache)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits, -1)[:, None]
    dec = []
    for _ in range(8):
        t0 = time.perf_counter()
        logits, cache = decode_fn(params, tok, cache)
        tok = torch.argmax(logits.reshape(BATCH, -1), -1)[:, None]
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
    prefill_ms, decode_ms = statistics.median(pre), statistics.median(dec)
    print(f"  prefill {prefill_ms:.1f} ms median of {[round(x, 1) for x in pre]}"
          f" ({BATCH}x{PROMPT} tokens), decode {decode_ms:.1f} ms per step "
          f"median of {[round(x, 1) for x in dec]} ({BATCH} tokens)")
    print(json.dumps({"serve": dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=BATCH, prompt=PROMPT,
        new_tokens=NEW_TOKENS, generate_s=wall,
        new_tokens_per_s=tokens.size / wall, prefill_ms=prefill_ms,
        decode_ms_per_step=decode_ms, peak_gib=peak, launches=launches)}))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,kernels,serve_check,serve")
    ap.add_argument("--layers", type=int, default=qwen2_7b.CONFIG.n_layers,
                    help="serve depth (the width is always full)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = None
    rows, launches = {}, {}
    t_start = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        print(f"== {phase}", flush=True)
        if phase == "env":
            smi = phase_env()
        elif phase == "kernels":
            rows = phase_kernels()
        elif phase == "serve_check":
            phase_serve_check()
        elif phase == "serve":
            launches = phase_serve(args.layers)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        torch.cuda.empty_cache()
        print(f"== {phase} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if smi is not None:
        print(smi)
    entries = []
    for name, meta in KERNELS.items():
        r = rows.get(name)
        head = None
        if r is not None:
            head = next(d for d in r["detail"] if d["shape"] == r["headline"])
        entries.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches.get(name),
            "max_abs_err": r["max_abs_err"] if r else None,
            "ms": head["ms"] if head else None,
            "plain_ms": head["plain_ms"] if head else None,
            "bound_ms": head["bound_ms"] if head else None,
            "bound_by": head["bound_by"] if head else None,
            "library_ms": head["library_ms"] if head else None,
            "shape": r["headline"] if r else None,
            "shapes": r["detail"] if r else None,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
