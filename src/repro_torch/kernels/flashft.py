"""ABFT flash attention, both directions, and the paged decode — wrappers
of the CUDA kernels `csrc/flash_fwd_sm90.cu` and `csrc/flash_ft.cu`
(forward on the tensor cores and on the CUDA cores), `csrc/flash_bwd_sm90.cu`
(dQ, dK/dV on the tensor cores), `csrc/flash_ft_bwd.cu` (dQ, dK/dV on the
CUDA cores), `csrc/flash_decode_sm90.cu` and `csrc/flash_decode.cu` (paged
decode on the tensor cores, split over the pages, and on the CUDA cores),
and their plain PyTorch versions.

Replaces the TPU kernels of the JAX package
`repro/kernels/flashft.py`:
  * K2 `_flash_ft_kernel` (launch `templates/registry.py:flash_fwd_call`),
    with ``save_stats``: the per-row softmax statistics (m, l);
  * K3 `_flash_dq_kernel` (launch `registry.py:flash_dq_call`);
  * K4 `_flash_dkv_kernel` (launch `registry.py:flash_dkv_call`);
  * K6 `_flash_decode_kernel` (`flashft.py:270`; launch
    `templates/registry.py:239 flash_decode_call`).

Written plans decide which instance runs a call. `plan_fwd` and
`plan_bwd`: bf16 operands that TMA can read (contiguous, 16-byte aligned)
with the default blocks run on the tensor cores, the forward at head dim
64 or 128 (`SM90_HEAD_DIMS`), the backward at 128 with K4's walk cut into
`dkv_ranges` ranges; every other call (f32, the backward at head dim 64,
pinned blocks) on the SIMT kernels. `plan_decode`: bf16 q of 16 rows per kv head
and pools at head dim 128 in pages of 32 or 64 run on the tensor cores,
each (slot, kv head) row's live pages cut into `decode_ranges` ranges that
a combine kernel merges; every other call on the SIMT decode kernel.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel (launch or raise), and counts its launches (`FLASH_FT_SM90`,
`FLASH_DQ_SM90`, `FLASH_DKV_SM90`, `FLASH_DKV_REDUCE`, `FLASH_DECODE_SM90`,
`FLASH_DECODE_COMBINE`, the SIMT `FLASH_FT`, `FLASH_DQ`, `FLASH_DKV` and
`FLASH_DECODE`). The plain versions walk the kernels' block grids — a
Python loop over the reduction steps, vectorised over the stationary
blocks — and write the same 8-field reports: the forward verifies S = QKᵀ
and Δ = PV per kv step; the dQ walk verifies the recomputed S, dP = g·Vᵀ
and the dQ delta dS·K per kv step; the dK/dV walk (n_rep query heads × q
blocks per kv block, in ``ranges`` ranges) verifies S, dP, dV = Pᵀg and
dK = dSᵀQ; the decode walk (each row's pages in ``ranges`` ranges)
verifies S and Δ per page of the slot.

The forward's and the decode's injection vectors keep the reference's
layout; their first field selects the product: 1 lands the SEU in Δ = PV
(the reference's), 2 in S = QKᵀ before its verification (the tensor-core
instances and the plain versions; the SIMT kernels raise on it).

Stochastic SEU campaigns: every wrapper and plain version takes ``rng``, a
campaign's triple (`encode_rng`). Each stationary output block draws one
Bernoulli(rate) SEU over its live steps (`templates/seu.py`, the kernel's
salt `seu.SALT_FWD` / `SALT_DQ` / `SALT_DKV` / `SALT_DECODE`), and the
hit lands in that step's Δ before its verification: K2's and K6's PV, K3's
dS·K, K4's Pᵀ·g (the reference's `flashft.py:159-161`, `:519-521`,
`:609-616`, `:310-315`). `seu_fwd_draws`, `seu_dq_draws`, `seu_dkv_draws`
and `seu_decode_draws` enumerate a launch's draws. Under K4's and K6's
ranges every range's CTA draws its block's SEU, and only the range holding
the drawn step lands it. Every kernel runs campaigns in its own template
instances; a clean call runs the clean ones.

What bounds the kernels on the H100 and what their design does about it is
in the headers of the CUDA sources.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.abft import F32EPS
from ..core.policy import FTConfig, InjectionSpec
from . import build
from .ft_gemm import (DTYPE_CODES, REPORT_WIDTH, SEU_ARGTYPES, SPLIT_TARGET,
                      cdiv, locate_record, merge_reports, seu_args,
                      seu_armed)
from .templates import seu

NEG_INF = -1e30

#: Whether the flash kernels (K2, K3, K4, K6) honour a campaign key in
#: kernel (the reference's switch, `repro/kernels/flashft.py:81-85`): every
#: instance carries the stochastic hook, so a campaign runs at the flash
#: fronts; a build without it must set this False so that
#: `core.fault_injection.check_campaign` raises instead.
SUPPORTS_STOCHASTIC_INJECTION = True
#: The kernel's compiled (bq, bkv) blocks and head dims.
BLOCK = 64
HEAD_DIMS = (64, 128)

#: Deterministic backward-injection targets (`encode_bwd_injection`):
#: which backward GEMM the SEU lands in. "dp_q" / "dp_kv" hit dP = g·Vᵀ
#: inside the dQ / dK-dV kernel.
BWD_TARGETS = {"dp_q": 0, "dq": 1, "dp_kv": 0, "dv": 2, "dk": 3}
DQ_TARGETS = ("dp_q", "dq")
DKV_TARGETS = ("dp_kv", "dv", "dk")

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
FLASH_FT = build.Kernel("flash_ft", "flash_ft_launch", _ARGTYPES)
#: K2 on the tensor cores (the SIMT entry's arguments).
FLASH_FT_SM90 = build.Kernel("flash_fwd_sm90", "flash_ft_sm90_launch",
                             _ARGTYPES)
_BWD_TAIL = ([ctypes.c_int] * 8 + [ctypes.c_float] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
FLASH_DQ = build.Kernel("flash_ft_bwd", "flash_dq_launch",
                        [ctypes.c_void_p] * 9 + _BWD_TAIL)
FLASH_DKV = build.Kernel("flash_ft_bwd", "flash_dkv_launch",
                         [ctypes.c_void_p] * 10 + _BWD_TAIL)
#: K3 and K4 on the tensor cores (same arguments as the SIMT entries; K4
#: with its range workspace and count), and K4's range reduce.
FLASH_DQ_SM90 = build.Kernel("flash_bwd_sm90", "flash_dq_sm90_launch",
                             [ctypes.c_void_p] * 9 + _BWD_TAIL)
FLASH_DKV_SM90 = build.Kernel("flash_bwd_sm90", "flash_dkv_sm90_launch",
                              [ctypes.c_void_p] * 11 + [ctypes.c_int]
                              + _BWD_TAIL)
FLASH_DKV_REDUCE = build.Kernel(
    "flash_bwd_sm90", "flash_dkv_sm90_reduce_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: The head dim of the tensor-core backward and decode instances, and
#: those of the tensor-core forward.
SM90_HEAD_DIM = 128
SM90_HEAD_DIMS = (64, 128)

#: K6's compiled page edges and head dims, and its most query rows per
#: (slot, kv head) block.
DECODE_PAGES = (16, 32, 64)
DECODE_HEAD_DIMS = (128, 256)
DECODE_MAX_BQ = 32
_DECODE_TAIL = ([ctypes.c_int] * 9 + [ctypes.c_float] * 3
                + [ctypes.c_int] * 6 + [ctypes.c_float] + SEU_ARGTYPES
                + [ctypes.c_void_p])
FLASH_DECODE = build.Kernel("flash_decode", "flash_decode_launch",
                            [ctypes.c_void_p] * 7 + _DECODE_TAIL)
#: K6 on the tensor cores: the SIMT entry's arguments with the range
#: workspace in place of out and report, and the range count; then the
#: combine of the ranges into out and report.
FLASH_DECODE_SM90 = build.Kernel(
    "flash_decode_sm90", "flash_decode_sm90_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + _DECODE_TAIL)
FLASH_DECODE_COMBINE = build.Kernel(
    "flash_decode_sm90", "flash_decode_combine_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
#: The tensor-core decode's query rows per kv head and pages.
SM90_DECODE_BQ = 16
SM90_DECODE_PAGES = (32, 64)
#: f32 of one range's partial in the decode workspace: acc (16 x 128), m,
#: l (16 each) and the report.
DECODE_PARTIAL = SM90_DECODE_BQ * SM90_HEAD_DIM + 2 * SM90_DECODE_BQ + REPORT_WIDTH
#: The injection vector's first field: the product the SEU lands in.
INJ_DELTA, INJ_S = 1, 2


def encode_rng(key: Optional[torch.Generator], ft: FTConfig
               ) -> Tuple[int, int, int]:
    """The in-kernel hook's triple (enable, seed0, seed1) of int32 for a
    campaign key (the reference's `encode_rng`): zeros without a key or at
    rate 0, else enable 1 and two non-negative seeds mixed by splitmix64
    from ``key.initial_seed()`` (the key's state is not touched). A rate or
    bit shift the hook cannot draw raises (`templates.seu.check`)."""
    from ..core.fault_injection import splitmix64
    from .templates import seu
    seu.check(ft.inject_rate, ft.inject_bit_shift)
    if key is None or ft.inject_rate <= 0.0:
        return (0, 0, 0)
    s = splitmix64(key.initial_seed() & 0xFFFFFFFFFFFFFFFF)
    return (1, (s & 0xFFFFFFFF) % 0x7FFFFFFF, (s >> 32) % 0x7FFFFFFF)


def sublane(dtype: torch.dtype) -> int:
    """Rows of the reference's (sublane, lane) tiling for ``dtype``
    (`repro/kernels/search.py:sublane`): 16 for 2-byte types, 32 for
    1-byte ones, 8 otherwise."""
    return {1: 32, 2: 16}.get(dtype.itemsize, 8)


def _live_kv_steps(sq: int, skv: int, nqb: int, *, causal: bool, bq: int,
                   bkv: int, device="cpu") -> torch.Tensor:
    """The kv steps each of the ``nqb`` q blocks runs (the reference's
    `_live_kv_steps`): the kv edge and, causal, the bottom-right-aligned
    bound. int64 (nqb,)."""
    q_start = torch.arange(nqb, device=device) * bq
    kv_hi = torch.full_like(q_start, skv)
    if causal:
        kv_hi = torch.minimum(kv_hi, q_start + bq + (skv - sq))
    return torch.clamp_min((kv_hi + bkv - 1) // bkv, 0)


def seu_fwd_draws(rng: Optional[Sequence[int]], ft: Optional[FTConfig],
                  bh: int, sq: int, skv: int, dh: int, *, causal: bool = True,
                  bq: int = BLOCK, bkv: int = BLOCK, salt: int = seu.SALT_FWD,
                  device="cpu"):
    """The SEU every (query head, q block) of a K2 launch draws under the
    campaign triple ``rng``: (hit, step, row, col), each (bh, nqb), step a
    live kv step, (row, col) in the block's (bq, dh) Δ = PV; uid h·nqb +
    qi. None when no campaign is armed (no triple, enable 0, rate 0, FT
    off)."""
    if not seu_armed(rng, ft):
        return None
    nqb = cdiv(sq, bq)
    uid = (torch.arange(bh, device=device)[:, None] * nqb
           + torch.arange(nqb, device=device)[None, :])
    n_live = _live_kv_steps(sq, skv, nqb, causal=causal, bq=bq, bkv=bkv,
                            device=device)
    return seu.draw(rng, salt, uid, n_live.expand(bh, nqb), bq, dh,
                    ft.inject_rate)


def seu_dq_draws(rng, ft, bh: int, sq: int, skv: int, dh: int, *,
                 causal: bool = True, bq: int = BLOCK, bkv: int = BLOCK,
                 device="cpu"):
    """K3's draws: `seu_fwd_draws` on K3's salt; (row, col) in the block's
    dQ delta dS·K."""
    return seu_fwd_draws(rng, ft, bh, sq, skv, dh, causal=causal, bq=bq,
                         bkv=bkv, salt=seu.SALT_DQ, device=device)


def seu_dkv_draws(rng, ft, gk: int, n_rep: int, sq: int, skv: int, dh: int,
                  *, causal: bool = True, bq: int = BLOCK, bkv: int = BLOCK,
                  device="cpu"):
    """The SEU every (kv head, kv block) of a K4 launch draws: (hit, step,
    row, col), each (gk, nkvb), step a position of the block's walk of
    n_rep × live q blocks (`dkv_walk`, query head first), (row, col) in the
    block's (bkv, dh) dV delta Pᵀ·g; uid b·nkvb + kvi. None when no
    campaign is armed."""
    if not seu_armed(rng, ft):
        return None
    nkvb = cdiv(skv, bkv)
    kv_start = torch.arange(nkvb, device=device) * bkv
    _, span = dkv_walk(sq, skv, kv_start, causal=causal, bq=bq)
    uid = (torch.arange(gk, device=device)[:, None] * nkvb
           + torch.arange(nkvb, device=device)[None, :])
    return seu.draw(rng, seu.SALT_DKV, uid, (n_rep * span).expand(gk, nkvb),
                    bkv, dh, ft.inject_rate)


def seu_decode_draws(rng, ft, lengths: torch.Tensor, kvh: int, page: int,
                     max_pages: int, bq: int, dh: int):
    """The SEU every (slot, kv head) row of a K6 launch draws: (hit, step,
    row, col), each (B·KVH,), step one of the row's live pages
    (ceil(length / page), at most the table's width), (row, col) in its
    (bq, dh) Δ = PV; uid slot·KVH + head. None when no campaign is
    armed."""
    if not seu_armed(rng, ft):
        return None
    lens = lengths.long().repeat_interleave(kvh)
    n_live = torch.clamp((lens + page - 1) // page, 0, max_pages)
    uid = torch.arange(lens.shape[0], device=lens.device)
    return seu.draw(rng, seu.SALT_DECODE, uid, n_live, bq, dh,
                    ft.inject_rate)


def encode_bwd_injection(spec: Optional[InjectionSpec], target: str = "dq",
                         bh: int = 0, blk: int = 0
                         ) -> Tuple[Tuple[int, ...], Tuple[int, ...], float]:
    """Deterministic SEU vectors of the backward kernels, int32[7] =
    [enable, target, bh, blk, step, row, col]. ``target`` names the GEMM:
    "dp_q" / "dq" (dQ kernel: ``blk`` the q block, ``spec.k_step`` the kv
    step) or "dp_kv" / "dv" / "dk" (dK/dV kernel: ``blk`` the kv block,
    ``spec.k_step`` the q block); ``bh`` is always the query head. Returns
    (inj_dq, inj_dkv, mag) with only the targeted kernel's vector on."""
    zero = (0,) * 7
    if spec is None:
        return zero, zero, 0.0
    if target not in BWD_TARGETS:
        raise ValueError(f"unknown backward injection target {target!r}; "
                         f"one of {tuple(BWD_TARGETS)}")
    vec = (1, BWD_TARGETS[target], bh, blk, spec.k_step, spec.row, spec.col)
    if target in DQ_TARGETS:
        return vec, zero, float(spec.magnitude)
    return zero, vec, float(spec.magnitude)


def flash_ft_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   ft: FTConfig, scale: float, tau_dh: int,
                   n_rep: int = 1, causal: bool = True,
                   bq: int = BLOCK, bkv: int = BLOCK,
                   inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                   save_stats: bool = False,
                   rng: Optional[Sequence[int]] = None):
    """The kernel's function in plain PyTorch, on the kernel's block grid.

    q (BH, Sq, dh); k, v (BH / n_rep, Skv, dh). ``tau_dh`` is the head dim
    in the QK threshold (the reference's 128-padded width); ``scale``
    multiplies the verified scores. ``inj`` is the kernel's injection
    vector [enable, bh, q_block, kv_step, row, col]: with enable = 1,
    ``inj_mag`` is added to the PV delta of that head and q block at that
    kv step, element (row, col) of the block; with enable = 2 to S = QKᵀ
    before its verification (col < bkv). ``rng``, a campaign's triple,
    lands each block's drawn SEU (`seu_fwd_draws`) in Δ after ``inj``.
    Returns (out (BH, Sq, dh) in q's dtype, report (BH, nqb, 8)), or with
    ``save_stats`` (out, m, l, report): m, l (BH, Sq) f32, degenerate rows
    (NEG_INF, 0)."""
    bh, sq, dh = q.shape
    g, skv, _ = k.shape
    r = n_rep
    nqb, nkv = cdiv(sq, bq), cdiv(skv, bkv)
    dev = q.device
    qf = F.pad(q.float(), (0, 0, 0, nqb * bq - sq)).view(g, r, nqb, bq, dh)
    kf = F.pad(k.float(), (0, 0, 0, nkv * bkv - skv))
    vf = F.pad(v.float(), (0, 0, 0, nkv * bkv - skv))
    acc = torch.zeros(g, r, nqb, bq, dh, device=dev)
    m = torch.full((g, r, nqb, bq), NEG_INF, device=dev)
    l = torch.zeros(g, r, nqb, bq, device=dev)
    rep = torch.zeros(g, r, nqb, REPORT_WIDTH, device=dev)
    qsum = qf.sum(-2)                                    # (g, r, nqb, dh)
    qmax = qf.abs().amax((-2, -1))                       # (g, r, nqb)
    q_start = (torch.arange(nqb, device=dev) * bq)[None, None, :]
    qpos = (torch.arange(nqb, device=dev)[:, None] * bq
            + torch.arange(bq, device=dev)[None, :])     # (nqb, bq)
    c_off = skv - sq
    coef_qk = torch.tensor(ft.rel_tau * F32EPS * tau_dh, device=dev)
    coef = torch.tensor(ft.rel_tau * F32EPS, device=dev)
    gi = torch.arange(g, device=dev)[:, None, None]
    ri = torch.arange(r, device=dev)[None, :, None]
    qi = torch.arange(nqb, device=dev)[None, None, :]
    hook = seu_fwd_draws(rng, ft, bh, sq, skv, dh, causal=causal, bq=bq,
                         bkv=bkv, device=dev)
    if hook is not None:
        hook = [x.view(g, r, nqb) for x in hook]

    for s in range(nkv):
        kv_start = s * bkv
        run = torch.full((nqb,), kv_start < skv, device=dev)
        if causal:
            run &= kv_start <= q_start[0, 0] + bq - 1 + c_off
        if not bool(run.any()):
            continue
        live = run[None, None, :]
        kt = kf[:, None, None, kv_start:kv_start + bkv]  # (g, 1, 1, bkv, dh)
        vt = vf[:, None, None, kv_start:kv_start + bkv]
        scores = torch.matmul(qf, kt.transpose(-1, -2))  # (g, r, nqb, bq, bkv)
        if inj is not None and inj[0] == INJ_S and s == inj[3]:
            _, ih, iq, _, ir, ic = inj
            if 0 <= ir < bq and 0 <= ic < bkv:
                scores[ih // r, ih % r, iq, ir, ic] += inj_mag
        ck_col = torch.matmul(qsum[..., None, :], kt.transpose(-1, -2))
        ck_row = torch.matmul(qf, kt.sum(-2)[..., None])
        d_col = scores.sum(-2) - ck_col[..., 0, :]
        d_row = scores.sum(-1) - ck_row[..., 0]
        kmax = kt.abs().amax((-2, -1))                   # (g, 1, 1)
        tau_qk = torch.clamp_min(coef_qk * qmax * kmax, 1e-30)
        _, row, col, mag = locate_record(
            d_col, d_row, tau_qk, torch.tensor(s + 1.0, device=dev),
            ft.corrects, rep, q_start, kv_start, live=live)
        if ft.corrects:
            scores.index_put_((gi, ri, qi, row, col), -mag, accumulate=True)
        scores = scores * scale
        kpos = kv_start + torch.arange(bkv, device=dev)
        valid = (kpos[None, None, :] < skv) & (qpos[:, :, None] < sq)
        if causal:
            valid &= qpos[:, :, None] + c_off >= kpos[None, None, :]
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1))
        good = m_new > 0.5 * NEG_INF
        p = torch.exp(torch.clamp_max(scores - m_new[..., None], 0.0))
        p = torch.where(good[..., None], p, torch.zeros_like(p))
        alpha = torch.exp(torch.clamp_max(m - m_new, 0.0))
        delta = torch.matmul(p, vt)                      # (g, r, nqb, bq, dh)
        if inj is not None and inj[0] == INJ_DELTA and s == inj[3]:
            _, ih, iq, _, ir, ic = inj
            if 0 <= ir < bq and 0 <= ic < dh:
                delta[ih // r, ih % r, iq, ir, ic] += inj_mag
        if hook is not None:
            seu.land(delta, hook[0] & (hook[1] == s), hook[2], hook[3],
                     ft.inject_bit_shift)
        ck_col = torch.matmul(p.sum(-2)[..., None, :], vt)
        ck_row = torch.matmul(p, vt.sum(-1)[..., None])
        d_col = delta.sum(-2) - ck_col[..., 0, :]
        d_row = delta.sum(-1) - ck_row[..., 0]
        eff_kv = float(min(skv - kv_start, bkv))
        tau = torch.clamp_min(coef * eff_kv * vt.abs().amax((-2, -1)), 1e-30)
        _, row, col, mag = locate_record(
            d_col, d_row, tau.expand(g, r, nqb),
            torch.tensor(eff_kv, device=dev), ft.corrects, rep, q_start, 0,
            live=live)
        if ft.corrects:
            delta.index_put_((gi, ri, qi, row, col), -mag, accumulate=True)
        upd = live[..., None]
        acc = torch.where(upd[..., None], acc * alpha[..., None] + delta, acc)
        l = torch.where(upd, l * alpha + p.sum(-1), l)
        m = torch.where(upd, m_new, m)

    good = (m > 0.5 * NEG_INF) & (l > 0.0)
    linv = torch.where(good, 1.0 / torch.clamp_min(l, 1e-30),
                       torch.zeros_like(l))
    out = (acc * linv[..., None]).reshape(bh, nqb * bq, dh)[:, :sq]
    rep = rep.reshape(bh, nqb, REPORT_WIDTH)
    if not save_stats:
        return out.to(q.dtype), rep
    m_out = torch.where(good, m, torch.full_like(m, NEG_INF))
    l_out = torch.where(good, l, torch.zeros_like(l))
    return (out.to(q.dtype), m_out.reshape(bh, -1)[:, :sq].contiguous(),
            l_out.reshape(bh, -1)[:, :sq].contiguous(), rep)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How one flash-forward call runs. ``instance``: "sm90"
    (csrc/flash_fwd_sm90.cu, the tensor cores) or "simt"
    (csrc/flash_ft.cu); ``reason``: why the tensor-core instance does not
    take the call ("" when it does)."""
    instance: str
    reason: str = ""


def _sm90_reason(xs: Sequence[torch.Tensor], bq, bkv,
                 head_dims: Sequence[int] = (SM90_HEAD_DIM,)) -> str:
    """Why the flash tensor-core instances do not take operands ``xs``
    (q first) at blocks (bq, bkv), "" when they do: bf16 at a head dim of
    ``head_dims``, the default blocks (None), contiguous operands with
    16-byte aligned bases (what TMA reads)."""
    q = xs[0]
    if bq is not None or bkv is not None:
        return f"pinned blocks ({bq}, {bkv})"
    if q.dtype != torch.bfloat16:
        return f"dtype {q.dtype}"
    if q.shape[-1] not in head_dims:
        return f"head dim {q.shape[-1]}"
    if not all(x.is_contiguous() for x in xs):
        return "a non-contiguous operand"
    if not all(x.data_ptr() % 16 == 0 for x in xs):
        return "a base pointer not 16-byte aligned"
    return ""


def plan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             bq: Optional[int] = None, bkv: Optional[int] = None) -> FwdPlan:
    """The instance of a forward call on q (BH, Sq, dh), k, v (BH / n_rep,
    Skv, dh): the tensor-core instance for bf16 at a head dim of
    `SM90_HEAD_DIMS` with the default blocks and operands TMA can read
    (campaigns too: both head dims compile the hook); every other call
    (f32, pinned ``bq`` / ``bkv``, another head dim) goes to the SIMT
    kernel, which raises on what it does not take either. The rule does
    not depend on the device; it never falls back after a failure."""
    why = _sm90_reason((q, k, v), bq, bkv, SM90_HEAD_DIMS)
    return FwdPlan("simt", why) if why else FwdPlan("sm90")


def flash_ft_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 ft: FTConfig, scale: float, tau_dh: int, n_rep: int = 1,
                 causal: bool = True,
                 inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                 bq: Optional[int] = None,
                 bkv: Optional[int] = None, save_stats: bool = False,
                 rng: Optional[Sequence[int]] = None):
    """ABFT flash attention forward: a CPU tensor runs `flash_ft_plain`
    (blocks default to the kernel's 64), a CUDA tensor launches the kernel
    `plan_fwd` picks (tensor cores or SIMT) or raises. ``rng`` arms the
    stochastic hook (`seu_fwd_draws`). Returns what `flash_ft_plain`
    returns."""
    if q.device.type == "cpu":
        return flash_ft_plain(q, k, v, ft=ft, scale=scale, tau_dh=tau_dh,
                              n_rep=n_rep, causal=causal, bq=bq or BLOCK,
                              bkv=bkv or BLOCK, inj=inj, inj_mag=inj_mag,
                              save_stats=save_stats, rng=rng)
    _check_launch("flash_ft_fwd", q, k, v, n_rep=n_rep, bq=bq or BLOCK,
                  bkv=bkv or BLOCK)
    p = plan_fwd(q, k, v, bq=bq, bkv=bkv)
    inj = tuple(inj) if inj is not None else (0, 0, 0, 0, 0, 0)
    if p.instance == "simt" and inj[0] == INJ_S:
        raise ValueError("flash_ft_fwd: the SIMT kernel lands an SEU in the "
                         "PV delta only (enable 1)")
    bh, sq, dh = q.shape
    skv = k.shape[1]
    nqb = cdiv(sq, BLOCK)
    out = torch.empty_like(q)
    rep = torch.empty((bh, nqb, REPORT_WIDTH), dtype=torch.float32,
                      device=q.device)
    m = l = None
    if save_stats:
        m, l = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
                for _ in range(2))
    kernel = FLASH_FT_SM90 if p.instance == "sm90" else FLASH_FT
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           rep.data_ptr(), None if m is None else m.data_ptr(),
           None if l is None else l.data_ptr(), bh, sq, skv, dh, n_rep,
           DTYPE_CODES[q.dtype], int(causal), int(ft.corrects), scale,
           ft.rel_tau * F32EPS * tau_dh, ft.rel_tau * F32EPS,
           *inj, inj_mag, *seu_args(rng, ft, seu.SALT_FWD),
           torch.cuda.current_stream(q.device).cuda_stream)
    return (out, m, l, rep) if save_stats else (out, rep)


def _check_launch(name: str, q, k, v, *rest, n_rep: int, bq: int,
                  bkv: int) -> None:
    """What the flash kernels take: cuda:0, f32 or bf16 q/k/v (and the
    backward's g) of one dtype, contiguous, head dim 64 or 128, the
    compiled 64 x 64 blocks, BH = KVH x n_rep; f32 contiguous statistics
    (the backward's m, l, di of shape (BH, Sq))."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    build.check_device(q)
    bh, sq, dh = q.shape
    g, skv, dh_k = k.shape
    if (bq, bkv) != (BLOCK, BLOCK):
        raise ValueError(f"{name}: the kernel is compiled for "
                         f"bq = bkv = {BLOCK}, got ({bq}, {bkv})")
    if dh not in HEAD_DIMS or dh_k != dh or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: head dim must be one of "
                         f"{HEAD_DIMS} and match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bh != g * n_rep:
        raise ValueError(f"{name}: {bh} query heads are not "
                         f"{g} kv heads x n_rep {n_rep}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    grads, stats = rest[:1], rest[1:]
    for x in (q, k, v, *grads):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v, g must share device and "
                             f"dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for x in grads:
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name}: g {tuple(x.shape)} is not q's shape")
    for x in stats:
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (bh, sq) or not x.is_contiguous()):
            raise ValueError(f"{name}: m, l, di must be contiguous f32 "
                             f"({bh}, {sq}) tensors on {q.device}")



# ---------------------------------------------------------------------------
# backward: the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one flash-backward call runs. ``instance``: "sm90"
    (csrc/flash_bwd_sm90.cu, the tensor cores) or "simt"
    (csrc/flash_ft_bwd.cu); ``ranges``: the ranges K4 cuts each (kv head,
    kv block) walk into (1 on the SIMT kernel); ``reason``: why the
    tensor-core instance does not take the call ("" when it does)."""
    instance: str
    ranges: int = 1
    reason: str = ""


def dkv_ranges(kv_blocks: int, walk: int) -> int:
    """K4's range count for ``kv_blocks`` (kv head, kv block) pairs whose
    longest walk has ``walk`` steps: 1 when they reach `SPLIT_TARGET` CTAs
    (about two waves of the H100's 132 SMs, as `ft_gemm.split_count`
    aims for), else the count that brings the grid there, at most the
    longest walk."""
    if kv_blocks >= SPLIT_TARGET:
        return 1
    return max(1, min(cdiv(SPLIT_TARGET, kv_blocks), walk))


def plan_bwd(q: torch.Tensor, k: torch.Tensor, *operands: torch.Tensor,
             n_rep: int = 1, causal: bool = True, bq: Optional[int] = None,
             bkv: Optional[int] = None) -> BwdPlan:
    """The instance of a backward call on q (BH, Sq, dh), k (BH / n_rep,
    Skv, dh) and the other ``operands`` (v, g). The tensor-core instance
    takes bf16 at head dim `SM90_HEAD_DIM` with the default blocks (None)
    and operands TMA can read (contiguous, 16-byte aligned bases), with
    `dkv_ranges` ranges for K4; every other call goes to the SIMT kernels
    (pinned ``bq`` / ``bkv`` pin them), which raise on what they do not
    take either. The rule does not depend on the device; it never falls
    back after a failure."""
    why = _sm90_reason((q, k, *operands), bq, bkv)
    if why:
        return BwdPlan("simt", 1, why)
    nqb, nkvb = cdiv(q.shape[1], BLOCK), cdiv(k.shape[1], BLOCK)
    return BwdPlan("sm90", dkv_ranges(k.shape[0] * nkvb, n_rep * nqb))


def dkv_walk(sq: int, skv: int, kv_start, *, causal: bool,
             bq: int = BLOCK):
    """K4's live q blocks at a kv block starting at ``kv_start`` (an int or
    a tensor): [qi_lo, nqb), all of them unless causal (the bottom-right-
    aligned bound). Returns (qi_lo, the count of live q blocks); the walk
    runs them for each of the n_rep query heads, query head first."""
    nqb = cdiv(sq, bq)
    if not causal:
        return kv_start * 0, kv_start * 0 + nqb
    x = kv_start - (bq - 1) - (skv - sq)
    lo = (x + bq - 1) // bq
    if isinstance(lo, torch.Tensor):
        lo = lo.clamp(0, nqb)
    else:
        lo = min(max(lo, 0), nqb)
    return lo, nqb - lo


def dkv_range_of(step, walk, ranges: int):
    """The range holding walk step ``step`` of a walk of ``walk`` steps cut
    into ``ranges`` contiguous, balanced ranges (range z runs steps
    [z·walk // ranges, (z + 1)·walk // ranges)): K4's walk, and K6's live
    pages of a row."""
    return ((step + 1) * ranges + walk - 1) // walk - 1


def merge_ranges(reps: Sequence[torch.Tensor]) -> torch.Tensor:
    """K4's range rule, the reports (…, 8) of the ranges of one walk merged
    in walk order: det and corr add, row / col / mag from the last
    detection, max_residual the max (`ft_gemm.merge_reports`), and tau and
    k from the last range that ran a verification (k ≥ 1 in every record
    that did): a walk has no final verification to take them from. At one
    range, or over ranges of the unsplit walk, the merged report is the
    walk's."""
    out = merge_reports(reps)
    for r in reps:
        out[..., 6:8] = torch.where(r[..., 7:8] > 0, r[..., 6:8],
                                    out[..., 6:8])
    return out


# ---------------------------------------------------------------------------
# backward: dQ (K3) and dK/dV (K4), plain versions
# ---------------------------------------------------------------------------

def _vm(x, mat):
    """Row vector(s) x (…, R) times mat (…, R, C) → (…, C)."""
    return torch.matmul(x[..., None, :], mat)[..., 0, :]


def _mv(mat, x):
    """mat (…, R, C) times column vector(s) x (…, C) → (…, R)."""
    return torch.matmul(mat, x[..., None])[..., 0]


def _check(c, d_col, d_row, tau, k_el, corrects, rep, row_off, col_off,
           live, zsel=None):
    """Locate, record and (with ``corrects``) correct one verified
    (…, R, C) product from its column / row residuals. With ``zsel`` (the
    range of each stationary block's step, K4's ranged walk) ``rep`` holds
    one report per range, (Z, …, 8), and each block records into its
    range's."""
    if zsel is None:
        rep, zsel = rep[None], torch.zeros((), dtype=torch.long,
                                           device=c.device)
    mag = torch.zeros_like(d_col[..., 0])
    for z in range(rep.shape[0]):
        _, row, col, m = locate_record(d_col, d_row, tau, k_el, corrects,
                                       rep[z], row_off, col_off,
                                       live=live & (zsel == z))
        mag = mag + m
    if not corrects:
        return c
    dev = c.device
    hit = ((torch.arange(c.shape[-2], device=dev)[:, None]
            == row[..., None, None])
           & (torch.arange(c.shape[-1], device=dev)[None, :]
              == col[..., None, None]))
    return c - torch.where(hit, mag[..., None, None], torch.zeros_like(c))


def _bwd_inputs(q, g, m, l, di, bq: int):
    """f32 q and g padded to whole q blocks, and the saved statistics with
    the padded rows marked degenerate (m = NEG_INF, l = 0, di = 0), so
    p ≡ 0 there. Returns (q, g, m, 1/l (0 where l = 0), di)."""
    pad = cdiv(q.shape[1], bq) * bq - q.shape[1]
    lf = F.pad(l.float(), (0, pad))
    linv = torch.where(lf > 0.0, 1.0 / torch.clamp_min(lf, 1e-30),
                       torch.zeros_like(lf))
    return (F.pad(q.float(), (0, 0, 0, pad)), F.pad(g.float(), (0, 0, 0, pad)),
            F.pad(m.float(), (0, pad), value=NEG_INF), linv,
            F.pad(di.float(), (0, pad)))


def _probs(scores, m, linv, *, scale, qpos, kpos, sq, skv, causal):
    """P of one step from the verified scores and the saved statistics,
    zero on the kv edge, on dead rows and above the bottom-right-aligned
    causal diagonal. qpos (…, bq) and kpos (…, bkv) broadcast."""
    valid = (kpos[..., None, :] < skv) & (qpos[..., :, None] < sq)
    if causal:
        valid = valid & (qpos[..., :, None] + (skv - sq)
                         >= kpos[..., None, :])
    p = (torch.exp(torch.clamp_max(scores * scale - m[..., None], 0.0))
         * linv[..., None])
    return torch.where(valid, p, torch.zeros_like(p))


def _inject(x, at, inj, mag, bounds):
    """Add the SEU ``mag`` at (row, col) = inj[5:7] of the cell ``at`` of a
    per-step product x (…cells, R, C), if inside (R, C) = ``bounds``."""
    ir, ic = inj[5], inj[6]
    if 0 <= ir < bounds[0] and 0 <= ic < bounds[1]:
        x[at + (ir, ic)] += mag


def flash_dq_plain(q, k, v, g, m, l, di, *, ft: FTConfig, scale: float,
                   tau_dh: int, n_rep: int = 1, causal: bool = True,
                   bq: int = BLOCK, bkv: int = BLOCK,
                   inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                   rng: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch on the kernel's grid: dQ = Σ_kv dS·K with
    dS = P ∘ (g·Vᵀ − di) · scale and P recomputed from the saved (m, l).

    q, g (BH, Sq, dh); k, v (BH / n_rep, Skv, dh); m, l, di (BH, Sq) f32.
    Three verifications per live (q block, kv step) go into the report: S
    (tau over ``tau_dh``, k = 1), dP (tau over ``tau_dh``, k = tau_dh) and
    the dQ delta (tau over eff_kv, k = eff_kv). ``inj`` is
    [enable, target, bh, q_block, kv_step, row, col] (`encode_bwd_injection`);
    ``rng``, a campaign's triple, lands each block's drawn SEU
    (`seu_dq_draws`) in the dQ delta after it. Returns (dq in q's dtype,
    report (BH, nqb, 8))."""
    bh, sq, dh = q.shape
    gk, skv, _ = k.shape
    r = n_rep
    nqb, nkv = cdiv(sq, bq), cdiv(skv, bkv)
    dev = q.device
    qf, gf, mf, linv, dif = _bwd_inputs(q, g, m, l, di, bq)
    qf, gf = qf.view(gk, r, nqb, bq, dh), gf.view(gk, r, nqb, bq, dh)
    mf, linv, dif = (x.view(gk, r, nqb, bq) for x in (mf, linv, dif))
    kf = F.pad(k.float(), (0, 0, 0, nkv * bkv - skv))
    vf = F.pad(v.float(), (0, 0, 0, nkv * bkv - skv))
    acc = torch.zeros_like(qf)
    rep = torch.zeros(gk, r, nqb, REPORT_WIDTH, device=dev)
    qsum, gsum = qf.sum(-2), gf.sum(-2)
    qmax, gmax = qf.abs().amax((-2, -1)), gf.abs().amax((-2, -1))
    q_start = torch.arange(nqb, device=dev) * bq
    qpos = q_start[:, None] + torch.arange(bq, device=dev)[None, :]
    coef_qk = ft.rel_tau * F32EPS * tau_dh
    coef = ft.rel_tau * F32EPS
    k_s, k_dp = (torch.tensor(x, device=dev) for x in (1.0, float(tau_dh)))
    zero = torch.zeros((), device=dev)
    hit_cell = None
    if inj is not None and inj[0] == 1:
        hit_cell = (inj[2] // r, inj[2] % r, inj[3])
    hook = seu_dq_draws(rng, ft, bh, sq, skv, dh, causal=causal, bq=bq,
                        bkv=bkv, device=dev)
    if hook is not None:
        hook = [x.view(gk, r, nqb) for x in hook]
    for s in range(nkv):
        kv_start = s * bkv
        run = q_start < sq
        if causal:
            run = run & (kv_start <= q_start + bq - 1 + (skv - sq))
        if not bool(run.any()):
            continue
        live = run[None, None, :]
        kt = kf[:, None, None, kv_start:kv_start + bkv]  # (gk, 1, 1, bkv, dh)
        vt = vf[:, None, None, kv_start:kv_start + bkv]
        kmax, vmax = kt.abs().amax((-2, -1)), vt.abs().amax((-2, -1))
        target = inj[1] if hit_cell is not None and s == inj[4] else None
        # S = Q·Kᵀ, recomputed and verified before scale and mask
        sc = torch.matmul(qf, kt.transpose(-1, -2))
        sc = _check(sc, sc.sum(-2) - _vm(qsum, kt.transpose(-1, -2)),
                    sc.sum(-1) - _mv(qf, kt.sum(-2)),
                    torch.clamp_min(coef_qk * qmax * kmax, 1e-30), k_s,
                    ft.corrects, rep, q_start, kv_start, live)
        p = _probs(sc, mf, linv, scale=scale, qpos=qpos,
                   kpos=kv_start + torch.arange(bkv, device=dev), sq=sq,
                   skv=skv, causal=causal)
        # dP = g·Vᵀ
        dp = torch.matmul(gf, vt.transpose(-1, -2))
        if target == BWD_TARGETS["dp_q"]:
            _inject(dp, hit_cell, inj, inj_mag, (bq, bkv))
        dp = _check(dp, dp.sum(-2) - _vm(gsum, vt.transpose(-1, -2)),
                    dp.sum(-1) - _mv(gf, vt.sum(-2)),
                    torch.clamp_min(coef_qk * gmax * vmax, 1e-30), k_dp,
                    ft.corrects, rep, q_start, kv_start, live)
        ds = p * (dp - dif[..., None]) * scale
        # the dQ delta dS·K
        delta = torch.matmul(ds, kt)
        if target == BWD_TARGETS["dq"]:
            _inject(delta, hit_cell, inj, inj_mag, (bq, dh))
        if hook is not None:
            seu.land(delta, hook[0] & (hook[1] == s), hook[2], hook[3],
                     ft.inject_bit_shift)
        eff_kv = float(min(skv - kv_start, bkv))
        delta = _check(delta, delta.sum(-2) - _vm(ds.sum(-2), kt),
                       delta.sum(-1) - _mv(ds, kt.sum(-1)),
                       torch.clamp_min(coef * eff_kv * ds.abs().amax((-2, -1))
                                       * kmax, 1e-30),
                       torch.tensor(eff_kv, device=dev), ft.corrects, rep,
                       q_start, zero, live)
        acc = torch.where(live[..., None, None], acc + delta, acc)
    dq = acc.reshape(bh, nqb * bq, dh)[:, :sq]
    return dq.to(q.dtype), rep.reshape(bh, nqb, REPORT_WIDTH)


def flash_dkv_plain(q, k, v, g, m, l, di, *, ft: FTConfig, scale: float,
                    tau_dh: int, n_rep: int = 1, causal: bool = True,
                    bq: int = BLOCK, bkv: int = BLOCK,
                    inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                    ranges: int = 1, rng: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 in plain PyTorch on the kernel's grid: per (kv head, kv block) a
    walk over the n_rep query heads × live q blocks (query head first),
    dV = Σ Pᵀ·g and dK = Σ dSᵀ·Q. Four verifications per live step: S and
    dP as in K3, then the dV and dK deltas (tau over eff_q = max(min(Sq −
    q_start, bq), 1), k = eff_q). ``ranges`` cuts each walk as the
    tensor-core instance does (`dkv_range_of`): each range accumulates its
    own f32 partials and report, the partials are summed in range order
    and the reports merged by `merge_ranges`; one range is the unsplit
    walk. ``inj`` is [enable, target, query head, kv_block, q_block, row,
    col]. ``rng``, a campaign's triple, lands each block's drawn SEU
    (`seu_dkv_draws`) in the dV delta of its walk step, in the range that
    holds the step. Returns (dk, dv) per kv head in k's dtype and the report
    (BH / n_rep, nkvb, 8)."""
    bh, sq, dh = q.shape
    gk, skv, _ = k.shape
    r = n_rep
    nqb, nkvb = cdiv(sq, bq), cdiv(skv, bkv)
    dev = q.device
    qf, gf, mf, linv, dif = _bwd_inputs(q, g, m, l, di, bq)
    qf, gf = qf.view(gk, r, nqb * bq, dh), gf.view(gk, r, nqb * bq, dh)
    mf, linv, dif = (x.view(gk, r, nqb * bq) for x in (mf, linv, dif))
    pad = nkvb * bkv - skv
    kb = F.pad(k.float(), (0, 0, 0, pad)).view(gk, nkvb, bkv, dh)
    vb = F.pad(v.float(), (0, 0, 0, pad)).view(gk, nkvb, bkv, dh)
    kmax, vmax = kb.abs().amax((-2, -1)), vb.abs().amax((-2, -1))
    ksum, vsum = kb.sum(-2), vb.sum(-2)
    dk = torch.zeros((ranges,) + kb.shape, device=dev)
    dv = torch.zeros_like(dk)
    rep = torch.zeros(ranges, gk, nkvb, REPORT_WIDTH, device=dev)
    kv_start = torch.arange(nkvb, device=dev) * bkv
    kpos = kv_start[:, None] + torch.arange(bkv, device=dev)[None, :]
    qi_lo, n_live = dkv_walk(sq, skv, kv_start, causal=causal, bq=bq)
    coef_qk = ft.rel_tau * F32EPS * tau_dh
    coef = ft.rel_tau * F32EPS
    k_s, k_dp = (torch.tensor(x, device=dev) for x in (1.0, float(tau_dh)))
    zero = torch.zeros((), device=dev)
    on = inj is not None and inj[0] == 1
    hook = seu_dkv_draws(rng, ft, gk, r, sq, skv, dh, causal=causal, bq=bq,
                         bkv=bkv, device=dev)
    for rr in range(r):
        for qi in range(nqb):
            q_start = qi * bq
            run = (kv_start < skv) & (qi >= qi_lo)
            if not bool(run.any()):
                continue
            live = run[None, :]
            zsel = dkv_range_of(rr * n_live + qi - qi_lo,
                                (r * n_live).clamp_min(1), ranges)
            upd = (torch.arange(ranges, device=dev)[:, None] == zsel[None, :]
                   ) & run[None, :]
            upd = upd[:, None, :, None, None]
            rows = slice(q_start, q_start + bq)
            qb = qf[:, rr, rows][:, None]                # (gk, 1, bq, dh)
            gb = gf[:, rr, rows][:, None]
            mb, lb, db = (x[:, rr, rows][:, None] for x in (mf, linv, dif))
            qmax, gmax = qb.abs().amax((-2, -1)), gb.abs().amax((-2, -1))
            qpos = q_start + torch.arange(bq, device=dev)
            target, cell = None, None
            if on and inj[2] % r == rr and inj[4] == qi:
                target, cell = inj[1], (inj[2] // r, inj[3])
            chk = dict(corrects=ft.corrects, rep=rep, live=live, zsel=zsel)
            # S = Q·Kᵀ and dP = g·Vᵀ, (gk, nkvb, bq, bkv)
            sc = torch.matmul(qb, kb.transpose(-1, -2))
            sc = _check(sc, sc.sum(-2) - _vm(qb.sum(-2), kb.transpose(-1, -2)),
                        sc.sum(-1) - _mv(qb, ksum),
                        torch.clamp_min(coef_qk * qmax * kmax, 1e-30), k_s,
                        row_off=q_start, col_off=kv_start[None, :], **chk)
            p = _probs(sc, mb, lb, scale=scale, qpos=qpos, kpos=kpos, sq=sq,
                       skv=skv, causal=causal)
            dp = torch.matmul(gb, vb.transpose(-1, -2))
            if target == BWD_TARGETS["dp_kv"]:
                _inject(dp, cell, inj, inj_mag, (bq, bkv))
            dp = _check(dp, dp.sum(-2) - _vm(gb.sum(-2), vb.transpose(-1, -2)),
                        dp.sum(-1) - _mv(gb, vsum),
                        torch.clamp_min(coef_qk * gmax * vmax, 1e-30), k_dp,
                        row_off=q_start, col_off=kv_start[None, :], **chk)
            eff_q = float(max(min(sq - q_start, bq), 1))
            k_q = torch.tensor(eff_q, device=dev)
            # the dV delta Pᵀ·g, (gk, nkvb, bkv, dh)
            pt = p.transpose(-1, -2)
            dvd = torch.matmul(pt, gb)
            if target == BWD_TARGETS["dv"]:
                _inject(dvd, cell, inj, inj_mag, (bkv, dh))
            if hook is not None:
                at = rr * n_live + qi - qi_lo                # (nkvb,)
                seu.land(dvd, hook[0] & (hook[1] == at) & run, hook[2],
                         hook[3], ft.inject_bit_shift)
            dvd = _check(dvd, dvd.sum(-2) - _vm(p.sum(-1), gb),
                         dvd.sum(-1) - _mv(pt, gb.sum(-1)),
                         torch.clamp_min(coef * eff_q * p.abs().amax((-2, -1))
                                         * gmax, 1e-30), k_q,
                         row_off=kv_start[None, :], col_off=zero, **chk)
            dv = torch.where(upd, dv + dvd, dv)
            # the dK delta dSᵀ·Q
            ds = p * (dp - db[..., None]) * scale
            dst = ds.transpose(-1, -2)
            dkd = torch.matmul(dst, qb)
            if target == BWD_TARGETS["dk"]:
                _inject(dkd, cell, inj, inj_mag, (bkv, dh))
            dkd = _check(dkd, dkd.sum(-2) - _vm(ds.sum(-1), qb),
                         dkd.sum(-1) - _mv(dst, qb.sum(-1)),
                         torch.clamp_min(coef * eff_q
                                         * ds.abs().amax((-2, -1)) * qmax,
                                         1e-30), k_q,
                         row_off=kv_start[None, :], col_off=zero, **chk)
            dk = torch.where(upd, dk + dkd, dk)
    dk_sum, dv_sum = dk[0], dv[0]
    for z in range(1, ranges):
        dk_sum, dv_sum = dk_sum + dk[z], dv_sum + dv[z]
    dk = dk_sum.reshape(gk, nkvb * bkv, dh)[:, :skv].to(k.dtype)
    dv = dv_sum.reshape(gk, nkvb * bkv, dh)[:, :skv].to(k.dtype)
    return dk, dv, merge_ranges(list(rep))


def dkv_reduce_plain(ws: torch.Tensor, gk: int, skv: int, ranges: int):
    """K4's range reduce in plain PyTorch, from the workspace a ranged
    tensor-core launch leaves: f32 partials of dK, then of dV, each
    (ranges, gk, nkvb · 64, 128), then the ranges' reports (ranges, gk,
    nkvb, 8). The partials are summed in range order and cast to bf16, the
    reports merged by `merge_ranges`. Returns (dk, dv (gk, skv, 128),
    report (gk, nkvb, 8))."""
    nkvb = cdiv(skv, BLOCK)
    n = ranges * gk * nkvb * BLOCK * SM90_HEAD_DIM
    parts = ws[:2 * n].view(2, ranges, gk, nkvb * BLOCK, SM90_HEAD_DIM)
    out = []
    for part in parts:
        acc = part[0]
        for z in range(1, ranges):
            acc = acc + part[z]
        out.append(acc[:, :skv].to(torch.bfloat16))
    reps = ws[2 * n:].view(ranges, gk, nkvb, REPORT_WIDTH)
    return out[0], out[1], merge_ranges(list(reps))


def planned_dkv_plain(q, k, v, g, m, l, di, *, n_rep: int = 1,
                      causal: bool = True, bq: Optional[int] = None,
                      bkv: Optional[int] = None, **kw):
    """K4's plain version under the plan a call on these operands follows
    (`plan_bwd`: its ranges), at the kernel's blocks unless pinned."""
    p = plan_bwd(q, k, v, g, n_rep=n_rep, causal=causal, bq=bq, bkv=bkv)
    return flash_dkv_plain(q, k, v, g, m, l, di, n_rep=n_rep, causal=causal,
                           bq=bq or BLOCK, bkv=bkv or BLOCK,
                           ranges=p.ranges, **kw)


# ---------------------------------------------------------------------------
# backward wrappers
# ---------------------------------------------------------------------------

def _bwd_launch_args(q, k, g, m, l, di, *, ft, scale, tau_dh, n_rep, causal,
                     inj, inj_mag, rng, salt):
    bh, sq, dh = q.shape
    inj = tuple(inj) if inj is not None else (0,) * 7
    return ((g.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr()),
            (bh, sq, k.shape[1], dh, n_rep, DTYPE_CODES[q.dtype], int(causal),
             int(ft.corrects), scale, ft.rel_tau * F32EPS * tau_dh,
             ft.rel_tau * F32EPS, float(tau_dh), *inj, inj_mag,
             *seu_args(rng, ft, salt),
             torch.cuda.current_stream(q.device).cuda_stream))


def flash_ft_dq(q, k, v, g, m, l, di, *, ft: FTConfig, scale: float,
                tau_dh: int, n_rep: int = 1, causal: bool = True,
                inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                bq: Optional[int] = None, bkv: Optional[int] = None,
                rng: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: a CPU tensor runs `flash_dq_plain`, a CUDA tensor launches the
    dQ kernel `plan_bwd` picks (tensor cores or SIMT) or raises. ``rng``
    arms the stochastic hook (`seu_dq_draws`). Returns (dq, report) as the
    plain version does."""
    kw = dict(ft=ft, scale=scale, tau_dh=tau_dh, n_rep=n_rep, causal=causal,
              inj=inj, inj_mag=inj_mag, rng=rng)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, g, m, l, di, bq=bq or BLOCK,
                              bkv=bkv or BLOCK, **kw)
    _check_launch("flash_ft_dq", q, k, v, g, m, l, di, n_rep=n_rep,
                  bq=bq or BLOCK, bkv=bkv or BLOCK)
    p = plan_bwd(q, k, v, g, n_rep=n_rep, causal=causal, bq=bq, bkv=bkv)
    dq = torch.empty_like(q)
    rep = torch.empty((q.shape[0], cdiv(q.shape[1], BLOCK), REPORT_WIDTH),
                      dtype=torch.float32, device=q.device)
    ptrs, rest = _bwd_launch_args(q, k, g, m, l, di, salt=seu.SALT_DQ, **kw)
    kernel = FLASH_DQ_SM90 if p.instance == "sm90" else FLASH_DQ
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, dq.data_ptr(),
           rep.data_ptr(), *rest)
    return dq, rep


def flash_ft_dkv(q, k, v, g, m, l, di, *, ft: FTConfig, scale: float,
                 tau_dh: int, n_rep: int = 1, causal: bool = True,
                 inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                 bq: Optional[int] = None, bkv: Optional[int] = None,
                 rng: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: a CPU tensor runs `planned_dkv_plain` (the plain version under
    the plan's ranges), a CUDA tensor launches the dK/dV kernel `plan_bwd`
    picks (on the tensor cores, then the range reduce when the walk is
    cut) or raises. ``rng`` arms the stochastic hook (`seu_dkv_draws`).
    Returns (dk, dv, report) as the plain version does."""
    kw = dict(ft=ft, scale=scale, tau_dh=tau_dh, n_rep=n_rep, causal=causal,
              inj=inj, inj_mag=inj_mag, rng=rng)
    if q.device.type == "cpu":
        return planned_dkv_plain(q, k, v, g, m, l, di, bq=bq, bkv=bkv, **kw)
    _check_launch("flash_ft_dkv", q, k, v, g, m, l, di, n_rep=n_rep,
                  bq=bq or BLOCK, bkv=bkv or BLOCK)
    p = plan_bwd(q, k, v, g, n_rep=n_rep, causal=causal, bq=bq, bkv=bkv)
    gk, skv = k.shape[:2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rep = torch.empty((gk, cdiv(skv, BLOCK), REPORT_WIDTH),
                      dtype=torch.float32, device=q.device)
    ptrs, rest = _bwd_launch_args(q, k, g, m, l, di, salt=seu.SALT_DKV, **kw)
    if p.instance == "simt":
        FLASH_DKV(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
                  dk.data_ptr(), dv.data_ptr(), rep.data_ptr(), *rest)
        return dk, dv, rep
    ws = None
    if p.ranges > 1:
        ws = torch.empty(p.ranges * gk * cdiv(skv, BLOCK)
                         * (2 * BLOCK * SM90_HEAD_DIM + REPORT_WIDTH),
                         dtype=torch.float32, device=q.device)
    FLASH_DKV_SM90(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
                   dk.data_ptr(), dv.data_ptr(), rep.data_ptr(),
                   None if ws is None else ws.data_ptr(), p.ranges, *rest)
    if ws is not None:
        FLASH_DKV_REDUCE(ws.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         rep.data_ptr(), gk, skv, p.ranges, rest[-1])
    return dk, dv, rep


# ---------------------------------------------------------------------------
# paged decode (K6)
# ---------------------------------------------------------------------------

def flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, lengths: torch.Tensor,
                       page_table: torch.Tensor, *, ft: FTConfig,
                       scale: float, tau_dh: int,
                       inj: Optional[Sequence[int]] = None,
                       inj_mag: float = 0.0, ranges: int = 1,
                       rng: Optional[Sequence[int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 in plain PyTorch: a walk over the page-table columns, vectorised
    over the (slot, kv head) rows.

    q (G, bq, dh), G = B·KVH: row g holds the query rows of kv head
    g % KVH of slot g // KVH at one decode position, zero-padded to bq (the
    padded rows take part in the PV checksums, as in the reference);
    k_pages, v_pages (P, KVH, page, dh): one layer's pool; lengths (B,)
    and page_table (B, MP) ints. Step s of row g reads page
    ``page_table[g // KVH, s]`` while s·page < length, whole: the dead
    positions of a page (the trash page, a previous owner's tokens) take
    part in S's verification, in max|k| and max|v|, and are masked after
    it. S = QKᵀ is verified before scale and mask (tau over ``tau_dh``, k
    field s + 1, column reported at col + s·page), Δ = PV before the
    rescale (tau over eff_kv = min(length − s·page, page), k field eff_kv).
    ``inj`` = [enable, g, 0, kv_step, row, col] adds ``inj_mag`` to Δ
    (enable 1) or to S (enable 2) of row g at that step, element (row,
    col), if the step runs. ``rng``, a campaign's triple, lands each row's
    drawn SEU (`seu_decode_draws`) in Δ of its page after ``inj``.

    ``ranges`` cuts each row's live pages as the tensor-core instance does
    (`dkv_range_of`'s rule): each range runs its own online softmax (acc, m,
    l) and report from an empty state; the partials are merged by
    `combine_plain`, the reports in range order by `merge_ranges`. One
    range is the unsplit walk. Returns (out (G, bq, dh) in q's dtype, report (G, 1,
    8)); a row of length 0 runs no step and writes zeros and a zero
    report."""
    acc, m, l, rep = _decode_ranges_plain(
        q, k_pages, v_pages, lengths, page_table, ft=ft, scale=scale,
        tau_dh=tau_dh, inj=inj, inj_mag=inj_mag, ranges=ranges, rng=rng)
    out, rep = combine_plain(acc, m, l, rep)
    return out.to(q.dtype), rep


def _decode_ranges_plain(q, k_pages, v_pages, lengths, page_table, *, ft,
                         scale, tau_dh, inj, inj_mag, ranges, rng=None):
    """The ranges of `flash_decode_plain`'s walk, unmerged: f32 acc (Z, G,
    bq, dh), m, l (Z, G, bq) and the reports (Z, G, 8); an empty range
    keeps (0, NEG_INF, 0) and a zero report."""
    g, bq, dh = q.shape
    kvh, page = k_pages.shape[1], k_pages.shape[2]
    dev = q.device
    qf = q.float()
    lens = lengths.to(dev).long().repeat_interleave(kvh)           # (G,)
    table = page_table.to(dev).long().repeat_interleave(kvh, dim=0)
    heads = torch.arange(kvh, device=dev).repeat(page_table.shape[0])
    rows = torch.arange(g, device=dev)
    n_live = torch.clamp((lens + page - 1) // page, 0, table.shape[1])
    acc = torch.zeros(ranges, g, bq, dh, device=dev)
    m = torch.full((ranges, g, bq), NEG_INF, device=dev)
    l = torch.zeros(ranges, g, bq, device=dev)
    rep = torch.zeros(ranges, g, REPORT_WIDTH, device=dev)
    qsum, qmax = qf.sum(1), qf.abs().amax((1, 2))
    coef_qk = ft.rel_tau * F32EPS * tau_dh
    coef = ft.rel_tau * F32EPS
    hit = inj is not None and inj[0] in (INJ_DELTA, INJ_S) and inj[2] == 0
    hook = seu_decode_draws(rng, ft, lengths.to(dev), kvh, page,
                            table.shape[1], bq, dh)
    for s in range(table.shape[1]):
        kv_start = s * page
        run = kv_start < lens
        if not bool(run.any()):
            break
        # (rows past their live pages do not run; their range is unused)
        zsel = dkv_range_of(s, n_live.clamp_min(1), ranges).clamp(
            0, ranges - 1)
        kt = k_pages[table[:, s], heads].float()                   # (G, page, dh)
        vt = v_pages[table[:, s], heads].float()
        scores = torch.matmul(qf, kt.transpose(1, 2))              # (G, bq, page)
        if hit and inj[0] == INJ_S and s == inj[3]:
            _inject_decode(scores, inj, inj_mag, page)
        scores = _check(
            scores, scores.sum(1) - _vm(qsum, kt.transpose(1, 2)),
            scores.sum(2) - _mv(qf, kt.sum(1)),
            torch.clamp_min(coef_qk * qmax * kt.abs().amax((1, 2)), 1e-30),
            torch.tensor(s + 1.0, device=dev), ft.corrects, rep, 0,
            kv_start, run, zsel)
        scores = scores * scale
        kpos = kv_start + torch.arange(page, device=dev)
        scores = torch.where(kpos[None, None, :] < lens[:, None, None],
                             scores, torch.full_like(scores, NEG_INF))
        mz, lz, az = m[zsel, rows], l[zsel, rows], acc[zsel, rows]
        m_new = torch.maximum(mz, scores.amax(-1))
        good = m_new > 0.5 * NEG_INF
        p = torch.exp(torch.clamp_max(scores - m_new[..., None], 0.0))
        p = torch.where(good[..., None], p, torch.zeros_like(p))
        alpha = torch.exp(torch.clamp_max(mz - m_new, 0.0))
        delta = torch.matmul(p, vt)                                # (G, bq, dh)
        if hit and inj[0] == INJ_DELTA and s == inj[3]:
            _inject_decode(delta, inj, inj_mag, dh)
        if hook is not None:
            seu.land(delta, hook[0] & (hook[1] == s) & run, hook[2], hook[3],
                     ft.inject_bit_shift)
        eff_kv = torch.clamp_max(lens - kv_start, page).float()
        delta = _check(
            delta, delta.sum(1) - _vm(p.sum(1), vt),
            delta.sum(2) - _mv(p, vt.sum(2)),
            torch.clamp_min(coef * eff_kv * vt.abs().amax((1, 2)), 1e-30),
            eff_kv, ft.corrects, rep, 0, 0, run, zsel)
        upd = run[:, None]
        acc[zsel, rows] = torch.where(upd[..., None],
                                      az * alpha[..., None] + delta, az)
        l[zsel, rows] = torch.where(upd, lz * alpha + p.sum(-1), lz)
        m[zsel, rows] = torch.where(upd, m_new, mz)
    return acc, m, l, rep


def _inject_decode(x, inj, mag, width):
    """Add the SEU ``mag`` at (row, col) = inj[4:6] of row inj[1] of a
    per-step product x (G, bq, width), if inside it."""
    ig, ir, ic = inj[1], inj[4], inj[5]
    if 0 <= ig < x.shape[0] and 0 <= ir < x.shape[1] and 0 <= ic < width:
        x[ig, ir, ic] += mag


def combine_plain(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  rep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode ranges' merge in plain PyTorch, what the combine kernel
    computes: of the f32 partials acc (Z, G, bq, dh), m, l (Z, G, bq), the
    non-empty ranges (m > NEG_INF / 2) weighted by w = exp(m - max m),
    out = Σ w·acc / Σ w·l, exact zeros on degenerate rows; the reports (Z,
    G, 8) merged in range order by `merge_ranges`. At one range this is the
    unsplit walk's flush. Returns (out (G, bq, dh) f32, report (G, 1,
    8))."""
    live = m > 0.5 * NEG_INF
    mm = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(0)
    w = torch.where(live, torch.exp(torch.clamp_max(m - mm, 0.0)),
                    torch.zeros_like(m))
    ll = (w * l).sum(0)
    aa = (w[..., None] * acc).sum(0)
    good = (mm > 0.5 * NEG_INF) & (ll > 0.0)
    linv = torch.where(good, 1.0 / torch.clamp_min(ll, 1e-30),
                       torch.zeros_like(ll))
    return aa * linv[..., None], merge_ranges(list(rep))[:, None, :]


def decode_ranges(rows: int, max_pages: int) -> int:
    """K6's range count for ``rows`` (slot, kv head) rows over a page table
    ``max_pages`` wide: 1 when the rows reach `SPLIT_TARGET` CTAs (about
    two waves of the H100's 132 SMs, as `dkv_ranges`), else the count that
    brings the grid there, at most the table's width. Each CTA takes its
    contiguous, balanced share of its row's live pages (`dkv_range_of`'s
    rule), read from the lengths on the device."""
    if rows >= SPLIT_TARGET:
        return 1
    return max(1, min(cdiv(SPLIT_TARGET, rows), max_pages))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one paged-decode call runs. ``instance``: "sm90"
    (csrc/flash_decode_sm90.cu: the tensor cores, the pages of each row in
    ``ranges`` ranges, then the combine) or "simt" (csrc/flash_decode.cu,
    one range); ``reason``: why the tensor-core instance does not take the
    call ("" when it does)."""
    instance: str
    ranges: int = 1
    reason: str = ""


def plan_decode(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_table: torch.Tensor, *,
                simt: bool = False) -> DecodePlan:
    """The instance of a decode call on q (G, bq, dh) and pools (P, KVH,
    page, dh): the tensor-core instance for bf16 at head dim
    `SM90_HEAD_DIM`, bq = `SM90_DECODE_BQ` (n_rep up to 16 in bf16) and a
    page of `SM90_DECODE_PAGES`, on contiguous operands with 16-byte
    aligned bases, with `decode_ranges` ranges; every other call (f32, dh
    256, pages of 16, 32 query rows, ``simt=True``) goes to the SIMT
    kernel, which raises on what it does not take either. The rule does not
    depend on the device; it never falls back after a failure."""
    xs = (q, k_pages, v_pages)
    why = ""
    if simt:
        why = "the SIMT kernel pinned"
    elif q.dtype != torch.bfloat16:
        why = f"dtype {q.dtype}"
    elif q.shape[-1] != SM90_HEAD_DIM:
        why = f"head dim {q.shape[-1]}"
    elif q.shape[1] != SM90_DECODE_BQ:
        why = f"{q.shape[1]} query rows per kv head"
    elif k_pages.shape[2] not in SM90_DECODE_PAGES:
        why = f"pages of {k_pages.shape[2]}"
    elif not all(x.is_contiguous() for x in xs):
        why = "a non-contiguous operand"
    elif not all(x.data_ptr() % 16 == 0 for x in xs):
        why = "a base pointer not 16-byte aligned"
    if why:
        return DecodePlan("simt", 1, why)
    return DecodePlan("sm90", decode_ranges(q.shape[0], page_table.shape[1]))


def planned_decode_plain(q, k_pages, v_pages, lengths, page_table, *,
                         simt: bool = False, **kw):
    """K6's plain version under the plan a call on these operands follows
    (`plan_decode`: its ranges)."""
    p = plan_decode(q, k_pages, v_pages, page_table, simt=simt)
    return flash_decode_plain(q, k_pages, v_pages, lengths, page_table,
                              ranges=p.ranges, **kw)


def flash_ft_decode(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_table: torch.Tensor, *, ft: FTConfig, scale: float,
                    tau_dh: int, inj: Optional[Sequence[int]] = None,
                    inj_mag: float = 0.0, simt: bool = False,
                    rng: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: a CPU tensor runs `planned_decode_plain`, a CUDA tensor launches
    the decode kernel `plan_decode` picks (on the tensor cores, then the
    combine of its ranges) or raises. ``simt`` pins the SIMT kernel;
    ``rng`` arms the stochastic hook (`seu_decode_draws`). Returns what the
    plain version returns."""
    kw = dict(ft=ft, scale=scale, tau_dh=tau_dh, inj=inj, inj_mag=inj_mag,
              rng=rng)
    if q.device.type == "cpu":
        return planned_decode_plain(q, k_pages, v_pages, lengths, page_table,
                                    simt=simt, **kw)
    _check_decode_launch(q, k_pages, v_pages, lengths, page_table)
    p = plan_decode(q, k_pages, v_pages, page_table, simt=simt)
    inj = tuple(inj) if inj is not None else (0,) * 6
    if p.instance == "simt" and inj[0] == INJ_S:
        raise ValueError("flash_ft_decode: the SIMT kernel lands an SEU in "
                         "the PV delta only (enable 1)")
    g, bq, dh = q.shape
    n_pages, kvh, page, _ = k_pages.shape
    b, mp = page_table.shape
    out = torch.empty_like(q)
    rep = torch.empty((g, 1, REPORT_WIDTH), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b, kvh, bq, dh, page, mp, n_pages, DTYPE_CODES[q.dtype],
            int(ft.corrects), scale, ft.rel_tau * F32EPS * tau_dh,
            ft.rel_tau * F32EPS, *inj, inj_mag,
            *seu_args(rng, ft, seu.SALT_DECODE), stream)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr())
    if p.instance == "simt":
        FLASH_DECODE(*ptrs, out.data_ptr(), rep.data_ptr(), *tail)
        return out, rep
    # The combine follows every launch (at one range it is the flush).
    ws = torch.empty(p.ranges * g * DECODE_PARTIAL, dtype=torch.float32,
                     device=q.device)
    FLASH_DECODE_SM90(*ptrs, ws.data_ptr(), p.ranges, *tail)
    FLASH_DECODE_COMBINE(ws.data_ptr(), out.data_ptr(), rep.data_ptr(), g,
                         p.ranges, stream)
    return out, rep


def combine_ws_plain(ws: torch.Tensor, g: int, ranges: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine kernel's function on the workspace a tensor-core decode
    launch leaves: per (row, range), f32 acc (16 x 128), m (16), l (16)
    and the report (8), rows outer. An empty range's acc is never written
    and never read. Returns (out (G, 16, 128) bf16, report (G, 1, 8))."""
    bq, dh = SM90_DECODE_BQ, SM90_HEAD_DIM
    part = ws[:ranges * g * DECODE_PARTIAL].view(g, ranges, DECODE_PARTIAL)
    m = part[..., bq * dh:bq * dh + bq].transpose(0, 1)
    l = part[..., bq * dh + bq:bq * dh + 2 * bq].transpose(0, 1)
    rep = part[..., bq * dh + 2 * bq:].transpose(0, 1)
    live = (m > 0.5 * NEG_INF)[..., None]
    acc = torch.where(live, part[..., :bq * dh].view(g, ranges, bq, dh)
                      .transpose(0, 1), torch.zeros((), device=ws.device))
    out, rep = combine_plain(acc, m, l, rep)
    return out.to(torch.bfloat16), rep


def _check_decode_launch(q, k_pages, v_pages, lengths, page_table) -> None:
    """What K6 takes: cuda:0; contiguous q (B·KVH, bq ≤ 32, dh) and pools
    (P, KVH, page, dh) of one dtype, f32 or bf16, dh 128 or 256, a
    compiled page edge; contiguous int32 lengths (B,) and page table
    (B, MP). A page id outside the pool stops the kernel (a device trap)."""
    name = "flash_ft_decode"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    build.check_device(q)
    g, bq, dh = q.shape
    n_pages, kvh, page, dh_k = k_pages.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if dh not in DECODE_HEAD_DIMS or dh_k != dh or \
            tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"{name}: head dim must be one of "
                         f"{DECODE_HEAD_DIMS} and match: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    if page not in DECODE_PAGES:
        raise ValueError(f"{name}: the kernel is compiled for pages of "
                         f"{DECODE_PAGES} tokens, got {page}")
    if not 1 <= bq <= DECODE_MAX_BQ:
        raise ValueError(f"{name}: {bq} query rows per kv head, the kernel "
                         f"takes 1 to {DECODE_MAX_BQ}")
    if page_table.dim() != 2 or g != page_table.shape[0] * kvh or \
            tuple(lengths.shape) != (page_table.shape[0],):
        raise ValueError(f"{name}: q {tuple(q.shape)}, page table "
                         f"{tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} disagree with {kvh} kv "
                         f"heads")
    for x in (k_pages, v_pages):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name}: q and the pools must share device and "
                             f"dtype")
    for x in (lengths, page_table):
        if x.device != q.device or x.dtype != torch.int32:
            raise ValueError(f"{name}: lengths and the page table must be "
                             f"int32 tensors on {q.device}")
    for x in (q, k_pages, v_pages, lengths, page_table):
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
