"""ABFT flash-attention forward — wrapper of the CUDA kernel
`csrc/flash_ft.cu` and its plain PyTorch version.

Replaces the TPU kernel K2 of the JAX package:
`repro/kernels/flashft.py:_flash_ft_kernel`, launched by
`templates/registry.py:flash_fwd_call` (forward only, ``save_stats=False``).

`flash_ft_fwd` takes a CPU tensor to `flash_ft_plain` and a CUDA tensor to
the kernel (launch or raise). The plain version walks the same (bq, bkv)
grid — a Python loop over kv steps, vectorised over (head, q block) — and
writes the same (BH, nqb, 8) report: both in-kernel GEMMs are verified per
kv step, S = QKᵀ before scale and mask, Δ = PV before the α-rescale.

What bounds the kernel on the H100 and what its design does about it is in
the header of `csrc/flash_ft.cu`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.abft import F32EPS
from ..core.policy import FTConfig
from . import build
from .ft_gemm import DTYPE_CODES, REPORT_WIDTH, cdiv, locate_record

NEG_INF = -1e30
#: The kernel's compiled (bq, bkv) blocks and head dims.
BLOCK = 64
HEAD_DIMS = (64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
FLASH_FT = build.Kernel("flash_ft", "flash_ft_launch", _ARGTYPES)

def flash_ft_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   ft: FTConfig, scale: float, tau_dh: int,
                   n_rep: int = 1, causal: bool = True,
                   bq: int = BLOCK, bkv: int = BLOCK,
                   inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on the kernel's block grid.

    q (BH, Sq, dh); k, v (BH / n_rep, Skv, dh). ``tau_dh`` is the head dim
    in the QK threshold (the reference's 128-padded width); ``scale``
    multiplies the verified scores. ``inj`` is the kernel's injection
    vector [enable, bh, q_block, kv_step, row, col]: with enable = 1,
    ``inj_mag`` is added to the PV delta of that head and q block at that
    kv step, element (row, col) of the block. Returns
    (out (BH, Sq, dh) in q's dtype, report (BH, nqb, 8))."""
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
        if inj is not None and inj[0] == 1 and s == inj[3]:
            _, ih, iq, _, ir, ic = inj
            if 0 <= ir < bq and 0 <= ic < dh:
                delta[ih // r, ih % r, iq, ir, ic] += inj_mag
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
    return out.to(q.dtype), rep.reshape(bh, nqb, REPORT_WIDTH)


def flash_ft_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 ft: FTConfig, scale: float, tau_dh: int, n_rep: int = 1,
                 causal: bool = True,
                 inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
                 bq: Optional[int] = None,
                 bkv: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ABFT flash attention forward: a CPU tensor runs `flash_ft_plain`
    (blocks default to the kernel's 64), a CUDA tensor launches the kernel
    or raises. Returns (out, report) as `flash_ft_plain` does."""
    bq = BLOCK if bq is None else bq
    bkv = BLOCK if bkv is None else bkv
    if q.device.type == "cpu":
        return flash_ft_plain(q, k, v, ft=ft, scale=scale, tau_dh=tau_dh,
                              n_rep=n_rep, causal=causal, bq=bq, bkv=bkv,
                              inj=inj, inj_mag=inj_mag)
    if q.device.type != "cuda":
        raise ValueError(f"flash_ft_fwd: unsupported device {q.device}")
    build.check_device(q)
    bh, sq, dh = q.shape
    g, skv, dh_k = k.shape
    if (bq, bkv) != (BLOCK, BLOCK):
        raise ValueError(f"flash_ft_fwd: the kernel is compiled for "
                         f"bq = bkv = {BLOCK}, got ({bq}, {bkv})")
    if dh not in HEAD_DIMS or dh_k != dh or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_ft_fwd: head dim must be one of "
                         f"{HEAD_DIMS} and match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bh != g * n_rep:
        raise ValueError(f"flash_ft_fwd: {bh} query heads are not "
                         f"{g} kv heads x n_rep {n_rep}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_ft_fwd: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for x in (q, k, v):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("flash_ft_fwd: q, k, v must share device and "
                             "dtype")
        if not x.is_contiguous():
            raise ValueError("flash_ft_fwd: operands must be contiguous")
    nqb = cdiv(sq, BLOCK)
    out = torch.empty_like(q)
    rep = torch.empty((bh, nqb, REPORT_WIDTH), dtype=torch.float32,
                      device=q.device)
    inj = tuple(inj) if inj is not None else (0, 0, 0, 0, 0, 0)
    FLASH_FT(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             rep.data_ptr(), bh, sq, skv, dh, n_rep, DTYPE_CODES[q.dtype],
             int(causal), int(ft.corrects), scale,
             ft.rel_tau * F32EPS * tau_dh, ft.rel_tau * F32EPS,
             *inj, inj_mag, torch.cuda.current_stream(q.device).cuda_stream)
    return out, rep
