"""ABFT GEMM — wrapper of the CUDA kernel `csrc/ft_gemm.cu` and its plain
PyTorch version.

Replaces the TPU kernels K1 (2-D) and K5 (uniform batched) of the JAX
package: `repro/kernels/templates/emit.py:render`, launched by
`templates/registry.py:kernel_call` and `:batched_kernel_call`. One source
serves both: the 2-D kernel is the batched kernel with batch 1. Each has its
own launch counter (`FT_GEMM_2D`, `FT_GEMM_BATCHED`).

Three FT levels, the paper's threadblock / warp / thread granularities
(`repro/kernels/ftgemm.py:9-21`):

  * "block" — one running (column, row) checksum pair per output block,
    verified per k-step (verify="step") and once at the end, where the
    linear epilogue prefix is folded into the comparison;
  * "tile" — one running column checksum per band of rows and one row
    checksum per row; each band is verified, located and corrected on its
    own (one SEU per band per interval). The final verification runs on
    the raw accumulator, before the whole epilogue chain. The band comes
    from the tiles (`band_of`): at the kernel's compiled tiles the rows one
    warp owns (`spec.BANDS`), at any other the reference's 128-row MXU
    edge;
  * "inner" — every k-step's Δ = A_s·B_s is verified alone against its own
    checksums, located and corrected in Δ, then accumulated: no running
    checksums and no final verification, so ``verify`` changes nothing.

`ft_gemm` takes a CPU tensor to `ft_gemm_plain` and a CUDA tensor to the
kernel; on a CUDA tensor it launches the kernel or raises. With
``save_act_grad`` (block level) both also write the act_grad output,
act'(pre-activation) of the chain's activation from the verified, corrected
accumulator (the residual the training backward consumes), and return
((C, act_grad), report). The plain version walks the same (bm, bn, bk) tile
grid as the kernel — a Python loop over k-steps, vectorised over output
blocks — and writes the same (…, gm, gn, 8) report, so the two can be held
against each other on the card and the plain version against the reference
on the CPU.

What bounds the kernel on the H100 and what its design does about it is in
the header of `csrc/ft_gemm.cu`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.abft import F32EPS
from ..core.policy import FTConfig
from . import build
from .templates import epilogues
from .templates.spec import TILES, KernelSpec, band_of, validate

#: FT level → the kernel's LEVEL code.
LEVELS = {"block": 0, "tile": 1, "inner": 2}
#: Epilogue chains compiled at the "tile" and "inner" levels (the serving
#: projections'), row-major walk; the plain chain also on LAYOUT 1.
LEVEL_EPILOGUES = ((), ("bias",), ("silu",), ("bias", "silu"))

#: Epilogue chains the kernel is instantiated for → its `Epilogue` code.
EPILOGUES = {(): 0, ("bias",): 1, ("silu",): 2, ("bias", "silu"): 3,
             ("gelu",): 4, ("relu",): 5, ("residual",): 6}

REPORT_WIDTH = 8

_BATCH_STRIDES = [ctypes.c_longlong] * 2
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + _BATCH_STRIDES + [ctypes.c_int] * 2
             + _BATCH_STRIDES + [ctypes.c_int] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
FT_GEMM_2D = build.Kernel("ft_gemm", "ft_gemm_launch", _ARGTYPES)
FT_GEMM_BATCHED = build.Kernel("ft_gemm", "ft_gemm_launch", _ARGTYPES)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pick_tiles(m: int) -> Tuple[int, int, int]:
    """The tile configuration for an M-row problem: decode-shaped problems
    (M ≤ 16) take the short-wide tile, everything else the square one."""
    return TILES[1] if m <= 16 else TILES[0]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_act_grad(chain: Tuple[str, ...], save_act_grad: bool) -> None:
    if save_act_grad and sum(not epilogues.get(n).linear
                             for n in chain) != 1:
        raise ValueError(f"act_grad needs exactly one nonlinear op in the "
                         f"chain, got {chain}")


def _check_ft(ft: Optional[FTConfig], tiles: Sequence[int],
              save_act_grad: bool) -> Tuple[bool, str, int]:
    """(checksums on, level, rows per checksum band) of a call. act_grad is
    a block-level output."""
    if ft is None or not ft.enabled:
        return False, "off", 0
    level = ft.level
    if level not in LEVELS:
        raise ValueError(f"unknown FT level {level!r}")
    validate(KernelSpec(ft_level=level), tiles)
    if save_act_grad and level != "block":
        raise NotImplementedError(
            f"act_grad is written at the 'block' level only, not "
            f"{level!r}")
    return True, level, (band_of(tiles) if level == "tile" else tiles[0])


# ---------------------------------------------------------------------------
# shared locate / record step of the plain versions
# ---------------------------------------------------------------------------

def locate_record(d_col: torch.Tensor, d_row: torch.Tensor,
                  tau: torch.Tensor, k_el: torch.Tensor, corrects: bool,
                  rep: torch.Tensor, row_off, col_off, live=None):
    """Per-block verdicts from residuals d_col (…, C) and d_row (…, R):
    first argmax of each, detection (max residual > tau), the signed column
    residual at the located column as the magnitude, and the report update
    of the reference's `_record` (in place on rep (…, 8)). ``live`` (bool
    (…)) limits the update to blocks that ran this step. Returns
    (det, row, col, mag)."""
    acol, arow = torch.abs(d_col), torch.abs(d_row)
    col = torch.argmax(acol, dim=-1)
    row = torch.argmax(arow, dim=-1)
    resid = torch.maximum(acol.amax(-1), arow.amax(-1))
    det = resid > tau
    if live is not None:
        det = det & live
    mag = torch.where(det, torch.gather(d_col, -1, col[..., None])[..., 0],
                      torch.zeros_like(resid))
    upd = torch.ones_like(det) if live is None else live
    detf = det.float()
    rep[..., 0] += detf
    if corrects:
        rep[..., 1] += detf
    rep[..., 2] = torch.where(det, (row + row_off).float(), rep[..., 2])
    rep[..., 3] = torch.where(det, (col + col_off).float(), rep[..., 3])
    rep[..., 4] = torch.where(det, mag, rep[..., 4])
    rep[..., 5] = torch.where(upd, torch.maximum(rep[..., 5], resid),
                              rep[..., 5])
    rep[..., 6] = torch.where(upd, tau.expand_as(resid), rep[..., 6])
    rep[..., 7] = torch.where(upd, k_el.expand_as(resid), rep[..., 7])
    return det, row, col, mag


def locate_bands(d_col: torch.Tensor, d_row: torch.Tensor,
                 tau: torch.Tensor, k_el: torch.Tensor, corrects: bool,
                 rep: torch.Tensor, row_off, col_off, band: int):
    """`locate_record` over a band axis: residuals d_col (…, nb, C) and
    d_row (…, nb, band) of nb bands of one block give per-band verdicts,
    folded into rep (…, 8) as the reference's per-band `_record` calls in
    band order: det and corr add over the bands, row / col / mag are the
    last detecting band's, max_residual the max, tau and k overwritten.
    Returns (det, row, col, mag), each (…, nb), row local to its band."""
    nbands = d_col.shape[-2]
    acol, arow = torch.abs(d_col), torch.abs(d_row)
    col = torch.argmax(acol, dim=-1)
    row = torch.argmax(arow, dim=-1)
    resid = torch.maximum(acol.amax(-1), arow.amax(-1))
    det = resid > tau[..., None]
    mag = torch.where(det, torch.gather(d_col, -1, col[..., None])[..., 0],
                      torch.zeros_like(resid))
    ndet = det.float().sum(-1)
    rep[..., 0] += ndet
    if corrects:
        rep[..., 1] += ndet
    hit = det.any(-1)
    last = (nbands - 1) - torch.argmax(det.flip(-1).to(torch.int8), dim=-1)

    def pick(x):
        return torch.gather(x, -1, last[..., None])[..., 0]

    band_row = row + band * torch.arange(nbands, device=row.device)
    rep[..., 2] = torch.where(hit, (pick(band_row) + row_off).float(),
                              rep[..., 2])
    rep[..., 3] = torch.where(hit, (pick(col) + col_off).float(), rep[..., 3])
    rep[..., 4] = torch.where(hit, pick(mag), rep[..., 4])
    rep[..., 5] = torch.maximum(rep[..., 5], resid.amax(-1))
    rep[..., 6] = tau
    rep[..., 7] = k_el.expand_as(tau)
    return det, row, col, mag


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def ft_gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                  tiles: Sequence[int], chain: Tuple[str, ...] = (),
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  ft: Optional[FTConfig] = None,
                  inj: Optional[Sequence[int]] = None,
                  inj_mag: float = 0.0, save_act_grad: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch, on the kernel's tile grid.

    a (M, K), or (*lead, M, K) with one or two leading batch dims; b (K, N),
    or (*lead, K, N) with a batched a. Returns (C, report) with C in a's
    dtype and report (gm, gn, 8) — (*lead, gm, gn, 8) when batched — or
    None with FT off. ``inj`` is the batched kernels' injection vector
    [enable, batch, row, col, k_step]: with enable = 1, ``inj_mag`` is added
    to the accumulator at global (row, col) on k-step k_step, in batch slice
    ``batch`` of the flattened leading dims (< 0: every slice). ``ft.level``
    picks the FT level, the "tile" level's band height is `band_of(tiles)`.
    With ``save_act_grad`` C is the pair (C, act_grad)."""
    ft_on, level, bh = _check_ft(ft, tiles, save_act_grad)
    _check_act_grad(chain, save_act_grad)
    lead = tuple(a.shape[:-2])
    a3 = a.reshape((-1,) + tuple(a.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    nb, m, k = a3.shape
    n = b3.shape[-1]
    bm, bn, bk = tiles
    gm, gn, gk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
    mp, np_, kp = gm * bm, gn * bn, gk * bk
    dev = a.device
    af = F.pad(a3.float(), (0, kp - k, 0, mp - m))
    bf = F.pad(b3.float(), (0, np_ - n, 0, kp - k))
    nbb = bf.shape[0]
    acc = torch.zeros(nb, mp, np_, dtype=torch.float32, device=dev)
    rep = colck = rowck = amax = bmax = None
    if ft_on:
        # Block and inner keep one band of bm rows; tile bm / band bands.
        nbands = bm // bh
        colck = torch.zeros(nb, gm, gn, nbands, bn, device=dev)
        rowck = torch.zeros(nb, gm, gn, bm, device=dev)
        amax = torch.zeros(nb, gm, device=dev)
        bmax = torch.zeros(nbb, gn, device=dev)
        rep = torch.zeros(nb, gm, gn, REPORT_WIDTH, device=dev)
        coef = torch.tensor(ft.rel_tau * F32EPS, dtype=torch.float32,
                            device=dev)
        bi = torch.arange(nb, device=dev)[:, None, None, None]
        ii = torch.arange(gm, device=dev)[None, :, None, None]
        jj = torch.arange(gn, device=dev)[None, None, :, None]
        tt = torch.arange(nbands, device=dev)

    def tau_at(k_el):
        return torch.clamp_min(coef * k_el * amax[:, :, None]
                               * bmax[:, None, :], 1e-30)

    def verify(x, col_ck, row_ck, k_el):
        """Verify, locate and (if the policy corrects) correct x (nb, mp,
        np) in place against its checksums, band by band."""
        blocks = x.view(nb, gm, nbands, bh, gn, bn)
        d_col = blocks.sum(3).permute(0, 1, 3, 2, 4) - col_ck
        d_row = (blocks.sum(5).permute(0, 1, 4, 2, 3)
                 - row_ck.reshape(nb, gm, gn, nbands, bh))
        det, row, col, mag = locate_bands(
            d_col, d_row, tau_at(k_el), k_el, ft.corrects, rep,
            ii[..., 0] * bm, jj[..., 0] * bn, bh)
        if ft.corrects:
            blocks.index_put_((bi, ii, tt, row, jj, col), -mag,
                              accumulate=True)

    for s in range(gk):
        a_s = af[:, :, s * bk:(s + 1) * bk]          # (nb, mp, bk)
        b_s = bf[:, s * bk:(s + 1) * bk, :]          # (nbb, bk, np)
        delta = torch.matmul(a_s, b_s)
        if not ft_on:
            acc += delta
            continue
        if inj is not None and inj[0] == 1 and s == inj[4]:
            _, ib, ir, ic, _ = inj
            if 0 <= ir < mp and 0 <= ic < np_:
                sl = slice(None) if ib < 0 else slice(ib, ib + 1)
                delta[sl, ir, ic] += inj_mag
        asum = a_s.reshape(nb, gm * nbands, bh, bk).sum(2)     # e^T A per band
        ck_col = (torch.matmul(asum, b_s).view(nb, gm, nbands, gn, bn)
                  .permute(0, 1, 3, 2, 4))
        bsum = b_s.reshape(nbb, bk, gn, bn).sum(3)             # (nbb, bk, gn)
        ck_row = (torch.matmul(a_s, bsum).view(nb, gm, bm, gn)
                  .permute(0, 1, 3, 2))
        amax = torch.maximum(amax, a_s.abs().reshape(nb, gm, bm * bk)
                             .amax(-1))
        bmax = torch.maximum(bmax, b_s.abs().reshape(nbb, bk, gn, bn)
                             .amax((1, 3)))
        k_el = torch.tensor(float(min((s + 1) * bk, k)), device=dev)
        if level == "inner":
            # Δ alone against its own checksums; τ still takes the elapsed
            # k and the running max|A|, max|B| (emit.py:369-378).
            verify(delta, ck_col, ck_row, k_el)
            acc += delta
            continue
        acc += delta
        colck += ck_col
        rowck += ck_row
        if ft.verify == "step" and s != gk - 1:
            verify(acc, colck, rowck, k_el)

    # epilogue. block: the linear prefix folded into the checksums, final
    # verify, then the nonlinear suffix; tile: the final verify on the raw
    # accumulator, then the whole chain; inner: the whole chain.
    bias_p = res_p = None
    if bias is not None:
        bias_p = F.pad(bias.float().reshape(1, n), (0, np_ - n))  # (1, np)
    if residual is not None:
        res_p = F.pad(residual.float().reshape(1, m, n),
                      (0, np_ - n, 0, mp - m))                    # (1, mp, np)
    split = epilogues.fold_split(chain) if level == "block" else 0
    for name in chain[:split]:
        if name == "bias":
            acc = acc + bias_p
            colck = colck + float(bm) * bias_p.view(1, 1, gn, 1, bn)
            rowck = rowck + bias_p.view(gn, bn).sum(-1)[None, None, :, None]
        else:  # residual
            acc = acc + res_p
            blocks = res_p.view(1, gm, bm, gn, bn)
            colck = colck + blocks.sum(2)[..., None, :]
            rowck = rowck + blocks.sum(4).permute(0, 1, 3, 2)
    if level in ("block", "tile"):
        verify(acc, colck, rowck, torch.tensor(float(k), device=dev))
    aux = {"vector": bias_p, "tile": res_p}
    act_grad = None
    for name in chain[split:]:
        op = epilogues.get(name)
        if save_act_grad and not op.linear:
            act_grad = op.grad(acc)[:, :m, :n].to(a.dtype).reshape(
                lead + (m, n))
        acc = op.apply(acc, aux[op.aux] if op.aux else None)
    out = acc[:, :m, :n].to(a.dtype).reshape(lead + (m, n))
    if rep is not None:
        rep = rep.reshape(lead + (gm, gn, REPORT_WIDTH))
    return ((out, act_grad) if save_act_grad else out), rep


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def ft_gemm(a: torch.Tensor, b: torch.Tensor, *,
            chain: Tuple[str, ...] = (),
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            ft: Optional[FTConfig] = None,
            inj: Optional[Sequence[int]] = None,
            inj_mag: float = 0.0,
            tiles: Optional[Sequence[int]] = None,
            save_act_grad: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C = chain(A·B) with online ABFT at ``ft.level`` when ``ft`` is
    enabled.

    a (M, K) runs K1 (2-D); a (*lead, M, K) with one or two leading batch
    dims runs K5 (batched) with b (*lead, K, N) or a shared b (K, N). The
    kernel reads A and B through their strides, so permuted views are not
    copied. ``tiles`` defaults to `pick_tiles(M)`. A CPU tensor runs
    `ft_gemm_plain`; a CUDA tensor launches the kernel or raises. Returns
    (C, report|None) as `ft_gemm_plain` does."""
    chain = tuple(chain)
    m = a.shape[-2]
    tiles = tuple(tiles) if tiles is not None else pick_tiles(m)
    if a.device.type == "cpu":
        return ft_gemm_plain(a, b, tiles=tiles, chain=chain, bias=bias,
                             residual=residual, ft=ft, inj=inj,
                             inj_mag=inj_mag, save_act_grad=save_act_grad)
    if a.device.type != "cuda":
        raise ValueError(f"ft_gemm: unsupported device {a.device}")
    return _launch(a, b, chain=chain, bias=bias, residual=residual, ft=ft,
                   inj=inj, inj_mag=inj_mag, tiles=tiles,
                   save_act_grad=save_act_grad)


def _launch(a, b, *, chain, bias, residual, ft, inj, inj_mag, tiles,
            save_act_grad):
    if tiles not in TILES:
        raise ValueError(f"ft_gemm: tiles {tiles} are not compiled; "
                         f"choose one of {TILES}")
    ft_on, level, _ = _check_ft(ft, tiles, save_act_grad)
    _check_act_grad(chain, save_act_grad)
    build.check_device(a)
    batched = a.dim() > 2
    shared = b.dim() == 2
    if a.dim() not in (2, 3, 4) or not (shared or b.dim() == a.dim()):
        raise ValueError(f"ft_gemm: bad ranks {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k or (not shared and tuple(b.shape[:-2]) != lead):
        raise ValueError(f"ft_gemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not match")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"ft_gemm: the kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {a.dtype}, {b.dtype}")
    epi = EPILOGUES.get(chain)
    if epi is None or (level in ("tile", "inner")
                       and chain not in LEVEL_EPILOGUES):
        raise NotImplementedError(f"ft_gemm: the kernel has no instance for "
                                  f"the epilogue chain {chain} at FT level "
                                  f"{level!r}")
    aux = [x for x in (bias, residual) if x is not None]
    if batched and aux:
        raise ValueError("ft_gemm: bias/residual are 2-D features")
    if ("bias" in chain) != (bias is not None) or (
            ("residual" in chain) != (residual is not None)):
        raise ValueError(f"ft_gemm: chain {chain} and aux operands disagree")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"ft_gemm: bias has {bias.numel()} elements, "
                         f"expected {n}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"ft_gemm: residual {tuple(residual.shape)}, "
                         f"expected {(m, n)}")
    for x in (a, b, *aux):
        if x.device != a.device or x.dtype != a.dtype:
            raise ValueError("ft_gemm: operands must share device and dtype")
    for x in aux:
        if not x.is_contiguous():
            raise ValueError("ft_gemm: bias and residual must be contiguous")
    bm, bn, _ = tiles
    gm, gn = cdiv(m, bm), cdiv(n, bn)
    # Two batch dims (b0, b1) with their strides; absent ones have extent 1.
    nb0, nb1 = ((1, 1) + lead)[-2:]
    sa = ((0, 0) + a.stride())[-4:]
    sb = (0, 0) + b.stride() if shared else ((0, 0) + b.stride())[-4:]
    # Offsets within one slice are 64-bit; the strides themselves are int32.
    if max(sa[2:] + sb[2:]) >= 2 ** 31:
        raise ValueError(f"ft_gemm: row / column strides {sa[2:]}, {sb[2:]} "
                         f"exceed int32")
    # The walk of the tile loads (LAYOUT in csrc/ft_gemm.cu): along the unit-
    # stride k dim of a transposed B (w.T, the K cache of decode attention)
    # or m dim of a transposed A (x.T), compiled for the plain chain;
    # row-major otherwise. The "tile" and "inner" levels compile LAYOUT 0
    # and 1.
    layout = 0
    if not chain:
        if sb[2] == 1 and sb[3] != 1:
            layout = 1
        elif sa[2] == 1 and sa[3] != 1:
            layout = 2
    if layout == 2 and level in ("tile", "inner"):
        raise NotImplementedError(f"ft_gemm: a transposed A (x.T) has no "
                                  f"instance at FT level {level!r}")
    out = torch.empty(lead + (m, n), dtype=a.dtype, device=a.device)
    act_grad = torch.empty_like(out) if save_act_grad else None
    rep = (torch.empty(lead + (gm, gn, REPORT_WIDTH), dtype=torch.float32,
                       device=a.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else (0, 0, 0, 0, 0)
    kernel = FT_GEMM_BATCHED if batched else FT_GEMM_2D
    kernel(a.data_ptr(), b.data_ptr(),
           None if bias is None else bias.data_ptr(),
           None if residual is None else residual.data_ptr(),
           out.data_ptr(), None if rep is None else rep.data_ptr(),
           None if act_grad is None else act_grad.data_ptr(),
           nb0, nb1, m, n, k, *sa, *sb,
           DTYPE_CODES[a.dtype], int(ft_on), LEVELS.get(level, 0), epi,
           TILES.index(tiles), layout,
           int(ft_on and ft.verify == "step"), int(ft_on and ft.corrects),
           ft.rel_tau * F32EPS if ft_on else 0.0,
           *inj, inj_mag, torch.cuda.current_stream(a.device).cuda_stream)
    return ((out, act_grad) if save_act_grad else out), rep
