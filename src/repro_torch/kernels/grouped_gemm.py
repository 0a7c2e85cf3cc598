"""Grouped ABFT GEMMs of the MoE layer — wrappers of the CUDA kernels K7
(`csrc/ft_gemm.cu`, its GROUPED instances) and K8 (`csrc/tgmm.cu`), and
their plain PyTorch versions.

K7 replaces the TPU kernel `repro/kernels/templates/emit.py:233 render`
(grouped body), launched by `templates/registry.py:520
batched_kernel_call` with ``grouped=True``: ``y_buf[r] = buf[r] @
w[gid[r // bm]]`` over a group-sorted buffer (`kernels.grouped.layout`)
whose row tiles never span two groups. Rows at or past their group's
``row_end`` are masked in A, in the checksums and in max|A|, so every
row-tile block keeps per-group checksums; a tile with no live row reads no
B. The report is one (det, corr, row, col, mag, max_res, tau, k) row per
(row tile, n-block), rows in global buffer coordinates.

K8 replaces `emit.py:527 render_tgmm`, launched by `registry.py:411
tgmm_kernel_call`: ``dw[g] = X_gᵀ·G_g`` over two buffers of one layout,
output (G, K, N) in f32. Each (group, k-block, n-block) output block walks
its group's row tiles as the reduction, with the running checksums
(X_g e)ᵀG_g and X_gᵀ(G_g e) and the threshold tau =
rel_tau·eps32·rows_reduced·max|X|·max|G|, verified on every tile (step) or
on the group's last (final). The group's tiles are those of the layout:
from its aligned base to its aligned end, and for the last group on to the
end of the buffer (dead tiles, verified again as the reference's grid
walks them). Empty groups are not computed: the front door
(`grouped.dispatch.tgmm_buffer_call`) zeroes their dw and report.

Both keep the reference's deterministic 4-wide injection [enable, row, col,
k_step]: K7's row is a global buffer row and k_step its k-step; K8's row and
col index dw's (K, N) and k_step is the global row-tile index (which picks
the group). A CPU tensor runs the plain version, on the kernel's tile grid;
a CUDA tensor launches the kernel or raises. What bounds the kernels on the
H100 is in the headers of their sources.
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

#: K7's compiled (bm, bn, bk) per operand dtype (`launch_grouped` in
#: csrc/ft_gemm.cu). bm is the layout's row tile.
GROUPED_TILES = {torch.float32: ((8, 128, 32), (16, 128, 32)),
                 torch.bfloat16: ((16, 128, 32),)}
#: K8's compiled (bm, bn, bk): bm the layout's row tile, (bk, bn) the dw
#: block (`launch` in csrc/tgmm.cu).
TGMM_TILES = {torch.float32: ((8, 64, 64), (16, 64, 64)),
              torch.bfloat16: ((16, 64, 64),)}

_GROUPED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_longlong] + [ctypes.c_int] * 8
                     + [ctypes.c_float] + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p])
FT_GEMM_GROUPED = build.Kernel("ft_gemm", "ft_gemm_grouped_launch",
                               _GROUPED_ARGTYPES)
_TGMM_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                  + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_void_p])
TGMM = build.Kernel("tgmm", "tgmm_launch", _TGMM_ARGTYPES)

_NO_INJ = (0, 0, 0, 0)


def _check_ft(ft: Optional[FTConfig]) -> bool:
    """True when ``ft`` asks for checksums. K7 and K8 implement the block
    level only: "tile" and "inner" raise."""
    if ft is None or not ft.enabled:
        return False
    if ft.level != "block":
        raise NotImplementedError(
            f"FT level {ft.level!r} is not implemented by the grouped "
            f"kernels K7 and K8 (only 'block')")
    return True


def row_tiles(dtype) -> Tuple[int, ...]:
    """The row tiles (layout bm) that both grouped kernels compile for
    ``dtype``."""
    return tuple(t[0] for t in GROUPED_TILES.get(dtype, ()))


def _tiles_for(table, dtype, bm: int, name: str):
    for t in table.get(dtype, ()):
        if t[0] == bm:
            return t
    raise ValueError(f"{name}: no compiled tile with row tile {bm} for "
                     f"{dtype}; compiled: {table.get(dtype, ())}")


def _group_span(row_end: torch.Tensor, bm: int, t_tiles: int):
    """(first tile, end tile, row_end) per group, int64, from the layout
    rule: group g starts at row_end[g-1] rounded up to bm and owns the
    tiles to its own aligned end; the last group also owns the dead tiles
    to the end of the buffer. Empty groups own none."""
    re = row_end.long()
    prev = F.pad(re[:-1], (1, 0))
    base = (prev + bm - 1) // bm * bm
    first = base // bm
    end = (re + bm - 1) // bm
    end[-1] = t_tiles
    end = torch.where(re > base, end, first)
    return first, end, re


# ---------------------------------------------------------------------------
# K7: plain version
# ---------------------------------------------------------------------------

def _k_slice(x: torch.Tensor, dim: int, s: int, bk: int) -> torch.Tensor:
    """Step ``s``'s slice of width bk along ``dim`` in f32, zero-padded past
    the true extent."""
    k = x.shape[dim]
    width = min(bk, k - s * bk)
    piece = x.narrow(dim, s * bk, width).float()
    if width < bk:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, bk - width]
        piece = F.pad(piece, pad)
    return piece


def ft_gemm_grouped_plain(buf: torch.Tensor, w: torch.Tensor,
                          gid: torch.Tensor, row_end: torch.Tensor, *,
                          tiles: Sequence[int],
                          ft: Optional[FTConfig] = None,
                          inj: Optional[Sequence[int]] = None,
                          inj_mag: float = 0.0
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K7's function in plain PyTorch, on the kernel's tile grid.

    buf (t_buf, K) group-sorted; w (G, K, N), any strides (a transposed
    view included); gid int (t_buf/bm,) the group of each row tile;
    row_end int (G,). Returns (y_buf (t_buf, N) in buf's dtype, report
    (t_buf/bm, gn, 8) or None with FT off). ``inj`` = [enable, row, col,
    k_step]: ``inj_mag`` is added to the accumulator at global buffer row
    ``row`` and column ``col`` on k-step ``k_step``."""
    ft_on = _check_ft(ft)
    t_buf, k = buf.shape
    _, k2, n = w.shape
    bm, bn, bk = tiles
    nt = gid.shape[0]
    if k2 != k or nt * bm != t_buf:
        raise ValueError(f"ft_gemm_grouped_plain: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}, {nt} tiles of {bm}")
    gn, gk = cdiv(n, bn), cdiv(k, bk)
    np_ = gn * bn
    dev = buf.device
    gidl = gid.long()
    row_hi = row_end.long()[gidl]                               # (nt,)
    live = ((torch.arange(nt, device=dev)[:, None] * bm
             + torch.arange(bm, device=dev)[None, :]) < row_hi[:, None])
    a3 = torch.where(live[..., None], buf.reshape(nt, bm, k).float(),
                     torch.zeros((), device=dev))
    acc = torch.zeros(nt, bm, np_, device=dev)
    rep = None
    if ft_on:
        colck = torch.zeros(nt, gn, bn, device=dev)
        rowck = torch.zeros(nt, gn, bm, device=dev)
        amax = torch.zeros(nt, device=dev)
        bmax = torch.zeros(nt, gn, device=dev)
        rep = torch.zeros(nt, gn, REPORT_WIDTH, device=dev)
        coef = torch.tensor(ft.rel_tau * F32EPS, device=dev)
        ii = torch.arange(nt, device=dev)[:, None]
        jj = torch.arange(gn, device=dev)[None, :]

    def verify(k_el):
        blocks = acc.view(nt, bm, gn, bn)
        d_col = blocks.sum(1) - colck
        d_row = blocks.sum(3).permute(0, 2, 1) - rowck
        tau = torch.clamp_min(coef * k_el * amax[:, None] * bmax, 1e-30)
        det, row, col, mag = locate_record(d_col, d_row, tau, k_el,
                                           ft.corrects, rep, ii * bm,
                                           jj * bn)
        if ft.corrects:
            blocks.index_put_((ii, row, jj, col), -mag, accumulate=True)

    for s in range(gk):
        a_s = _k_slice(a3, 2, s, bk)                            # (nt, bm, bk)
        w_s = F.pad(_k_slice(w, 1, s, bk), (0, np_ - n))        # (G, bk, np)
        b_s = w_s[gidl]                                         # (nt, bk, np)
        delta = torch.bmm(a_s, b_s)
        if ft_on and inj is not None and inj[0] == 1 and s == inj[3]:
            _, ir, ic, _ = inj
            if 0 <= ir < t_buf and 0 <= ic < np_:
                delta[ir // bm, ir % bm, ic] += inj_mag
        acc += delta
        if not ft_on:
            continue
        colck += torch.bmm(a_s.sum(1, keepdim=True), b_s).view(nt, gn, bn)
        bsum = b_s.view(nt, bk, gn, bn).sum(3)                  # (nt, bk, gn)
        rowck += torch.bmm(a_s, bsum).permute(0, 2, 1)
        amax = torch.maximum(amax, a_s.abs().amax((1, 2)))
        bmax = torch.maximum(bmax, b_s.abs().view(nt, bk, gn, bn)
                             .amax((1, 3)))
        if ft.verify == "step" and s != gk - 1:
            verify(torch.tensor(float(min((s + 1) * bk, k)), device=dev))
    if ft_on:
        verify(torch.tensor(float(k), device=dev))
    out = acc[:, :, :n].reshape(t_buf, n).to(buf.dtype)
    return out, rep


# ---------------------------------------------------------------------------
# K7: wrapper
# ---------------------------------------------------------------------------

def ft_gemm_grouped(buf: torch.Tensor, w: torch.Tensor, gid: torch.Tensor,
                    row_end: torch.Tensor, *, ft: Optional[FTConfig] = None,
                    inj: Optional[Sequence[int]] = None,
                    inj_mag: float = 0.0,
                    tiles: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y_buf = buf @ w[gid] per row tile, with block-level online ABFT when
    ``ft`` is enabled (K7). The row tile is t_buf / len(gid); ``tiles``
    defaults to K7's compiled tile for it. A CPU tensor runs
    `ft_gemm_grouped_plain`; a CUDA tensor launches the kernel or raises.
    Returns (y_buf, report|None) as the plain version does."""
    bm = buf.shape[0] // max(gid.shape[0], 1)
    tiles = (tuple(tiles) if tiles is not None
             else _tiles_for(GROUPED_TILES, buf.dtype, bm, "ft_gemm_grouped"))
    if buf.device.type == "cpu":
        return ft_gemm_grouped_plain(buf, w, gid, row_end, tiles=tiles,
                                     ft=ft, inj=inj, inj_mag=inj_mag)
    if buf.device.type != "cuda":
        raise ValueError(f"ft_gemm_grouped: unsupported device {buf.device}")
    ft_on = _check_ft(ft)
    build.check_device(buf)
    t_buf, k = buf.shape
    if w.dim() != 3 or w.shape[1] != k or gid.dim() != 1 or \
            row_end.shape != (w.shape[0],) or gid.shape[0] * bm != t_buf:
        raise ValueError(f"ft_gemm_grouped: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}, gid {tuple(gid.shape)}, row_end "
                         f"{tuple(row_end.shape)}")
    if buf.dtype not in DTYPE_CODES or w.dtype != buf.dtype:
        raise TypeError(f"ft_gemm_grouped: float32 or bfloat16 operands of "
                        f"one dtype, got {buf.dtype}, {w.dtype}")
    if tiles not in GROUPED_TILES[buf.dtype]:
        raise ValueError(f"ft_gemm_grouped: tiles {tiles} are not compiled "
                         f"for {buf.dtype}")
    for x in (w, gid, row_end):
        if x.device != buf.device:
            raise ValueError("ft_gemm_grouped: operands must share a device")
    for x in (gid, row_end):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("ft_gemm_grouped: gid and row_end must be "
                             "contiguous int32")
    n = w.shape[2]
    gn = cdiv(n, tiles[1])
    if max(buf.stride() + w.stride()[1:]) >= 2 ** 31:
        raise ValueError("ft_gemm_grouped: strides exceed int32")
    out = torch.empty(t_buf, n, dtype=buf.dtype, device=buf.device)
    rep = (torch.empty(gid.shape[0], gn, REPORT_WIDTH, dtype=torch.float32,
                       device=buf.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else _NO_INJ
    swg, swk, swn = w.stride()
    # LAYOUT 1 walks B's tile loads along a unit-stride k (w.transpose in
    # the dbuf product); row-major otherwise.
    layout = 1 if (swk == 1 and swn != 1) else 0
    FT_GEMM_GROUPED(
        buf.data_ptr(), w.data_ptr(), gid.data_ptr(), row_end.data_ptr(),
        out.data_ptr(), None if rep is None else rep.data_ptr(),
        t_buf, n, k, w.shape[0], buf.stride(0), buf.stride(1), swg, swk, swn,
        DTYPE_CODES[buf.dtype], int(ft_on), bm, layout,
        int(ft_on and ft.verify == "step"), int(ft_on and ft.corrects),
        ft.rel_tau * F32EPS if ft_on else 0.0, *inj, inj_mag,
        torch.cuda.current_stream(buf.device).cuda_stream)
    return out, rep


# ---------------------------------------------------------------------------
# K8: plain version
# ---------------------------------------------------------------------------

def tgmm_plain(x: torch.Tensor, g: torch.Tensor, row_end: torch.Tensor, *,
               tiles: Sequence[int], ft: Optional[FTConfig] = None,
               inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K8's function in plain PyTorch: dw[g] = X_gᵀ·G_g on the kernel's tile
    walk. x (t_buf, K), g (t_buf, N) group-sorted under one layout of row
    tile bm; row_end int (G,). tiles = (bm, bn, bk) with (bk, bn) the dw
    block. Returns (dw (G, K, N) f32, report (G, gk, gn, 8) or None); empty
    groups come back zero. All groups step through their tiles together,
    one tile each per step."""
    ft_on = _check_ft(ft)
    t_buf, k = x.shape
    n = g.shape[1]
    bm, bn, bk = tiles
    ng = row_end.shape[0]
    t_tiles = t_buf // bm
    if g.shape[0] != t_buf or t_tiles * bm != t_buf:
        raise ValueError(f"tgmm_plain: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, row tile {bm}")
    gk, gn = cdiv(k, bk), cdiv(n, bn)
    kp, np_ = gk * bk, gn * bn
    dev = x.device
    first, end, re = _group_span(row_end.to(dev), bm, t_tiles)
    n_tiles = end - first                                       # (G,)
    acc = torch.zeros(ng, kp, np_, device=dev)
    xf = F.pad(x.float(), (0, kp - k))
    gf = F.pad(g.float(), (0, np_ - n))
    rep = None
    if ft_on:
        colck = torch.zeros(ng, gk, gn, bn, device=dev)
        rowck = torch.zeros(ng, gk, gn, bk, device=dev)
        amax = torch.zeros(ng, gk, device=dev)
        bmax = torch.zeros(ng, gn, device=dev)
        rep = torch.zeros(ng, gk, gn, REPORT_WIDTH, device=dev)
        coef = torch.tensor(ft.rel_tau * F32EPS, device=dev)
        gg = torch.arange(ng, device=dev)[:, None, None]
        ki = torch.arange(gk, device=dev)[None, :, None]
        nj = torch.arange(gn, device=dev)[None, None, :]
    steps = int(n_tiles.max()) if ng else 0
    rows = torch.arange(bm, device=dev)
    for j in range(steps):
        active = j < n_tiles                                    # (G,)
        t = first + j
        r = t[:, None] * bm + rows[None, :]                     # (G, bm)
        ok = active[:, None] & (r < re[:, None])
        rc = r.clamp(max=t_buf - 1)
        xs = torch.where(ok[..., None], xf[rc], torch.zeros((), device=dev))
        gs = torch.where(ok[..., None], gf[rc], torch.zeros((), device=dev))
        delta = torch.bmm(xs.transpose(1, 2), gs)               # (G, kp, np)
        if ft_on and inj is not None and inj[0] == 1:
            _, ir, ic, ik = inj
            hit = torch.nonzero(active & (t == ik)).flatten().tolist()
            if hit and 0 <= ir < kp and 0 <= ic < np_:
                delta[hit[0], ir, ic] += inj_mag
        acc += delta
        if not ft_on:
            continue
        xsum = xs.view(ng, bm, gk, bk).sum(3)                   # (G, bm, gk)
        colck += torch.bmm(xsum.transpose(1, 2), gs).view(ng, gk, gn, bn)
        gsum = gs.view(ng, bm, gn, bn).sum(3)                   # (G, bm, gn)
        rowck += (torch.bmm(xs.transpose(1, 2), gsum).view(ng, gk, bk, gn)
                  .permute(0, 1, 3, 2))
        amax = torch.maximum(amax, xs.abs().view(ng, bm, gk, bk)
                             .amax((1, 3)))
        bmax = torch.maximum(bmax, gs.abs().view(ng, bm, gn, bn)
                             .amax((1, 3)))
        last = j == n_tiles - 1
        now = active & (last | (ft.verify == "step"))
        if not bool(now.any()):
            continue
        rows_el = torch.clamp_min(
            torch.minimum((t + 1) * bm, re) - first * bm, 1).float()
        tau = torch.clamp_min(coef * rows_el[:, None, None]
                              * amax[:, :, None] * bmax[:, None, :], 1e-30)
        blocks = acc.view(ng, gk, bk, gn, bn)
        d_col = blocks.sum(2) - colck                           # (G, gk, gn, bn)
        d_row = blocks.sum(4).permute(0, 1, 3, 2) - rowck       # (G, gk, gn, bk)
        live = now[:, None, None].expand(ng, gk, gn)
        det, row, col, mag = locate_record(
            d_col, d_row, tau, rows_el[:, None, None], ft.corrects, rep,
            ki * bk, nj * bn, live=live)
        if ft.corrects:
            blocks.index_put_((gg, ki, row, nj, col), -mag, accumulate=True)
    return acc[:, :k, :n].contiguous(), rep


# ---------------------------------------------------------------------------
# K8: wrapper
# ---------------------------------------------------------------------------

def tgmm(x: torch.Tensor, g: torch.Tensor, row_end: torch.Tensor, *,
         bm: int, ft: Optional[FTConfig] = None,
         inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
         tiles: Optional[Sequence[int]] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dw[g] = X_gᵀ·G_g (G, K, N) f32 with block-level online ABFT when ``ft``
    is enabled (K8), over buffers of row tile ``bm``. A CPU tensor runs
    `tgmm_plain`; a CUDA tensor launches the kernel or raises. The kernel
    leaves the dw and report blocks of empty groups unwritten: call through
    `grouped.dispatch.tgmm_buffer_call`, which zeroes them."""
    tiles = (tuple(tiles) if tiles is not None
             else _tiles_for(TGMM_TILES, x.dtype, bm, "tgmm"))
    if x.device.type == "cpu":
        return tgmm_plain(x, g, row_end, tiles=tiles, ft=ft, inj=inj,
                          inj_mag=inj_mag)
    if x.device.type != "cuda":
        raise ValueError(f"tgmm: unsupported device {x.device}")
    ft_on = _check_ft(ft)
    build.check_device(x)
    t_buf, k = x.shape
    n = g.shape[-1]
    if g.dim() != 2 or g.shape[0] != t_buf or t_buf % bm != 0 or \
            row_end.dim() != 1:
        raise ValueError(f"tgmm: x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"row tile {bm}")
    if x.dtype not in DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"tgmm: float32 or bfloat16 operands of one dtype, "
                        f"got {x.dtype}, {g.dtype}")
    if tiles not in TGMM_TILES[x.dtype]:
        raise ValueError(f"tgmm: tiles {tiles} are not compiled for "
                         f"{x.dtype}")
    if g.device != x.device or row_end.device != x.device or \
            row_end.dtype != torch.int32 or not row_end.is_contiguous():
        raise ValueError("tgmm: operands on one device, row_end contiguous "
                         "int32")
    if max(x.stride() + g.stride()) >= 2 ** 31:
        raise ValueError("tgmm: strides exceed int32")
    ng = row_end.shape[0]
    _, bn, bk = tiles
    gk, gn = cdiv(k, bk), cdiv(n, bn)
    out = torch.empty(ng, k, n, dtype=torch.float32, device=x.device)
    rep = (torch.empty(ng, gk, gn, REPORT_WIDTH, dtype=torch.float32,
                       device=x.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else _NO_INJ
    TGMM(x.data_ptr(), g.data_ptr(), row_end.data_ptr(), out.data_ptr(),
         None if rep is None else rep.data_ptr(),
         t_buf, k, n, ng, x.stride(0), x.stride(1), g.stride(0), g.stride(1),
         DTYPE_CODES[x.dtype], int(ft_on), bm,
         int(ft_on and ft.verify == "step"), int(ft_on and ft.corrects),
         ft.rel_tau * F32EPS if ft_on else 0.0, *inj, inj_mag,
         torch.cuda.current_stream(x.device).cuda_stream)
    return out, rep
