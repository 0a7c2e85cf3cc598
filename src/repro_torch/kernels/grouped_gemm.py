"""Grouped ABFT GEMMs of the MoE layer — wrappers of the CUDA kernels K7
and K8 and their plain PyTorch versions.

K7 replaces the TPU kernel `repro/kernels/templates/emit.py:233 render`
(grouped body), launched by `templates/registry.py:520
batched_kernel_call` with ``grouped=True``: ``y_buf[r] = chain(buf[r] @
w[gid[r // bm]])`` over a group-sorted buffer (`kernels.grouped.layout`),
the chain an aux-free list of activations (silu, gelu, relu) applied after
the final verification (after the last step's at "inner"),
whose row tiles never span two groups. Rows at or past their group's
``row_end`` are masked in A, in the checksums and in max|A|, so every
block keeps per-group checksums. The report is one (det, corr, row, col,
mag, max_res, tau, k) row per (row tile, n-block), rows in global buffer
coordinates.

K8 replaces `emit.py:527 render_tgmm`, launched by `registry.py:411
tgmm_kernel_call`: ``dw[g] = X_gᵀ·G_g`` over two buffers of one layout,
output (G, K, N) in f32. Each (group, k-block, n-block) output block walks
its group's rows as the reduction, with the running checksums
(X_g e)ᵀG_g and X_gᵀ(G_g e) and the threshold tau =
rel_tau·eps32·rows_reduced·max|X|·max|G|, verified after every interval
(step) or after the group's last (final). The group's rows are those of the
layout: from its aligned base to its aligned end, and for the last group
on to the end of the buffer (dead rows, verified again as the reference's
grid walks them). Empty groups come back as a zero dw and a zero report.

Both run the paper's three FT levels. "block" as above; "tile" keeps one
running column checksum per band (`templates.spec.band_of`: K7's band is
the buffer rows one warp owns, in the SIMT block or (16, one layout tile)
in the tensor-core chunk, K8's the dw rows one warp owns, 8 of the SIMT 64
x 64 dw block or 16 of the tensor-core 128 x 128 one; at any other tiles
the reference's 128) and
verifies, locates and corrects each band on its own, the final
verification included; "inner" verifies each k-step's (K7) or interval's
(K8: a row tile on the SIMT instance, a 64-row stage on the tensor cores)
Δ alone against its own checksums, corrects it and then accumulates it,
with no final verification. tau takes the elapsed k (K7) or live rows
(K8) and the running maxima at every level.

Two instances of each: the tensor-core ones of `csrc/grouped_sm90.cu`
(bf16, every level, K7's with any aux-free chain; `wgmma` fed by a TMA
ring) and the SIMT ones of `csrc/ft_gemm.cu` (GROUPED; K7 with a chain on
its GROUPED chain instance in `csrc/ft_gemm_chain.cu`) and `csrc/tgmm.cu`
(f32, and the tiles of `GROUPED_TILES` / `TGMM_TILES` when pinned).
`plan_k7` / `plan_k8` pick the instance, the tiles and the chunk by a
written rule:

  * K7 on the tensor cores: a CTA owns a ``chunk`` of 64 rows of one group,
    from the group's aligned base in steps of 64 and never past the group's
    region; its record goes in the report row of the chunk's first layout
    tile, the clean record (tau 1e-30, k = K) in the others; 256-deep
    k-steps (the verification interval and the injection's k_step). At
    "tile" and "inner", and under a campaign, each 16-row band (layout
    tile) is verified on its own and records into its own tile's row;
  * K8 on the tensor cores: (bk, bn) = (128, 128) dw blocks; the reduction
    in 64-row intervals (``chunk``) from the group's base, each a "step"
    verification and at "inner" one Δ; at "tile" 16-row bands of dw;
  * on the SIMT instances, chunk = bm: every row tile its own block (K7)
    and interval (K8).

Each instance has its own launch counter; `FT_GEMM_GROUPED` and `TGMM`
are K7's and K8's totals. Both keep the reference's deterministic 4-wide
injection [enable, row, col, k_step]: K7's row is a global buffer row and
k_step its k-step; K8's row and col index dw's (K, N) and k_step is the
global row-tile index (which picks the group; it lands at the end of the
interval that holds it). A CPU tensor runs the plain version under the
plan, on the kernel's grid; a CUDA tensor launches the kernel or raises.
What bounds the kernels on the H100 is in the headers of their sources.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.abft import F32EPS
from ..core.policy import FTConfig
from . import build
from .ft_gemm import (DTYPE_CODES, LEVELS, REPORT_WIDTH, SEU_ARGTYPES,
                      SM90_LEVELS, _check_chain_cap,
                      _check_ft, cdiv, chain_code, ft_level, locate_bands,
                      locate_record, seu_armed, seu_args)
from .templates import epilogues, seu
from .templates.spec import SM90_GROUPED_TILES, SM90_TGMM_TILES

#: K7's compiled (bm, bn, bk) per operand dtype (`launch_grouped` in
#: csrc/ft_gemm.cu). bm is the layout's row tile.
GROUPED_TILES = {torch.float32: ((8, 128, 32), (16, 128, 32)),
                 torch.bfloat16: ((16, 128, 32),)}
#: K8's compiled (bm, bn, bk): bm the layout's row tile, (bk, bn) the dw
#: block (`launch` in csrc/tgmm.cu).
TGMM_TILES = {torch.float32: ((8, 64, 64), (16, 64, 64)),
              torch.bfloat16: ((16, 64, 64),)}

#: The tensor-core instances (csrc/grouped_sm90.cu): K7's (bm, bn, bk)
#: (`spec.SM90_GROUPED_TILES`) with bk the 256-deep k-step, K8's
#: (`spec.SM90_TGMM_TILES`) with (bk, bn) the dw block; bm the layout's row
#: tile. `SM90_CHUNK`: the rows one K7 CTA owns and one K8 verification
#: interval reduces.
SM90_CHUNK = 64

_GROUPED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_longlong] + [ctypes.c_int] * 9
                     + [ctypes.c_float] + [ctypes.c_int] * 4
                     + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
FT_GEMM_GROUPED_SIMT = build.Kernel("ft_gemm", "ft_gemm_grouped_launch",
                                    _GROUPED_ARGTYPES)
#: K7's SIMT chain instance (csrc/ft_gemm_chain.cu): the arguments of
#: ft_gemm_grouped_launch with (chain_ops, chain_len) after the layout.
_GROUPED_CHAIN_ARGTYPES = (_GROUPED_ARGTYPES[:20] + [ctypes.c_int] * 2
                           + _GROUPED_ARGTYPES[20:])
FT_GEMM_GROUPED_CHAIN = build.Kernel("ft_gemm_chain",
                                     "ft_gemm_grouped_chain_launch",
                                     _GROUPED_CHAIN_ARGTYPES)
_GROUPED_SM90_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                          + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6
                          + [ctypes.c_float] + [ctypes.c_int] * 4
                          + [ctypes.c_float] + SEU_ARGTYPES
                          + [ctypes.c_void_p])
FT_GEMM_GROUPED_SM90 = build.Kernel("grouped_sm90", "grouped_sm90_launch",
                                    _GROUPED_SM90_ARGTYPES)
#: Every K7 launch, on any instance.
FT_GEMM_GROUPED = build.LaunchTotal(FT_GEMM_GROUPED_SIMT,
                                    FT_GEMM_GROUPED_SM90,
                                    FT_GEMM_GROUPED_CHAIN)
_TGMM_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                  + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
TGMM_SIMT = build.Kernel("tgmm", "tgmm_launch", _TGMM_ARGTYPES)
_TGMM_SM90_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
TGMM_SM90 = build.Kernel("grouped_sm90", "tgmm_sm90_launch",
                         _TGMM_SM90_ARGTYPES)
#: Every K8 launch, on either instance.
TGMM = build.LaunchTotal(TGMM_SIMT, TGMM_SM90)

_NO_INJ = (0, 0, 0, 0)


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
# the plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """How one K7 or K8 call runs. ``instance``: "sm90"
    (csrc/grouped_sm90.cu), "simt" (csrc/ft_gemm.cu GROUPED for K7,
    csrc/tgmm.cu for K8), "simt_chain" (K7 with a chain on the SIMT
    kernel: csrc/ft_gemm_chain.cu's GROUPED instance) or "plain" (tiles no
    kernel compiles: the plain version only, on the CPU); ``tiles`` (bm,
    bn, bk); ``chunk``: the rows
    of one K7 block or one K8 verification interval (bm on the SIMT
    instances); ``w_kmajor``: K7's w read along a unit-stride k (the wᵀ
    view of the dbuf product); ``reason``: why the tensor-core instance
    does not take the call ("" when it does), and for "simt_chain" that the
    chain runs on the chain instance."""
    instance: str
    tiles: Tuple[int, int, int]
    chunk: int
    w_kmajor: bool = False
    reason: str = ""


def _rows_tma(strides: Sequence[int], width: int) -> bool:
    """A (rows, width) operand TMA reads row by row: unit-stride rows whose
    stride is a multiple of 8 elements (16 bytes) and spans the row."""
    s_row, s_col = strides
    return s_col == 1 and s_row % 8 == 0 and s_row >= width


def _pick(why: str, tiles, sm90_tiles, table, dtype, bm: int, name: str,
          chain=(), **extra) -> GroupedPlan:
    """The tensor-core instance unless ``why`` says otherwise or ``tiles``
    are pinned: pinned tiles run the SIMT instance where it compiles them
    (K7 with a ``chain``: its chain instance), else the plain version alone
    (CPU), each row tile its own block or interval, as the reference's grid
    walks them."""
    if tiles is None and not why:
        return GroupedPlan("sm90", sm90_tiles, SM90_CHUNK, **extra)
    if tiles is None:
        tiles = _tiles_for(table, dtype, bm, name)
    tiles = tuple(tiles)
    why = why or "pinned tiles"
    if tiles not in table.get(dtype, ()):
        return GroupedPlan("plain", tiles, tiles[0], reason=why)
    if chain:
        return GroupedPlan("simt_chain", tiles, tiles[0], reason=(
            f"{why}; the chain {tuple(chain)} on the SIMT chain instance"))
    return GroupedPlan("simt", tiles, tiles[0], reason=why)


@functools.lru_cache(maxsize=1024)
def plan_k7(n: int, k: int, dtype, bm: int, *, level: str = "off",
            buf_strides: Sequence[int], w_strides: Sequence[int],
            aligned: bool = True, chain: Tuple[str, ...] = (),
            tiles: Optional[Sequence[int]] = None) -> GroupedPlan:
    """K7's instance, tiles and chunk for a (t_buf, K) buffer of row tile
    ``bm`` against w (G, K, N) with strides ``w_strides`` at FT ``level``
    ("off" with FT disabled). The tensor-core instance takes a bf16 call
    at any level on the 16-row layout whose buffer TMA reads by rows and
    whose w is row-major or the wᵀ view (unit stride along n or along k,
    the other strides multiples of 8 elements), with 16-byte aligned
    bases; every other call runs on the SIMT instance at
    ``GROUPED_TILES`` (by this rule, never as a fallback). A ``chain`` (an
    aux-free list of activations) changes nothing on the tensor cores,
    which apply it in their store; on the SIMT kernel it sends the call to
    the chain instance ("simt_chain", `GroupedPlan.reason` naming it). A
    chain longer than `ft_gemm.CHAIN_CAP` raises NotImplementedError.
    Explicit ``tiles`` pin the SIMT instances (or, at tiles they do not
    compile, the plain version alone). A pure function of its arguments,
    cached."""
    _check_chain_cap(chain)
    swg, swk, swn = w_strides
    w_n = swn == 1 and swk % 8 == 0 and swk >= n
    w_k = swk == 1 and swn % 8 == 0 and swn >= k
    why = ""
    if dtype != torch.bfloat16:
        why = f"dtype {dtype}"
    elif bm != SM90_GROUPED_TILES[0]:
        why = f"row tile {bm}"
    elif not _rows_tma(buf_strides, k):
        why = f"buffer strides {tuple(buf_strides)}"
    elif not (w_n or w_k) or swg % 8 != 0:
        why = f"w strides {tuple(w_strides)}"
    elif not aligned:
        why = "a base pointer not 16-byte aligned"
    return _pick(why, tiles, SM90_GROUPED_TILES, GROUPED_TILES, dtype, bm,
                 "ft_gemm_grouped", chain, w_kmajor=w_k and not w_n)


@functools.lru_cache(maxsize=1024)
def plan_k8(k: int, n: int, dtype, bm: int, *, level: str = "off",
            x_strides: Sequence[int], g_strides: Sequence[int],
            aligned: bool = True,
            tiles: Optional[Sequence[int]] = None) -> GroupedPlan:
    """K8's instance, tiles and interval for buffers x (t_buf, K) and g
    (t_buf, N) of row tile ``bm`` at FT ``level`` ("off" with FT
    disabled): the tensor-core instance for bf16 at any level on the
    16-row layout with both buffers TMA-readable by rows and 16-byte
    aligned, else the SIMT one at ``TGMM_TILES`` (by this rule, never as a
    fallback); ``tiles`` pin it as in `plan_k7`."""
    why = ""
    if dtype != torch.bfloat16:
        why = f"dtype {dtype}"
    elif bm != SM90_TGMM_TILES[0]:
        why = f"row tile {bm}"
    elif not (_rows_tma(x_strides, k) and _rows_tma(g_strides, n)):
        why = f"buffer strides {tuple(x_strides)}, {tuple(g_strides)}"
    elif not aligned:
        why = "a base pointer not 16-byte aligned"
    return _pick(why, tiles, SM90_TGMM_TILES, TGMM_TILES, dtype, bm, "tgmm")


def _aligned(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def plan_k7_call(buf: torch.Tensor, w: torch.Tensor, gid: torch.Tensor,
                 tiles=None, ft: Optional[FTConfig] = None,
                 chain=()) -> GroupedPlan:
    """`plan_k7` of a call of `ft_gemm_grouped` on these operands."""
    bm = buf.shape[0] // max(gid.shape[0], 1)
    return plan_k7(w.shape[2], buf.shape[1], buf.dtype, bm,
                   level=ft_level(ft), buf_strides=tuple(buf.stride()),
                   w_strides=tuple(w.stride()), aligned=_aligned(buf, w),
                   chain=tuple(chain),
                   tiles=None if tiles is None else tuple(tiles))


def plan_k8_call(x: torch.Tensor, g: torch.Tensor, bm: int,
                 tiles=None, ft: Optional[FTConfig] = None) -> GroupedPlan:
    """`plan_k8` of a call of `tgmm` on these operands."""
    return plan_k8(x.shape[1], g.shape[1], x.dtype, bm,
                   level=ft_level(ft), x_strides=tuple(x.stride()),
                   g_strides=tuple(g.stride()),
                   aligned=_aligned(x, g),
                   tiles=None if tiles is None else tuple(tiles))


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


def _chunks(gid: torch.Tensor, row_end: torch.Tensor, bm: int, chunk: int,
            t_buf: int):
    """K7's blocks: each group's region (its aligned base to its aligned
    end, the last group's on to the end of the buffer, as the layout's gid
    clamps the dead tiles to it) cut into ``chunk``-row pieces from the
    base. Returns (first row, rows, group) int64 per block; with chunk =
    bm every row tile is one."""
    dev = gid.device
    re = row_end.long()
    base = (F.pad(re[:-1], (1, 0)) + bm - 1) // bm * bm
    rend = (re + bm - 1) // bm * bm
    rend[-1] = t_buf
    gidl = gid.long()
    tile_row = torch.arange(gid.shape[0], device=dev) * bm
    idx = torch.nonzero((tile_row - base[gidl]) % chunk == 0).flatten()
    r0, grp = tile_row[idx], gidl[idx]
    return r0, torch.minimum(r0 + chunk, rend[grp]) - r0, grp


def ft_gemm_grouped_plain(buf: torch.Tensor, w: torch.Tensor,
                          gid: torch.Tensor, row_end: torch.Tensor, *,
                          tiles: Sequence[int], chunk: Optional[int] = None,
                          chain: Tuple[str, ...] = (),
                          ft: Optional[FTConfig] = None,
                          inj: Optional[Sequence[int]] = None,
                          inj_mag: float = 0.0,
                          rng: Optional[Sequence[int]] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K7's function in plain PyTorch, on the kernel's grid.

    buf (t_buf, K) group-sorted; w (G, K, N), any strides (a transposed
    view included); gid int (t_buf/bm,) the group of each row tile;
    row_end int (G,). tiles = (bm, bn, bk); ``chunk`` (default bm) the rows
    of one block (`_chunks`). Returns (y_buf (t_buf, N) in buf's dtype,
    report (t_buf/bm, gn, 8) or None with FT off): each block's record in
    the row of its first row tile, the clean record (tau 1e-30, k = K) in
    the others. ``ft.level`` picks the FT level: at "tile" a block is
    verified in bands of `band_of(tiles, "grouped")` rows, each with its own
    column checksum, its verdicts folded into the block's record in band
    order (`locate_bands`) where a band is narrower than the row tile, else
    each band recorded in its own first row tile's row; at "inner" each
    k-step's Δ is verified alone, in bands of bm rows.
    ``inj`` = [enable, row, col, k_step]: ``inj_mag`` is added to the
    accumulator at global buffer row ``row`` and column ``col`` on k-step
    ``k_step``. ``rng``, a campaign's triple, draws one SEU per row tile
    (`seu_tile_draws`), landed on its step's Δ; a block under a campaign
    at "block" or "inner" verifies each of its bm-row bands on its own (the
    band's column sums and column checksums, its rows' residuals, the
    block's tau), so each tile's SEU is located and corrected whatever the
    others do, and each row tile's report row holds its band's record.
    ``chain``, an aux-free list of activations, is applied to the f32
    accumulator after the final verification (after the last step's at
    "inner"; alone with FT off), every row of a block, then rounded."""
    t_buf, k = buf.shape
    _, k2, n = w.shape
    bm, bn, bk = tiles
    ft_on, level, tile_band = _check_ft(ft, tiles, "grouped")
    chunk = bm if chunk is None else chunk
    nt = gid.shape[0]
    if k2 != k or nt * bm != t_buf or chunk % bm != 0:
        raise ValueError(f"ft_gemm_grouped_plain: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}, {nt} tiles of {bm}, chunk "
                         f"{chunk}")
    gn, gk = cdiv(n, bn), cdiv(k, bk)
    np_ = gn * bn
    dev = buf.device
    r0, length, grp = _chunks(gid, row_end.to(dev), bm, chunk, t_buf)
    nc = r0.shape[0]
    rows = r0[:, None] + torch.arange(chunk, device=dev)[None, :]
    inside = rows < (r0 + length)[:, None]
    live = inside & (rows < row_end.to(dev).long()[grp][:, None])
    a3 = torch.where(live[..., None],
                     buf[rows.clamp(max=t_buf - 1)].float(),
                     torch.zeros((), device=dev))
    # bands of a block: the tile level's, else the row tiles (inner, a
    # campaign) or the whole block; bands narrower than the row tile fold
    # into one record a block, the others record into their own rows
    if level == "tile":
        band = tile_band
    else:
        band = bm if (level == "inner" or seu_armed(rng, ft)) else chunk
    tiled = band < bm
    nbd = chunk // band
    acc = torch.zeros(nc, chunk, np_, device=dev)
    rep = None
    if ft_on:
        colck = torch.zeros(nc, nbd, gn, bn, device=dev)
        rowck = torch.zeros(nc, gn, chunk, device=dev)
        amax = torch.zeros(nc, device=dev)
        bmax = torch.zeros(nc, gn, device=dev)
        rep = torch.zeros(*((nc, gn) if tiled else (nc, nbd, gn)),
                          REPORT_WIDTH, device=dev)
        coef = torch.tensor(ft.rel_tau * F32EPS, device=dev)
        ii = torch.arange(nc, device=dev)[:, None, None]
        tt = torch.arange(nbd, device=dev)[None, :, None]
        jj = torch.arange(gn, device=dev)[None, None, :]
    hook = seu_tile_draws(rng, ft, nt, gn, gk, tiles, dev) if ft_on else None
    if hook is not None:
        # each tile's block and its row within the block's accumulator
        t_blk = torch.searchsorted(r0, torch.arange(nt, device=dev) * bm,
                                   right=True) - 1
        h_hit, h_step, h_row, h_col = hook
        h_row = (h_row + (torch.arange(nt, device=dev) * bm
                          - r0[t_blk])[:, None])
        h_col = h_col + torch.arange(gn, device=dev)[None, :] * bn

    def verify(x, col_ck, row_ck, k_el):
        """Verify, locate and (if the policy corrects) correct x (nc,
        chunk, np) in place against its checksums, band by band."""
        blocks = x.view(nc, nbd, band, gn, bn)
        d_col = blocks.sum(2) - col_ck                       # (nc, nbd, gn, bn)
        d_row = (blocks.sum(4).permute(0, 3, 1, 2)      # (nc, gn, nbd, band)
                 - row_ck.view(nc, gn, nbd, band))
        tau = torch.clamp_min(coef * k_el * amax[:, None] * bmax, 1e-30)
        if tiled:
            det, row, col, mag = locate_bands(
                d_col.permute(0, 2, 1, 3), d_row, tau, k_el, ft.corrects,
                rep, r0[:, None], jj[0] * bn, band)          # (nc, gn, nbd)
            at = (ii, tt.transpose(1, 2), row, jj.transpose(1, 2), col)
        else:
            det, row, col, mag = locate_record(
                d_col, d_row.permute(0, 2, 1, 3),
                tau[:, None, :].expand(nc, nbd, gn), k_el, ft.corrects, rep,
                (r0[:, None, None] + tt * band), jj * bn)    # (nc, nbd, gn)
            at = (ii, tt, row, jj, col)
        if ft.corrects:
            blocks.index_put_(at, -mag, accumulate=True)

    for s in range(gk):
        a_s = _k_slice(a3, 2, s, bk)                        # (nc, chunk, bk)
        w_s = F.pad(_k_slice(w, 1, s, bk), (0, np_ - n))    # (G, bk, np)
        b_s = w_s[grp]                                      # (nc, bk, np)
        delta = torch.bmm(a_s, b_s)
        if ft_on and inj is not None and inj[0] == 1 and s == inj[3]:
            _, ir, ic, _ = inj
            hit = torch.nonzero((r0 <= ir) & (ir < r0 + length)).flatten()
            if len(hit) and 0 <= ic < np_:
                c = int(hit[0])
                delta[c, ir - int(r0[c]), ic] += inj_mag
        if hook is not None:
            sel = h_hit & (h_step == s)
            ti, tj = torch.nonzero(sel, as_tuple=True)
            if ti.numel():
                at = (t_blk[ti], h_row[ti, tj], h_col[ti, tj])
                delta.index_put_(at, seu.magnitude(delta[at],
                                                   ft.inject_bit_shift),
                                 accumulate=True)
        if not ft_on:
            acc += delta
            continue
        ck_col = torch.bmm(a_s.view(nc, nbd, band, bk).sum(2), b_s
                           ).view(nc, nbd, gn, bn)
        bsum = b_s.view(nc, bk, gn, bn).sum(3)              # (nc, bk, gn)
        ck_row = torch.bmm(a_s, bsum).permute(0, 2, 1)
        amax = torch.maximum(amax, a_s.abs().amax((1, 2)))
        bmax = torch.maximum(bmax, b_s.abs().view(nc, bk, gn, bn)
                             .amax((1, 3)))
        k_el = torch.tensor(float(min((s + 1) * bk, k)), device=dev)
        if level == "inner":
            # Δ alone against its own checksums, corrected, accumulated
            verify(delta, ck_col, ck_row, k_el)
            acc += delta
            continue
        acc += delta
        colck += ck_col
        rowck += ck_row
        if ft.verify == "step" and s != gk - 1:
            verify(acc, colck, rowck, k_el)
    if ft_on and level != "inner":
        verify(acc, colck, rowck, torch.tensor(float(k), device=dev))
    for name in chain:
        acc = epilogues.activation(name)(acc)
    out = torch.zeros(t_buf, np_, device=dev)
    out[rows[inside]] = acc[inside]
    out = out[:, :n].to(buf.dtype)
    if ft_on:
        full = torch.zeros(nt, gn, REPORT_WIDTH, device=dev)
        full[..., 6] = 1e-30
        full[..., 7] = float(k)
        if tiled:
            full[r0 // bm] = rep
        else:
            for q in range(nbd):
                own = q * band < length             # the block's q-th band
                full[(r0 // bm + q * band // bm)[own]] = rep[own, q]
        rep = full
    return out, rep


def planned_grouped_plain(buf: torch.Tensor, w: torch.Tensor,
                          gid: torch.Tensor, row_end: torch.Tensor, *,
                          tiles: Optional[Sequence[int]] = None, **kw
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`ft_gemm_grouped_plain` under the plan `ft_gemm_grouped` follows for
    these operands (its tiles and chunk), on any device: the comparison
    side of the kernel on the card."""
    p = plan_k7_call(buf, w, gid, tiles, kw.get("ft"), kw.get("chain", ()))
    return ft_gemm_grouped_plain(buf, w, gid, row_end, tiles=p.tiles,
                                 chunk=p.chunk, **kw)


def seu_tile_draws(rng: Optional[Sequence[int]], ft: Optional[FTConfig],
                   n_tiles: int, gn: int, gk: int, tiles: Sequence[int],
                   device="cpu"):
    """The SEU every (row tile, n-block) of a K7 launch draws under the
    campaign triple ``rng``, as the reference's grouped body draws it per
    row-tile block: (hit, step, row, col), each (n_tiles, gn), uid
    tile·gn + j, salt `seu.SALT_GEMM2D`, rows over the tile's bm and steps
    over the gk k-steps of ``tiles``; None when no campaign is armed."""
    if not seu_armed(rng, ft):
        return None
    bm, bn, _ = tiles
    uid = (torch.arange(n_tiles, device=device)[:, None] * gn
           + torch.arange(gn, device=device)[None, :])
    return seu.draw(rng, seu.SALT_GEMM2D, uid, gk, bm, bn, ft.inject_rate)


# ---------------------------------------------------------------------------
# K7: wrapper
# ---------------------------------------------------------------------------

def ft_gemm_grouped(buf: torch.Tensor, w: torch.Tensor, gid: torch.Tensor,
                    row_end: torch.Tensor, *, chain: Tuple[str, ...] = (),
                    ft: Optional[FTConfig] = None,
                    inj: Optional[Sequence[int]] = None,
                    inj_mag: float = 0.0,
                    tiles: Optional[Sequence[int]] = None,
                    rng: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y_buf = chain(buf @ w[gid]) per row tile, with online ABFT at
    ``ft.level`` when ``ft`` is enabled (K7); ``chain`` is an aux-free list
    of activations; ``rng``, a campaign's triple, arms the stochastic SEU
    hook (`seu_tile_draws`). The row tile is t_buf / len(gid); `plan_k7`
    picks the instance, tiles and chunk (``tiles`` pins them). A CPU
    tensor runs `ft_gemm_grouped_plain` under that plan; a
    CUDA tensor launches the kernel or raises. Returns (y_buf,
    report|None) as the plain version does."""
    chain = tuple(chain)
    if any(epilogues.get(x).aux is not None for x in chain):
        raise ValueError(f"ft_gemm_grouped: the grouped kernel takes an "
                         f"aux-free chain, got {chain}")
    p = plan_k7_call(buf, w, gid, tiles, ft, chain)
    ft_on, level, _ = _check_ft(ft, p.tiles, "grouped")
    if buf.device.type == "cpu":
        return ft_gemm_grouped_plain(buf, w, gid, row_end, tiles=p.tiles,
                                     chunk=p.chunk, chain=chain, ft=ft,
                                     inj=inj, inj_mag=inj_mag, rng=rng)
    if buf.device.type != "cuda":
        raise ValueError(f"ft_gemm_grouped: unsupported device {buf.device}")
    build.check_device(buf)
    t_buf, k = buf.shape
    bm = p.tiles[0]
    if w.dim() != 3 or w.shape[1] != k or gid.dim() != 1 or \
            row_end.shape != (w.shape[0],) or gid.shape[0] * bm != t_buf:
        raise ValueError(f"ft_gemm_grouped: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}, gid {tuple(gid.shape)}, row_end "
                         f"{tuple(row_end.shape)}")
    if buf.dtype not in DTYPE_CODES or w.dtype != buf.dtype:
        raise TypeError(f"ft_gemm_grouped: float32 or bfloat16 operands of "
                        f"one dtype, got {buf.dtype}, {w.dtype}")
    if p.instance == "plain":
        raise ValueError(f"ft_gemm_grouped: tiles {p.tiles} are not compiled "
                         f"for {buf.dtype}")
    for x in (w, gid, row_end):
        if x.device != buf.device:
            raise ValueError("ft_gemm_grouped: operands must share a device")
    for x in (gid, row_end):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("ft_gemm_grouped: gid and row_end must be "
                             "contiguous int32")
    n = w.shape[2]
    gn = cdiv(n, p.tiles[1])
    if max(buf.stride() + w.stride()[1:]) >= 2 ** 31:
        raise ValueError("ft_gemm_grouped: strides exceed int32")
    out = torch.empty(t_buf, n, dtype=buf.dtype, device=buf.device)
    rep = (torch.empty(gid.shape[0], gn, REPORT_WIDTH, dtype=torch.float32,
                       device=buf.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else _NO_INJ
    swg, swk, swn = w.stride()
    if p.instance == "sm90":
        FT_GEMM_GROUPED_SM90(
            buf.data_ptr(), w.data_ptr(), gid.data_ptr(), row_end.data_ptr(),
            out.data_ptr(), None if rep is None else rep.data_ptr(),
            t_buf, n, k, w.shape[0], buf.stride(0),
            swn if p.w_kmajor else swk, swg, int(p.w_kmajor),
            SM90_LEVELS[level], chain_code(chain), len(chain),
            int(ft_on and ft.verify == "step"),
            int(ft_on and ft.corrects),
            ft.rel_tau * F32EPS if ft_on else 0.0, *inj, float(inj_mag),
            *seu_args(rng, ft, seu.SALT_GEMM2D),
            torch.cuda.current_stream(buf.device).cuda_stream)
        return out, rep
    # LAYOUT 1 walks B's tile loads along a unit-stride k (w.transpose in
    # the dbuf product); row-major otherwise.
    layout = 1 if (swk == 1 and swn != 1) else 0
    # the chain instance takes the op list after the layout
    kernel, codes = ((FT_GEMM_GROUPED_CHAIN, (chain_code(chain), len(chain)))
                     if p.instance == "simt_chain"
                     else (FT_GEMM_GROUPED_SIMT, ()))
    kernel(
        buf.data_ptr(), w.data_ptr(), gid.data_ptr(), row_end.data_ptr(),
        out.data_ptr(), None if rep is None else rep.data_ptr(),
        t_buf, n, k, w.shape[0], buf.stride(0), buf.stride(1), swg, swk, swn,
        DTYPE_CODES[buf.dtype], int(ft_on), LEVELS.get(level, 0), bm, layout,
        *codes, int(ft_on and ft.verify == "step"),
        int(ft_on and ft.corrects),
        ft.rel_tau * F32EPS if ft_on else 0.0, *inj, inj_mag,
        *seu_args(rng, ft, seu.SALT_GEMM2D),
        torch.cuda.current_stream(buf.device).cuda_stream)
    return out, rep


# ---------------------------------------------------------------------------
# K8: plain version
# ---------------------------------------------------------------------------

def tgmm_plain(x: torch.Tensor, g: torch.Tensor, row_end: torch.Tensor, *,
               tiles: Sequence[int], chunk: Optional[int] = None,
               ft: Optional[FTConfig] = None,
               inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
               rng: Optional[Sequence[int]] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K8's function in plain PyTorch: dw[g] = X_gᵀ·G_g on the kernel's
    walk. x (t_buf, K), g (t_buf, N) group-sorted under one layout of row
    tile bm; row_end int (G,). tiles = (bm, bn, bk) with (bk, bn) the dw
    block; ``chunk`` (default bm) the rows of one verification interval,
    counted from the group's aligned base. Returns (dw (G, K, N) f32,
    report (G, gk, gn, 8) or None); empty groups come back zero. All groups
    step through their intervals together, one each per step.
    ``ft.level`` picks the FT level: at "tile" each dw block is verified
    in bands of `band_of(tiles, "tgmm")` of its bk rows, each with its own
    column checksum (`locate_bands`); at "inner" each interval's Δ is
    verified alone and there is no final verification. ``rng``, a
    campaign's triple, draws one SEU per dw block over the group's live
    row tiles (`seu_dw_draws`): its magnitude comes from the hit tile's own
    product at the element, landed in the interval that holds the tile."""
    t_buf, k = x.shape
    n = g.shape[1]
    bm, bn, bk = tiles
    ft_on, level, tile_band = _check_ft(ft, tiles, "tgmm")
    chunk = bm if chunk is None else chunk
    ng = row_end.shape[0]
    t_tiles = t_buf // bm
    if g.shape[0] != t_buf or t_tiles * bm != t_buf or chunk % bm != 0:
        raise ValueError(f"tgmm_plain: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, row tile {bm}, chunk {chunk}")
    gk, gn = cdiv(k, bk), cdiv(n, bn)
    kp, np_ = gk * bk, gn * bn
    dev = x.device
    first, end, re = _group_span(row_end.to(dev), bm, t_tiles)
    base, end_row = first * bm, end * bm
    n_steps = (end_row - base + chunk - 1) // chunk              # (G,)
    acc = torch.zeros(ng, kp, np_, device=dev)
    xf = F.pad(x.float(), (0, kp - k))
    gf = F.pad(g.float(), (0, np_ - n))
    # bands of bk rows a dw block: the tile level's, else the whole block
    band = tile_band if level == "tile" else bk
    nbk = bk // band
    rep = None
    if ft_on:
        colck = torch.zeros(ng, gk, gn, nbk, bn, device=dev)
        rowck = torch.zeros(ng, gk, gn, bk, device=dev)
        amax = torch.zeros(ng, gk, device=dev)
        bmax = torch.zeros(ng, gn, device=dev)
        rep = torch.zeros(ng, gk, gn, REPORT_WIDTH, device=dev)
        coef = torch.tensor(ft.rel_tau * F32EPS, device=dev)
        gg = torch.arange(ng, device=dev)[:, None, None, None]
        ki = torch.arange(gk, device=dev)[None, :, None, None]
        nj = torch.arange(gn, device=dev)[None, None, :, None]
        tt = torch.arange(nbk, device=dev)
    steps = int(n_steps.max()) if ng else 0
    rows = torch.arange(chunk, device=dev)
    hook = None
    if ft_on:
        hook = seu_dw_draws(rng, ft, (re - base).clamp_min(0), gk, gn, tiles)
    if hook is not None:
        h_hit, h_step, h_row, h_col = hook                      # (G, gk, gn)
        h_row = h_row + torch.arange(gk, device=dev)[None, :, None] * bk
        h_col = h_col + torch.arange(gn, device=dev)[None, None, :] * bn
        h_j = h_step * bm // chunk                              # its interval

    def verify(x, col_ck, row_ck, rows_el, now):
        """Verify, locate and (if the policy corrects) correct x (G, kp,
        np) in place against its checksums, band by band, in the groups
        ``now`` (G,) marks."""
        tau = torch.clamp_min(coef * rows_el[:, None, None]
                              * amax[:, :, None] * bmax[:, None, :], 1e-30)
        blocks = x.view(ng, gk, nbk, band, gn, bn)
        d_col = blocks.sum(3).permute(0, 1, 3, 2, 4) - col_ck  # (G,gk,gn,nbk,bn)
        d_row = (blocks.sum(5).permute(0, 1, 4, 2, 3)         # (G,gk,gn,nbk,band)
                 - row_ck.view(ng, gk, gn, nbk, band))
        det, row, col, mag = locate_bands(
            d_col, d_row, tau, rows_el[:, None, None], ft.corrects, rep,
            ki[..., 0] * bk, nj[..., 0] * bn, band,
            live=now[:, None, None].expand(ng, gk, gn))
        if ft.corrects:
            blocks.index_put_((gg, ki, tt, row, nj, col), -mag,
                              accumulate=True)

    for j in range(steps):
        active = j < n_steps                                    # (G,)
        lo = base + j * chunk
        r = lo[:, None] + rows[None, :]                         # (G, chunk)
        ok = active[:, None] & (r < re[:, None])
        rc = r.clamp(max=t_buf - 1)
        xs = torch.where(ok[..., None], xf[rc], torch.zeros((), device=dev))
        gs = torch.where(ok[..., None], gf[rc], torch.zeros((), device=dev))
        delta = torch.bmm(xs.transpose(1, 2), gs)               # (G, kp, np)
        if ft_on and inj is not None and inj[0] == 1:
            _, ir, ic, ik = inj
            hi = torch.minimum(lo + chunk, end_row)
            hit = torch.nonzero(active & (lo <= ik * bm) & (ik * bm < hi)
                                ).flatten().tolist()
            if hit and 0 <= ir < kp and 0 <= ic < np_:
                delta[hit[0], ir, ic] += inj_mag
        if hook is not None:
            hg, hk, hn = torch.nonzero(h_hit & (h_j == j), as_tuple=True)
            if hg.numel():
                # the hit tile's own product at (row, col): its bm rows
                tr = (base[hg] + h_step[hg, hk, hn] * bm)[:, None] + \
                    torch.arange(bm, device=dev)[None, :]
                ok = tr < re[hg][:, None]
                tr = tr.clamp(max=t_buf - 1)
                r, c = h_row[hg, hk, hn], h_col[hg, hk, hn]
                tile_d = torch.where(ok, xf[tr, r[:, None]] * gf[tr, c[:, None]],
                                     torch.zeros((), device=dev)).sum(1)
                delta[hg, r, c] += seu.magnitude(tile_d, ft.inject_bit_shift)
        if not ft_on:
            acc += delta
            continue
        xsum = xs.view(ng, chunk, gk * nbk, band).sum(3)   # (G, chunk, gk·nbk)
        ck_col = (torch.bmm(xsum.transpose(1, 2), gs)
                  .view(ng, gk, nbk, gn, bn).permute(0, 1, 3, 2, 4))
        gsum = gs.view(ng, chunk, gn, bn).sum(3)                # (G, chunk, gn)
        ck_row = (torch.bmm(xs.transpose(1, 2), gsum).view(ng, gk, bk, gn)
                  .permute(0, 1, 3, 2))
        amax = torch.maximum(amax, xs.abs().view(ng, chunk, gk, bk)
                             .amax((1, 3)))
        bmax = torch.maximum(bmax, gs.abs().view(ng, chunk, gn, bn)
                             .amax((1, 3)))
        rows_el = torch.clamp_min(
            torch.minimum(lo + chunk, re) - base, 1).float()
        if level == "inner":
            # Δ alone against its own checksums, corrected, accumulated
            verify(delta, ck_col, ck_row, rows_el, active)
            acc += delta
            continue
        acc += delta
        colck += ck_col
        rowck += ck_row
        last = j == n_steps - 1
        now = active & (last | (ft.verify == "step"))
        if bool(now.any()):
            verify(acc, colck, rowck, rows_el, now)
    return acc[:, :k, :n].contiguous(), rep


def planned_tgmm_plain(x: torch.Tensor, g: torch.Tensor,
                       row_end: torch.Tensor, *, bm: int,
                       tiles: Optional[Sequence[int]] = None, **kw
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`tgmm_plain` under the plan `tgmm` follows for these operands, on any
    device."""
    p = plan_k8_call(x, g, bm, tiles, kw.get("ft"))
    return tgmm_plain(x, g, row_end, tiles=p.tiles, chunk=p.chunk, **kw)


def seu_dw_draws(rng: Optional[Sequence[int]], ft: Optional[FTConfig],
                 live_rows: torch.Tensor, gk: int, gn: int,
                 tiles: Sequence[int]):
    """The SEU every dw block (group, k-block, n-block) of a K8 launch
    draws under the campaign triple ``rng``, as the reference's
    `render_tgmm` draws it: (hit, step, row, col), each (G, gk, gn), uid
    (group·gk + ki)·gn + ni, salt `seu.SALT_TGMM`, steps over the group's
    row tiles that hold a live row (``live_rows`` (G,): its live rows),
    rows over bk and cols over bn of ``tiles``; None when no campaign is
    armed."""
    if not seu_armed(rng, ft):
        return None
    bm, bn, bk = tiles
    dev = live_rows.device
    ng = live_rows.shape[0]
    uid = ((torch.arange(ng, device=dev)[:, None, None] * gk
            + torch.arange(gk, device=dev)[None, :, None]) * gn
           + torch.arange(gn, device=dev)[None, None, :])
    n_live = ((live_rows.long() + bm - 1) // bm)[:, None, None]
    return seu.draw(rng, seu.SALT_TGMM, uid, n_live, bk, bn, ft.inject_rate)


# ---------------------------------------------------------------------------
# K8: wrapper
# ---------------------------------------------------------------------------

def tgmm(x: torch.Tensor, g: torch.Tensor, row_end: torch.Tensor, *,
         bm: int, ft: Optional[FTConfig] = None,
         inj: Optional[Sequence[int]] = None, inj_mag: float = 0.0,
         tiles: Optional[Sequence[int]] = None,
         rng: Optional[Sequence[int]] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dw[g] = X_gᵀ·G_g (G, K, N) f32 with online ABFT at ``ft.level`` when
    ``ft`` is enabled (K8), over buffers of row tile ``bm``. `plan_k8`
    picks the instance, tiles and interval (``tiles`` pins them). A CPU
    tensor runs `tgmm_plain` under that plan; a CUDA tensor launches the
    kernel or raises. Both instances write an empty group's dw and report
    as zeros."""
    p = plan_k8_call(x, g, bm, tiles, ft)
    ft_on, level, _ = _check_ft(ft, p.tiles, "tgmm")
    if x.device.type == "cpu":
        return tgmm_plain(x, g, row_end, tiles=p.tiles, chunk=p.chunk, ft=ft,
                          inj=inj, inj_mag=inj_mag, rng=rng)
    if x.device.type != "cuda":
        raise ValueError(f"tgmm: unsupported device {x.device}")
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
    if p.instance == "plain":
        raise ValueError(f"tgmm: tiles {p.tiles} are not compiled for "
                         f"{x.dtype}")
    if g.device != x.device or row_end.device != x.device or \
            row_end.dtype != torch.int32 or not row_end.is_contiguous():
        raise ValueError("tgmm: operands on one device, row_end contiguous "
                         "int32")
    if max(x.stride() + g.stride()) >= 2 ** 31:
        raise ValueError("tgmm: strides exceed int32")
    ng = row_end.shape[0]
    _, bn, bk = p.tiles
    gk, gn = cdiv(k, bk), cdiv(n, bn)
    out = torch.empty(ng, k, n, dtype=torch.float32, device=x.device)
    rep = (torch.empty(ng, gk, gn, REPORT_WIDTH, dtype=torch.float32,
                       device=x.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else _NO_INJ
    tail = (int(ft_on and ft.verify == "step"), int(ft_on and ft.corrects),
            ft.rel_tau * F32EPS if ft_on else 0.0, *inj, float(inj_mag),
            *seu_args(rng, ft, seu.SALT_TGMM),
            torch.cuda.current_stream(x.device).cuda_stream)
    if p.instance == "sm90":
        TGMM_SM90(x.data_ptr(), g.data_ptr(), row_end.data_ptr(),
                  out.data_ptr(), None if rep is None else rep.data_ptr(),
                  t_buf, k, n, ng, x.stride(0), g.stride(0),
                  SM90_LEVELS[level], *tail)
        return out, rep
    TGMM_SIMT(x.data_ptr(), g.data_ptr(), row_end.data_ptr(), out.data_ptr(),
              None if rep is None else rep.data_ptr(),
              t_buf, k, n, ng, x.stride(0), x.stride(1), g.stride(0),
              g.stride(1), DTYPE_CODES[x.dtype], int(ft_on),
              LEVELS.get(level, 0), bm, *tail)
    return out, rep
