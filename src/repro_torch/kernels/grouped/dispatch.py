"""Dispatch of the grouped FT-GEMMs (counterpart of
`repro.kernels.grouped.dispatch`, grouped and tgmm parts):

  * `grouped_buffer_call` — the ragged grouped GEMM K7 over a prepared
    group-sorted buffer: per-group B, per-group checksums, no capacity
    padding (executed rows exceed the true rows by at most G·(bm-1));
  * `grouped_matmul_rows` — layout, scatter, call and gather in one step;
  * `tgmm_buffer_call` / `tgmm_matmul_rows` — the grouped transpose GEMM K8,
    dw[g] = X_gᵀ·G_g, the MoE backward dw (both K8 instances write the dw
    and report blocks of empty groups as zeros: no pass over dw here).

The reference's uniform batched branch is `kernels.ops.grouped_gemm_call`'s
rank-3 path here. Tiles: the reference autotunes them; the port has no
autotuner, so `plan_grouped` and `plan_tgmm` keep the reference's row-tile
formula (bm fitted to the average group and capped so the G·(bm-1)
alignment rows stay within a quarter of the true rows), with the
autotuner's tile replaced by the largest compiled row tile, and then take
the smallest compiled row tile at or above it (`grouped_gemm.row_tiles`:
16 in bf16, 8 or 16 in f32). A row tile that the kernels do not compile
raises on the card. Which instance of K7 and K8 runs a call (tensor cores
or SIMT), at which tiles and chunk, is `grouped_gemm.plan_k7` / `plan_k8`'s
rule; the layout is the same for both.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ...core.policy import FTConfig, InjectionSpec
from .. import grouped_gemm as kgg
from ..flashft import encode_rng, sublane
from ..ops import _resolve, encode_injection
from ..templates import BatchedKernelSpec
from . import layout as layout_mod

Tiles = Optional[Sequence[int]]


def fit_tile(dim: int, max_tile: int, align: int) -> int:
    """Among multiples of ``align`` up to ``max_tile``, the edge that
    minimises ceil(dim / c)·c, ties to the larger (the reference's
    `search.fit_tile`)."""
    best = None
    for c in range(align, max_tile + 1, align):
        key = (math.ceil(dim / c) * c, -c)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def _plan_bm(t_rows: int, n_groups: int, dtype) -> int:
    compiled = kgg.row_tiles(dtype)
    if not compiled:
        raise TypeError(f"the grouped kernels take float32 or bfloat16, got "
                        f"{dtype}")
    align = sublane(dtype)
    g = max(n_groups, 1)
    avg = max(1, t_rows // g)
    cap = ((t_rows // (4 * g) + 1) // align) * align
    bm_max = max(align, min(compiled[-1], cap))
    bm = fit_tile(min(avg, bm_max), bm_max, align)
    return min((t for t in compiled if t >= bm), default=compiled[-1])


def plan_grouped(t_rows: int, n: int, k: int, dtype, *, n_groups: int
                 ) -> Tuple[int, int, int]:
    """K7's (bm, bn, bk) for a grouped launch over ``t_rows`` true rows
    (see the module docstring for bm)."""
    bm = _plan_bm(t_rows, n_groups, dtype)
    return kgg._tiles_for(kgg.GROUPED_TILES, dtype, bm, "plan_grouped")


def plan_tgmm(t_rows: int, n: int, k: int, dtype, *, n_groups: int,
              bm: Optional[int] = None) -> Tuple[int, int, int]:
    """K8's (bm, bn, bk): the row-tile rule of `plan_grouped`, or ``bm``
    pinned (the backward: the forward layout's row tile is a fact of the
    buffer)."""
    bm = _plan_bm(t_rows, n_groups, dtype) if bm is None else bm
    return kgg._tiles_for(kgg.TGMM_TILES, dtype, bm, "plan_tgmm")


def _metadata(lay, gid, row_end, t_buf: int):
    if lay is not None:
        if lay.t_buf != t_buf:
            raise ValueError(f"buffer of {t_buf} rows for a layout of "
                             f"{lay.t_buf}")
        gid, row_end = lay.gid, lay.row_end
    if gid is None or row_end is None:
        raise ValueError("grouped dispatch needs a layout or (gid, row_end)")
    if t_buf % gid.shape[0] != 0:
        raise ValueError(f"{t_buf} buffer rows over {gid.shape[0]} tiles")
    return gid, row_end, t_buf // gid.shape[0]


def grouped_buffer_call(spec: BatchedKernelSpec, buf: torch.Tensor,
                        w: torch.Tensor,
                        lay: Optional[layout_mod.GroupLayout] = None, *,
                        gid: Optional[torch.Tensor] = None,
                        row_end: Optional[torch.Tensor] = None,
                        tiles: Tiles = None,
                        ft: Optional[FTConfig] = None,
                        inject: Optional[InjectionSpec] = None,
                        out_dtype=None, key=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grouped GEMM over a prepared buffer: buf (t_buf, K) group-sorted
    (`layout.scatter_rows`), w (G, K, N) (any strides: a transposed view is
    read in place); ``spec.epilogue``, an aux-free chain, is applied to
    y_buf in the kernel. The group metadata comes from a `GroupLayout` or the
    raw (``gid``, ``row_end``). Returns (y_buf (t_buf, N), report|None),
    the report (t_buf/bm, gn, 8) — one row per row tile, so per-group
    blocks. The injection keeps the 2-D layout, rows in buffer
    coordinates; ``key`` arms a stochastic campaign at ``ft.inject_rate``
    (`flashft.encode_rng`)."""
    ft = _resolve(spec, ft)
    rng = encode_rng(key, ft) if spec.ft else None
    if out_dtype is not None and out_dtype != buf.dtype:
        raise NotImplementedError("the grouped kernel writes y in the operand "
                                  "dtype")
    gid, row_end, bm = _metadata(lay, gid, row_end, buf.shape[0])
    if w.dim() != 3 or w.shape[1] != buf.shape[1] or \
            w.shape[0] != row_end.shape[0]:
        raise ValueError(f"grouped_buffer_call: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}, {row_end.shape[0]} groups")
    inj, mag = encode_injection(inject)
    return kgg.ft_gemm_grouped(buf, w, gid, row_end, chain=spec.epilogue,
                               ft=ft if spec.ft else None, inj=inj,
                               inj_mag=mag, tiles=tiles, rng=rng)


def grouped_matmul_rows(spec: BatchedKernelSpec, x: torch.Tensor,
                        w: torch.Tensor, group_ids: torch.Tensor, *,
                        ft: Optional[FTConfig] = None,
                        inject: Optional[InjectionSpec] = None,
                        tiles: Tiles = None, out_dtype=None, key=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row-space grouped GEMM: y[r] = x[r] @ w[group_ids[r]] for any group
    sizes (empty and ragged-last included), zero capacity padding."""
    t, k = x.shape
    ng, _, n = w.shape
    tiles = tiles or plan_grouped(t, n, k, x.dtype, n_groups=ng)
    lay = layout_mod.make_layout(group_ids, ng, tiles[0])
    y_buf, rep = grouped_buffer_call(
        spec, layout_mod.scatter_rows(x, lay), w, lay, tiles=tiles, ft=ft,
        inject=inject, out_dtype=out_dtype, key=key)
    return layout_mod.gather_rows(y_buf, lay), rep


def group_counts_from_metadata(row_end: torch.Tensor, bm: int
                               ) -> torch.Tensor:
    """Per-group live-row counts from (row_end, bm) alone: group g starts at
    row_end[g-1] rounded up to bm."""
    prev = torch.nn.functional.pad(row_end[:-1], (1, 0))
    return row_end - (prev + bm - 1) // bm * bm


def tgmm_buffer_call(spec: BatchedKernelSpec, buf: torch.Tensor,
                     gbuf: torch.Tensor,
                     lay: Optional[layout_mod.GroupLayout] = None, *,
                     gid: Optional[torch.Tensor] = None,
                     row_end: Optional[torch.Tensor] = None,
                     n_groups: Optional[int] = None,
                     tiles: Tiles = None,
                     ft: Optional[FTConfig] = None,
                     inject: Optional[InjectionSpec] = None,
                     out_dtype=None, key=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grouped transpose GEMM over prepared buffers: dw[g] = buf_gᵀ·gbuf_g
    with buf (t_buf, K) and gbuf (t_buf, N) group-sorted under one layout.
    Returns (dw (G, K, N) f32 unless ``out_dtype``, report|None), the
    report (G, gk, gn, 8). The kernel writes the dw and report blocks of
    empty groups as zeros (no row was routed there) and masks the rows
    between row_end[g] and the next group's base. The injection's row and
    col index dw and its k_step is the buffer's row tile."""
    ft = _resolve(spec, ft)
    rng = encode_rng(key, ft) if spec.ft else None
    gid, row_end, bm = _metadata(lay, gid, row_end, buf.shape[0])
    ng = n_groups if n_groups is not None else row_end.shape[0]
    if gbuf.shape[0] != buf.shape[0] or ng != row_end.shape[0]:
        raise ValueError(f"tgmm_buffer_call: buf {tuple(buf.shape)}, gbuf "
                         f"{tuple(gbuf.shape)}, {row_end.shape[0]} groups")
    inj, mag = encode_injection(inject)
    dw, rep = kgg.tgmm(buf, gbuf, row_end, bm=bm,
                       ft=ft if spec.ft else None, inj=inj, inj_mag=mag,
                       tiles=tiles, rng=rng)
    if out_dtype is not None:
        dw = dw.to(out_dtype)
    return dw, rep


def tgmm_matmul_rows(spec: BatchedKernelSpec, x: torch.Tensor,
                     g: torch.Tensor, group_ids: torch.Tensor, *,
                     n_groups: int, ft: Optional[FTConfig] = None,
                     inject: Optional[InjectionSpec] = None,
                     tiles: Tiles = None, out_dtype=None, key=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row-space grouped transpose GEMM: dw[e] = Σ_{r: group_ids[r]=e}
    x[r] ⊗ g[r] for any group sizes, through one buffer pair."""
    t, k = x.shape
    if g.shape[0] != t or group_ids.shape != (t,):
        raise ValueError(f"tgmm_matmul_rows: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, group_ids "
                         f"{tuple(group_ids.shape)}")
    tiles = tiles or plan_tgmm(t, g.shape[1], k, x.dtype, n_groups=n_groups)
    lay = layout_mod.make_layout(group_ids, n_groups, tiles[0])
    return tgmm_buffer_call(spec, layout_mod.scatter_rows(x, lay),
                            layout_mod.scatter_rows(g, lay), lay, tiles=tiles,
                            ft=ft, inject=inject, out_dtype=out_dtype,
                            key=key)
