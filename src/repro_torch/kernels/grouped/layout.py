"""CSR-style group layout of the ragged grouped GEMM (counterpart of
`repro.kernels.grouped.layout`).

The grouped kernels K7 and K8 take a row-sorted token buffer: all rows of
group 0, then group 1, …, each group's region starting on a row-tile
(``bm``) boundary, so that every row tile is wholly one group's. That keeps
the per-block ABFT checksums per group (an SEU in one expert's rows never
reaches a neighbour's) and lets a kernel pick its B from one lookup.

Group sizes are data (routing decides them); the buffer's capacity is the
worst case ``T + G·(bm-1)`` rounded to ``bm``, so it is static. Every tensor
stays on the caller's device: nothing here reads a value back to the host.
`make_layout` builds the metadata; `scatter_rows` / `gather_rows` move rows
between caller order and buffer order.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Metadata of one group-sorted buffer.

    Static: ``n_groups`` (G), ``bm`` (the row tile every group region is
    aligned to), ``t_buf`` (buffer rows, a bm multiple), ``n_rows`` (T, the
    caller's row count). Tensors (int32, on the caller's device):
    ``counts`` (G,) rows per group; ``base`` (G,) each group's aligned first
    buffer row; ``row_end`` (G,) each group's first dead buffer row
    (base + counts); ``gid`` (t_buf/bm,) the owning group of each row tile
    (tiles past the last live row clamp to G-1 and are wholly masked by
    row_end); ``positions`` (T,) the buffer row of each caller row."""
    n_groups: int
    bm: int
    t_buf: int
    n_rows: int
    counts: torch.Tensor
    base: torch.Tensor
    row_end: torch.Tensor
    gid: torch.Tensor
    positions: torch.Tensor

    @property
    def num_tiles(self) -> int:
        return self.t_buf // self.bm


def buffer_rows(n_rows: int, n_groups: int, bm: int) -> int:
    """Worst-case buffer capacity: every group wastes at most bm-1
    alignment rows."""
    return bm * max(1, (n_rows + n_groups * (bm - 1)) // bm)


def make_layout(group_ids: torch.Tensor, n_groups: int, bm: int
                ) -> GroupLayout:
    """group_ids: int (T,), the owning group of each caller row."""
    t = group_ids.shape[0]
    dev = group_ids.device
    gids = group_ids.long()
    t_buf = buffer_rows(t, n_groups, bm)
    counts = torch.bincount(gids, minlength=n_groups)
    aligned = (counts + bm - 1) // bm * bm
    ends = torch.cumsum(aligned, 0)                  # aligned region ends
    base = ends - aligned                            # aligned region starts
    row_end = base + counts
    # Buffer position of each caller row: its group's base plus its rank in
    # the stable group-sorted order.
    order = torch.argsort(gids, stable=True)
    sorted_g = gids[order]
    start_sorted = torch.cumsum(counts, 0) - counts
    pos_sorted = (base[sorted_g] + torch.arange(t, device=dev)
                  - start_sorted[sorted_g])
    positions = torch.empty_like(pos_sorted)
    positions[order] = pos_sorted
    # Owning group per row tile: the aligned region its first row falls in;
    # tiles past the last region clamp to G-1 (their rows are all dead).
    tile_start = torch.arange(t_buf // bm, device=dev) * bm
    gid = torch.searchsorted(ends, tile_start, right=True).clamp(
        0, n_groups - 1)
    i32 = lambda x: x.to(torch.int32)                # noqa: E731
    return GroupLayout(n_groups=n_groups, bm=bm, t_buf=t_buf, n_rows=t,
                       counts=i32(counts), base=i32(base),
                       row_end=i32(row_end), gid=i32(gid),
                       positions=i32(positions))


def scatter_rows(x: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    """(T, K) caller rows → (t_buf, K) group-sorted buffer (dead rows 0)."""
    if x.shape[0] != layout.n_rows:
        raise ValueError(f"scatter_rows: {x.shape[0]} rows for a layout of "
                         f"{layout.n_rows}")
    buf = x.new_zeros((layout.t_buf,) + tuple(x.shape[1:]))
    buf[layout.positions.long()] = x
    return buf


def gather_rows(buf: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    """(t_buf, N) buffer → (T, N) caller rows (drops the dead rows)."""
    return buf[layout.positions.long()]
