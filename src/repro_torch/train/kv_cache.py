"""Paged KV cache of the serving engine (counterpart of
`repro.train.kv_cache`).

The pool holds ``n_pages`` fixed-size pages per layer, shaped
``(n_layers, n_pages, n_kv_heads, page_size, head_dim)``: one page is one
streamed kv block of the paged decode kernel K6
(`kernels.flashft.flash_ft_decode`, `csrc/flash_decode.cu`), which reads
each slot's pages through the page table. A host-side `PageAllocator`
(numpy) owns the page table and the per-slot lengths; the engine copies
them to the device every step. Page 0 is the reserved null (trash) page:
it is never allocated, unallocated table entries and every entry of a dead
slot point at it, so the scatters of dead slots land there harmlessly.

Differences from the reference, each deliberate:
  * the device-side ops update the pools in place (`write_prefill`,
    `append_layer`, `append_token`) and return them, where the reference
    returns new arrays;
  * the default page edge is K6's compiled page of 64 tokens
    (`DEFAULT_PAGE`), where the reference asks its TPU autotuner; the
    reference's clamp to the dtype's sublane and to ``max_len`` stays, and
    a clamped default that K6 does not compile is rounded up to the next
    page it does (`DECODE_PAGES`). An explicit page is kept as the
    reference keeps it; `check_decode_page` rejects one that K6 cannot
    run before the engine serves anything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flashft import DECODE_PAGES, sublane

#: The reserved trash page: never allocated, never read by a live slot.
NULL_PAGE = 0
#: Default page edge: K6's largest compiled page.
DEFAULT_PAGE = DECODE_PAGES[-1]


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Resolved paged-cache geometry for one (model, engine) config."""
    page_size: int       # tokens per page (the decode kernel's kv block)
    max_pages: int       # page-table width = pages per slot at max_len
    n_pages: int         # pool size INCLUDING the reserved null page
    n_slots: int
    max_len: int

    def hbm_bytes_per_slot(self, cfg, dtype_bytes: int = 2) -> int:
        """K+V pool bytes per slot at full occupancy (excludes the shared
        null page)."""
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
            * dtype_bytes
        usable = (self.n_pages - 1) * self.page_size
        return per_tok * usable // max(self.n_slots, 1)

    def dense_hbm_bytes_per_slot(self, cfg, dtype_bytes: int = 2) -> int:
        """The slot-based dense baseline: max_len tokens per slot, always."""
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
            * dtype_bytes
        return per_tok * self.max_len


def plan_pages(*, n_slots: int, max_len: int, dtype=torch.bfloat16,
               page_size: Optional[int] = None,
               slack: float = 1.0) -> PagePlan:
    """The paged-cache geometry. The page edge defaults to
    `DEFAULT_PAGE` and is clamped, as in the reference, to a multiple of
    the dtype's sublane no larger than ``max_len`` rounded up to it; a
    clamped default outside K6's `DECODE_PAGES` is rounded up to the next
    compiled page. ``slack`` scales the pool (1.0 = every slot can reach
    max_len). The reference also takes the model config and FT policy, for
    its autotuner's page choice; the port has no autotuner yet."""
    sub = sublane(dtype)
    default = page_size is None
    page_size = DEFAULT_PAGE if default else page_size
    page_size = max(sub, min(page_size, -(-max_len // sub) * sub))
    if default and page_size not in DECODE_PAGES:
        page_size = min(p for p in DECODE_PAGES if p >= page_size)
    if page_size % sub != 0:
        raise ValueError(f"page size {page_size} is not a multiple of the "
                         f"sublane {sub}")
    max_pages = -(-max_len // page_size)
    n_pages = 1 + max(max_pages, int(round(n_slots * max_pages * slack)))
    return PagePlan(page_size=page_size, max_pages=max_pages,
                    n_pages=n_pages, n_slots=n_slots, max_len=max_len)


def check_decode_page(page_size: int) -> None:
    """Raise unless K6 compiles pages of ``page_size`` tokens: the engine
    calls this before any prefill when its decode steps will launch K6."""
    if page_size not in DECODE_PAGES:
        raise ValueError(f"page size {page_size}: the paged decode kernel K6 "
                         f"runs pages of {DECODE_PAGES} tokens only")


# ---------------------------------------------------------------------------
# host-side allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator over the shared pool (host-side numpy).

    It owns the page table and per-slot lengths; the engine copies them to
    the device each step. Slots are claimed lowest first and pages are
    handed out lowest id first, freed pages going back on top of the free
    list, as in the reference."""

    def __init__(self, n_pages: int, n_slots: int, max_pages: int,
                 page_size: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the reserved null "
                             f"page), got {n_pages}")
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.page_size = page_size
        # pop() hands out low page ids first
        self._free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self.page_table = np.full((n_slots, max_pages), NULL_PAGE, np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.n_alloc = np.zeros((n_slots,), np.int32)   # pages per slot
        self.live = np.zeros((n_slots,), bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_for(self, length: int) -> int:
        return -(-int(length) // self.page_size)

    def free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(~self.live)]

    def can_admit(self, length: int) -> bool:
        return (bool((~self.live).any())
                and self.pages_for(length) + 1 <= self.n_free)

    def live_pages(self) -> Dict[int, List[int]]:
        return {int(s): self.page_table[s, :self.n_alloc[s]].tolist()
                for s in np.flatnonzero(self.live)}

    def alloc_slot(self, length: int) -> Tuple[int, List[int]]:
        """Claim the lowest free slot and allocate pages for ``length``
        tokens. Returns (slot, pages)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        need = self.pages_for(length)
        if need > self.max_pages:
            raise ValueError(f"length {length} needs {need} pages > "
                             f"max_pages {self.max_pages}")
        if need > self.n_free:
            raise RuntimeError(f"pool exhausted: need {need} pages, "
                               f"{self.n_free} free")
        self.live[slot] = True
        self.lengths[slot] = 0
        self.ensure(slot, length)
        return slot, self.page_table[slot, :need].tolist()

    def ensure(self, slot: int, new_length: int) -> List[int]:
        """Grow ``slot`` to hold ``new_length`` tokens, allocating pages as
        needed. Returns the newly allocated pages (possibly empty)."""
        if not self.live[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        need = self.pages_for(new_length)
        if need > self.max_pages:
            raise ValueError(f"length {new_length} needs {need} pages > "
                             f"max_pages {self.max_pages}")
        new: List[int] = []
        while self.n_alloc[slot] < need:
            if not self._free:
                raise RuntimeError("page pool exhausted")
            page = self._free.pop()
            self.page_table[slot, self.n_alloc[slot]] = page
            self.n_alloc[slot] += 1
            new.append(page)
        self.lengths[slot] = new_length
        return new

    def free_slot(self, slot: int) -> List[int]:
        """Return a finished slot's pages to the free list; its table row
        reverts to all-NULL so later dead-slot scatters hit the trash
        page."""
        if not self.live[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        pages = self.page_table[slot, :self.n_alloc[slot]].tolist()
        self._free.extend(pages)
        self.page_table[slot] = NULL_PAGE
        self.lengths[slot] = 0
        self.n_alloc[slot] = 0
        self.live[slot] = False
        return pages

    def check_invariants(self) -> None:
        """Raise AssertionError on any broken allocator invariant."""
        free = self._free
        assert NULL_PAGE not in free, "null page entered the free list"
        assert len(set(free)) == len(free), "duplicate page in free list"
        owned: Dict[int, int] = {}
        for slot, pages in self.live_pages().items():
            assert len(pages) == self.n_alloc[slot]
            assert self.pages_for(self.lengths[slot]) <= len(pages)
            for pg in pages:
                assert pg != NULL_PAGE, f"slot {slot} owns the null page"
                assert pg not in owned, \
                    f"page {pg} aliased by slots {owned[pg]} and {slot}"
                owned[pg] = slot
        overlap = set(owned) & set(free)
        assert not overlap, f"pages both live and free: {sorted(overlap)}"
        # conservation: every non-null page is either live or free
        assert len(owned) + len(free) == self.n_pages - 1, \
            (len(owned), len(free), self.n_pages)
        for s in np.flatnonzero(~self.live):
            assert (self.page_table[s] == NULL_PAGE).all(), \
                f"dead slot {int(s)} holds table entries"
            assert self.lengths[s] == 0 and self.n_alloc[s] == 0

    def snapshot(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device copies (int32) of (page_table, lengths)."""
        return (torch.as_tensor(self.page_table, device=device),
                torch.as_tensor(self.lengths, device=device))


# ---------------------------------------------------------------------------
# device-side cache ops
# ---------------------------------------------------------------------------

def init_paged_cache(n_layers: int, n_pages: int, n_slots: int,
                     max_pages: int, n_kv_heads: int, page_size: int,
                     head_dim: int, dtype=torch.bfloat16, device="cuda"
                     ) -> Dict[str, Any]:
    """A zeroed paged cache: pools (n_layers, n_pages, n_kv_heads,
    page_size, head_dim), an all-NULL int32 page table and zero lengths."""
    kv = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
    return {
        "k_pages": torch.zeros(kv, dtype=dtype, device=device),
        "v_pages": torch.zeros(kv, dtype=dtype, device=device),
        "page_table": torch.full((n_slots, max_pages), NULL_PAGE,
                                 dtype=torch.int32, device=device),
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


def write_prefill(cache: Dict[str, Any], slot: int, table_row: torch.Tensor,
                  ks: torch.Tensor, vs: torch.Tensor, length: int
                  ) -> Dict[str, Any]:
    """Scatter one slot's prefill KV into its pages, in place.

    table_row int[max_pages]: the slot's allocator row, NULL-padded (unused
    entries write zero padding into the trash page, as the reference does);
    ks, vs (n_layers, S, n_kv_heads, head_dim) with S <= max_pages·page.
    Also records the row and ``length`` for the slot."""
    page = cache["k_pages"].shape[3]
    mp = table_row.shape[0]
    n_l, s, kvh, dh = ks.shape
    cap = mp * page
    if s > cap:
        raise ValueError(f"prefill of {s} tokens exceeds the slot's "
                         f"{mp} pages of {page}")
    idx = table_row.to(device=cache["k_pages"].device, dtype=torch.long)

    def place(pages, x):
        xp = F.pad(x.to(pages.dtype), (0, 0, 0, 0, 0, cap - s))
        # (L, MP, page, KVH, dh) → (L, MP, KVH, page, dh), the pool's layout
        pages[:, idx] = xp.reshape(n_l, mp, page, kvh, dh).transpose(2, 3)

    place(cache["k_pages"], ks)
    place(cache["v_pages"], vs)
    cache["page_table"][slot] = idx.to(torch.int32)
    cache["length"][slot] = length
    return cache


def append_layer(pages: torch.Tensor, kv_new: torch.Tensor,
                 table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one token's K (or V) for every slot into ONE layer's pool, in
    place. pages (P, KVH, page, dh); kv_new (B, KVH, dh); table (B, MP);
    pos int (B,): the target position (the slot's current length). Dead
    slots (all-NULL rows) scatter into the trash page."""
    page = pages.shape[2]
    mp = table.shape[1]
    pos = pos.long()
    pidx = torch.clamp_max(pos // page, mp - 1)
    rows = torch.arange(table.shape[0], device=table.device)
    target = table[rows, pidx].long()                      # (B,)
    # advanced indices on dims 0 (page id) and 2 (in-page offset) around the
    # kv-head slice: the value carries (B, KVH, dh)
    pages[target, :, pos % page] = kv_new.to(pages.dtype)
    return pages


def append_token(cache: Dict[str, Any], k_new: torch.Tensor,
                 v_new: torch.Tensor) -> Dict[str, Any]:
    """Append one token per slot across all layers, in place. k_new, v_new
    (n_layers, B, n_kv_heads, head_dim), written at each slot's current
    ``length``; lengths advance by one."""
    table, pos = cache["page_table"], cache["length"]
    for i in range(cache["k_pages"].shape[0]):
        append_layer(cache["k_pages"][i], k_new[i], table, pos)
        append_layer(cache["v_pages"][i], v_new[i], table, pos)
    cache["length"] = pos + 1
    return cache


def gather_layer(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense (B, max_pages·page, KVH, dh) copy of ONE layer's pool through
    the page table (NULL entries read the trash page: positions past a
    slot's length are garbage and must stay masked by its length)."""
    g = pages[table.long()]                  # (B, MP, KVH, page, dh)
    b, mp, kvh, page, dh = g.shape
    return g.transpose(2, 3).reshape(b, mp * page, kvh, dh)


def gather_dense(cache: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (n_layers, B, S_max, KVH, dh) K and V: the layout the dense
    `models.blocks.decode_attention` reads."""
    table = cache["page_table"]
    return (torch.stack([gather_layer(p, table) for p in cache["k_pages"]]),
            torch.stack([gather_layer(p, table) for p in cache["v_pages"]]))
