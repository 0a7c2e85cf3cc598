"""Minimal ABFT telemetry (counterpart of `repro.core.telemetry`): an
ambient `ft_scope` collects per-site (detected, corrected, max residual)
summaries from every protected call.

Records are kept as device tensors and reduced only when `totals` or
`site_totals` is read, so recording adds no host synchronisation to the
serving loop. The reference's site matrices and storm detector are not part
of this package.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch


class FTScope:
    """Collector of (site, det_count, corrected, max_residual) records."""

    def __init__(self) -> None:
        self._items: List[Tuple[Optional[str], torch.Tensor, bool,
                                torch.Tensor]] = []

    def record_summary(self, det_count: torch.Tensor,
                       max_residual: torch.Tensor, corrected: bool,
                       site: Optional[str] = None) -> None:
        self._items.append((site, det_count.detach(), bool(corrected),
                            max_residual.detach()))

    def site_totals(self) -> Dict[Optional[str], Dict[str, float]]:
        """{site: {"detected", "corrected", "max_residual"}} over every
        record so far (one host synchronisation)."""
        out: Dict[Optional[str], Dict[str, float]] = {}
        for site, det, corr, mr in self._items:
            d = float(det)
            t = out.setdefault(site, {"detected": 0.0, "corrected": 0.0,
                                      "max_residual": 0.0})
            t["detected"] += d
            t["corrected"] += d if corr else 0.0
            t["max_residual"] = max(t["max_residual"], float(mr))
        return out

    def totals(self) -> Dict[str, float]:
        tot = {"detected": 0.0, "corrected": 0.0, "max_residual": 0.0}
        for t in self.site_totals().values():
            tot["detected"] += t["detected"]
            tot["corrected"] += t["corrected"]
            tot["max_residual"] = max(tot["max_residual"], t["max_residual"])
        return tot

    def __len__(self) -> int:
        return len(self._items)


_SCOPES: List[FTScope] = []


def current_scope() -> Optional[FTScope]:
    return _SCOPES[-1] if _SCOPES else None


@contextlib.contextmanager
def ft_scope() -> Iterator[FTScope]:
    """``with ft_scope() as s: ...; s.totals()``"""
    s = FTScope()
    _SCOPES.append(s)
    try:
        yield s
    finally:
        _SCOPES.pop()


def record_summary(det_count: torch.Tensor, max_residual: torch.Tensor,
                   corrected: bool, site: Optional[str] = None) -> None:
    """Record into the ambient scope, if one is open."""
    s = current_scope()
    if s is not None:
        s.record_summary(det_count, max_residual, corrected, site=site)
