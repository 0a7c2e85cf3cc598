"""Minimal ABFT telemetry (counterpart of `repro.core.telemetry`): an
ambient `ft_scope` collects per-site (detected, corrected, max residual)
summaries from every protected call.

Records are kept as device tensors and reduced only when `totals` or
`site_totals` is read, so recording adds no host synchronisation to the
serving loop; `report` reduces them on the device into an `FTReport`, the
per-step FT metrics of the train step. `muted` suppresses recording, for
the recompute of an activation checkpoint (each protected call is counted
once, in the forward). The reference's site matrices and storm detector are
not part of this package.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch


class FTReport(NamedTuple):
    """Step totals of the FT counters (device scalars, f32): detections,
    corrections and the largest residual."""
    detected: torch.Tensor
    corrected: torch.Tensor
    max_residual: torch.Tensor


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

    def sites(self) -> set:
        """The site labels recorded so far."""
        return {site for site, _, _, _ in self._items}

    def extend(self, other: "FTScope") -> None:
        """Append every record of ``other`` (a nested scope) to this one."""
        self._items.extend(other._items)

    def report(self, device=None) -> FTReport:
        """The totals as an `FTReport` of device scalars, reduced on the
        device (no host synchronisation)."""
        dev = (self._items[0][1].device if self._items
               else torch.device(device or "cpu"))
        det = torch.zeros((), device=dev)
        cor = torch.zeros((), device=dev)
        mr = torch.zeros((), device=dev)
        for _, d, corr, m in self._items:
            det = det + d.float()
            if corr:
                cor = cor + d.float()
            mr = torch.maximum(mr, m.float())
        return FTReport(det, cor, mr)

    def __len__(self) -> int:
        return len(self._items)


def reduce_microbatch(reports: Sequence[FTReport]) -> FTReport:
    """Collapse the reports of a step's microbatches: the counters SUM
    (they are event counts, not rates) and the residuals take the max."""
    return FTReport(
        detected=torch.stack([r.detected for r in reports]).sum(0),
        corrected=torch.stack([r.corrected for r in reports]).sum(0),
        max_residual=torch.stack([r.max_residual for r in reports]).amax(0))


_SCOPES: List[Optional[FTScope]] = []


def current_scope() -> Optional[FTScope]:
    return _SCOPES[-1] if _SCOPES else None


@contextlib.contextmanager
def muted() -> Iterator[None]:
    """Record nothing inside: the ambient scope is hidden until exit."""
    _SCOPES.append(None)
    try:
        yield
    finally:
        _SCOPES.pop()


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
