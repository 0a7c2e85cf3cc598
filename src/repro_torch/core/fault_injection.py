"""Deterministic SEU injection (counterpart of
`repro.core.fault_injection.inject_spec`): an offset added to the GEMM
accumulator between compute and verification, where a compute-unit SDC
would land. Stochastic campaigns are not part of this package:
`check_campaign` makes a request for one raise instead of running clean."""
from __future__ import annotations

from typing import Optional

import torch

from .policy import FTConfig, InjectionSpec


def inject_spec(c: torch.Tensor, spec: Optional[InjectionSpec]
                ) -> torch.Tensor:
    """Apply a single deterministic SEU to a (…, M, N) accumulator (every
    leading batch slice, like the reference)."""
    if spec is None:
        return c
    rows = torch.arange(c.shape[-2], device=c.device)[:, None]
    cols = torch.arange(c.shape[-1], device=c.device)[None, :]
    hit = (rows == spec.row) & (cols == spec.col)
    return c + torch.where(hit, torch.tensor(spec.magnitude, dtype=c.dtype,
                                             device=c.device),
                           torch.zeros((), dtype=c.dtype, device=c.device))


def check_campaign(ft: FTConfig, key) -> None:
    """Raise on a stochastic SEU campaign request (``ft.inject_rate > 0``
    with a key): neither the kernels nor the torch-op path carry an
    injector yet, and a campaign must never run clean in silence."""
    if key is not None and ft.inject_rate > 0.0:
        raise NotImplementedError(
            f"stochastic SEU injection (inject_rate={ft.inject_rate}) is not "
            f"implemented; refusing to run the campaign clean")
