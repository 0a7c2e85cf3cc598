"""SEU injection (counterpart of `repro.core.fault_injection`): an offset
added to the GEMM accumulator between compute and verification, where a
compute-unit SDC would land.

  * `inject_spec` — one deterministic SEU (tests, conformance checks);
  * `Injector` — the torch-op path's stochastic SEU: with probability
    ``rate`` one element of a matmul's accumulator is hit;
  * `fold_in` — campaign keys (the reference's `split_for`). A key is a `torch.Generator`;
    a derived key is a new generator whose seed mixes the parent's
    ``initial_seed()`` with a tag by splitmix64, so deriving consumes no
    state: a recompute (remat) derives the same keys and draws the same
    SEUs, and the in-kernel triple (`kernels.flashft.encode_rng`) stays
    three host ints;
  * `check_campaign` — the flash fronts' guard: a campaign raises there
    only if the flash kernels carry no stochastic hook
    (`kernels.flashft.SUPPORTS_STOCHASTIC_INJECTION`, True in this build),
    instead of running clean.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .policy import FTConfig, InjectionSpec

_M64 = 0xFFFFFFFFFFFFFFFF


def splitmix64(x: int) -> int:
    """The splitmix64 output function of state ``x`` (uint64)."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(key: Optional[torch.Generator], tag: int
            ) -> Optional[torch.Generator]:
    """A new key derived from ``key`` and the integer ``tag`` (None passes
    through); ``key``'s state is not touched."""
    if key is None:
        return None
    g = torch.Generator()
    g.manual_seed(splitmix64((key.initial_seed() & _M64)
                             ^ splitmix64(tag & _M64)))
    return g


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


@dataclasses.dataclass(frozen=True)
class Injector:
    """Stochastic SEU source of the torch-op path: with probability
    ``rate`` one element, uniform over the last two dims, of a matmul's
    (…, M, N) accumulator is scaled by 2^bit_shift (+δ·(2^s − 1)), or
    offset by 2^bit_shift where that is at most 1e-6; every leading slice
    at the same (row, col), as the reference's. The hit, row and col are
    drawn on the host from a fresh generator seeded from ``key``, so the
    call reads nothing back from the device."""
    rate: float = 0.0
    bit_shift: int = 8

    def draw(self, key: torch.Generator, m: int, n: int):
        """(hit, row, col) of one call."""
        g = torch.Generator()
        g.manual_seed(splitmix64(key.initial_seed() & _M64))
        u = torch.rand((3,), generator=g, dtype=torch.float64)
        return (bool(u[0] < self.rate), min(int(u[1] * m), m - 1),
                min(int(u[2] * n), n - 1))

    def __call__(self, key: Optional[torch.Generator],
                 c: torch.Tensor) -> torch.Tensor:
        if key is None or self.rate <= 0.0:
            return c
        hit, r, col = self.draw(key, c.shape[-2], c.shape[-1])
        if not hit:
            return c
        from ..kernels.templates import seu
        c = c.clone()
        el = c[..., r, col]
        c[..., r, col] = el + seu.magnitude(el.float(), self.bit_shift
                                            ).to(c.dtype)
        return c


def inject(ft: FTConfig, spec: Optional[InjectionSpec], key,
           c: torch.Tensor) -> torch.Tensor:
    """The torch-op path's SEU on an accumulator: the deterministic
    ``spec`` if given, else the campaign's `Injector` under ``key``."""
    if spec is not None:
        return inject_spec(c, spec)
    if key is not None and ft.inject_rate > 0.0:
        return Injector(ft.inject_rate, ft.inject_bit_shift)(key, c)
    return c


def check_campaign(ft: FTConfig, key) -> None:
    """Raise on a stochastic campaign (``ft.inject_rate > 0`` with a key)
    at a flash front when the flash kernels carry no stochastic hook
    (`kernels.flashft.SUPPORTS_STOCHASTIC_INJECTION` False): a campaign
    must never run clean in silence. `attn_impl="chunked"` routes attention
    through the batched GEMM kernel, which has one."""
    from ..kernels import flashft
    if (key is not None and ft.inject_rate > 0.0
            and not flashft.SUPPORTS_STOCHASTIC_INJECTION):
        raise NotImplementedError(
            f"the flash attention kernels cannot honour the stochastic "
            f"injection key (inject_rate={ft.inject_rate}): their in-kernel "
            f"SEU hook is not ported. Use attn_impl='chunked' for the "
            f"campaign instead of letting the flash path report a clean run")
