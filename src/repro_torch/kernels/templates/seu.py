"""The in-kernel stochastic SEU hook in plain PyTorch (counterpart of
`repro/kernels/templates/emit.py:162-230`: the salts, `_mix32`,
`stochastic_seu` and `apply_seu`; the flash family's salts are
`repro/kernels/flashft.py:96`).

A campaign hands every FT kernel launch one triple ``rng`` = (enable, seed0,
seed1) of int32 (`kernels.flashft.encode_rng`). Each stationary output
block draws, from the triple, a per-kernel salt and its block uid, one
Bernoulli(rate) SEU at a uniform (live step, row, col): a counter-based
splitmix32 hash, so a block's draw is the same on the card
(`csrc/seu_hook.cuh`, the same uint32 arithmetic bit for bit) and in the
plain versions here, whatever order the blocks run in. The hit lands on
the step whose live index equals ``step``, on the element's contribution
δ of that step: δ·(2^bit_shift − 1) is added, or 2^bit_shift where that is
at most 1e-6 in magnitude (`magnitude`).

The arithmetic is exact uint32 on int64 tensors: every product is split so
that no intermediate exceeds 2^49.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

#: Per-kernel salts of the flash family: the forward (K2), dQ (K3), dK/dV
#: (K4) and the paged decode (K6).
SALT_FWD, SALT_DQ, SALT_DKV, SALT_DECODE = 0x51, 0x52, 0x53, 0x54
#: Per-template salts of the GEMM family.
SALT_GEMM2D = 0x55
SALT_BATCHED = 0x56
SALT_TGMM = 0x57

#: The resolution of the draw: u = (h >> 8)·2^-24, so a rate below one
#: quantum cannot be drawn.
RATE_QUANTUM = 2.0 ** -24
#: The largest bit shift whose magnitude 2^s is a finite float32.
MAX_BIT_SHIFT = 127

_M32 = 0xFFFFFFFF


def check(rate: float, bit_shift: int) -> None:
    """Raise for a campaign the kernels cannot draw: a rate outside
    [2^-24, 1] (other than 0) or a bit shift outside [0, 127]."""
    if not (rate == 0.0 or RATE_QUANTUM <= rate <= 1.0):
        raise ValueError(f"inject_rate {rate!r} cannot be drawn by the "
                         f"in-kernel hook: it takes 0 or a rate in "
                         f"[2^-24, 1]")
    if not (isinstance(bit_shift, int) and 0 <= bit_shift <= MAX_BIT_SHIFT):
        raise ValueError(f"inject_bit_shift {bit_shift!r} outside "
                         f"[0, {MAX_BIT_SHIFT}]")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The splitmix32 finalizer on uint32 values held in int64."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _mix32_int(x: int) -> int:
    """`mix32` of one host int (per launch: no tensor, no device)."""
    x &= _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def block_seed(rng: Sequence[int], salt: int) -> int:
    """The uint32 seed of a kernel's stream: seed0 ^ mix32(seed1 +
    salt·0x9E3779B9)."""
    return ((int(rng[1]) & _M32)
            ^ _mix32_int((int(rng[2]) & _M32) + ((salt * 0x9E3779B9) & _M32)))


def draw(rng: Sequence[int], salt: int, uid: torch.Tensor,
         n_live: Union[int, torch.Tensor], bm: int, bn: int, rate: float
         ) -> Tuple[torch.Tensor, ...]:
    """The SEU each block ``uid`` (int tensor, any shape) draws: (hit,
    step, row, col), hit bool and the rest int64, of uid's shape. A block
    with ``n_live`` ≤ 0 live steps, a triple with enable ≠ 1, or rate 0
    never hits; a rate the kernels cannot draw raises (`check`)."""
    check(rate, 0)
    uid = uid.to(torch.int64) & _M32
    n_live = torch.as_tensor(n_live, dtype=torch.int64, device=uid.device)
    h0 = mix32(block_seed(rng, salt) ^ _mul32(uid, 0x85EBCA6B))
    u = (h0 >> 8).to(torch.float32) * RATE_QUANTUM
    rate32 = torch.tensor(rate, dtype=torch.float32, device=uid.device)
    hit = (u < rate32) & (n_live > 0) & (int(rng[0]) == 1)

    def bounded(k: int, n):
        h = mix32((h0 + k) & _M32) & 0x7FFFFFFF
        return h % torch.clamp_min(torch.as_tensor(n, device=uid.device), 1)

    return hit, bounded(1, n_live), bounded(2, bm), bounded(3, bn)


def magnitude(delta: torch.Tensor, bit_shift: int) -> torch.Tensor:
    """The SEU added to an element whose step contribution is ``delta``
    (f32): δ·(2^s − 1), or 2^s where that is at most 1e-6 in magnitude."""
    mag = delta * (2.0 ** bit_shift - 1.0)
    return torch.where(mag.abs() > 1e-6, mag,
                       torch.full_like(mag, 2.0 ** bit_shift))


def land(delta: torch.Tensor, sel: torch.Tensor, rows: torch.Tensor,
         cols: torch.Tensor, bit_shift: int) -> None:
    """Add the SEUs of the blocks ``sel`` (bool, the blocks' shape) to
    ``delta`` (…, R, C) in place, at the blocks' global ``rows`` / ``cols``
    (int64, the blocks' shape), the blocks' leading dims being delta's."""
    idx = torch.nonzero(sel, as_tuple=True)
    if idx[0].numel() == 0:
        return
    at = idx[:delta.dim() - 2] + (rows[idx], cols[idx])
    delta.index_put_(at, magnitude(delta[at], bit_shift), accumulate=True)
