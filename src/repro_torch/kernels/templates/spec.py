"""`KernelSpec` — one GEMM kernel variant (counterpart of
`repro.kernels.templates.spec`): FT level × epilogue chain. The kernel
accumulates in f32 and writes C in the operand dtype, and masks ragged
edges by bounds, so the reference's acc/out dtype and masked fields have
no counterpart here. `BatchedKernelSpec` adds the leading batch axis, or
with ``grouped`` the ragged grouped GEMM over a group-sorted buffer (K7),
or with ``tgmm`` the grouped transpose GEMM of the MoE backward dw (K8)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from . import epilogues

FT_LEVELS = ("off", "inner", "tile", "block")

#: Derived kernel outputs. "act_grad": the derivative of the chain's single
#: nonlinear op at the pre-activation, written from the verified, corrected
#: accumulator, so the backward consumes a saved residual instead of
#: recomputing the pre-activation GEMM.
EXTRA_OUTPUTS = ("act_grad",)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    ft_level: str = "off"
    epilogue: Tuple[str, ...] = ()
    extra_outputs: Tuple[str, ...] = ()

    batched = False

    def __post_init__(self):
        if self.ft_level not in FT_LEVELS:
            raise ValueError(f"ft_level must be one of {FT_LEVELS}, "
                             f"got {self.ft_level!r}")
        object.__setattr__(self, "epilogue", tuple(self.epilogue))
        seen_aux = set()
        for name in self.epilogue:
            op = epilogues.get(name)            # raises on unknown ops
            if op.aux is not None:
                if op.aux in seen_aux:
                    raise ValueError(f"chain {self.epilogue} streams two "
                                     f"'{op.aux}' aux operands")
                seen_aux.add(op.aux)
        object.__setattr__(self, "extra_outputs", tuple(self.extra_outputs))
        for name in self.extra_outputs:
            if name not in EXTRA_OUTPUTS:
                raise ValueError(f"unknown extra output {name!r}; "
                                 f"registered: {EXTRA_OUTPUTS}")
        if "act_grad" in self.extra_outputs:
            nonlin = [n for n in self.epilogue
                      if not epilogues.get(n).linear]
            if len(nonlin) != 1:
                raise ValueError(
                    "act_grad needs exactly one nonlinear op in the chain "
                    f"(the saved act'(preact) residual), got {self.epilogue}")
            if epilogues.get(nonlin[0]).grad is None:
                raise ValueError(f"epilogue '{nonlin[0]}' has no registered "
                                 f"derivative, so act_grad cannot be written")

    @property
    def ft(self) -> bool:
        return self.ft_level != "off"

    @property
    def needs_bias(self) -> bool:
        return any(epilogues.get(n).aux == "vector" for n in self.epilogue)

    @property
    def needs_residual(self) -> bool:
        return any(epilogues.get(n).aux == "tile" for n in self.epilogue)

    def fold_split(self) -> int:
        """Index splitting the chain into the linear prefix (folded into the
        final checksum comparison) and the suffix applied after
        verification (everything from the first nonlinear op on)."""
        return epilogues.fold_split(self.epilogue)


@dataclasses.dataclass(frozen=True)
class BatchedKernelSpec(KernelSpec):
    """Uniform batched variant: A (B, M, K) × B (B, K, N), or a shared
    (K, N) right operand. Every output block keeps its own checksums and
    report row; aux-operand epilogues are not supported.

    ``grouped``: A is a (t_buf, K) group-sorted buffer and B (G, K, N) one
    matrix per group, each row tile multiplied by its group's B (K7).
    ``tgmm``: dw[g] = X_gᵀ·G_g over two buffers of one layout (K8). Both
    are epilogue-free."""
    grouped: bool = False
    tgmm: bool = False

    batched = True

    def __post_init__(self):
        super().__post_init__()
        if self.needs_bias or self.needs_residual:
            raise ValueError("batched variants support aux-free epilogue "
                             f"chains only, got {self.epilogue}")
        if self.grouped and self.tgmm:
            raise ValueError("tgmm is its own body, not grouped=True")
        if (self.grouped or self.tgmm) and self.epilogue:
            raise ValueError(f"the grouped and tgmm variants are "
                             f"epilogue-free, got {self.epilogue}")


#: Compiled K1/K5 (bm, bn, bk) tile configurations, in the order of
#: `launch_tiles` in csrc/ft_gemm.cu (re-exported by `kernels.ft_gemm`).
TILES = ((64, 64, 32), (16, 128, 32))
#: Rows of one "tile"-level checksum band of each compiled tile, in the
#: order of TILES: the rows one of the CTA's 8 warps owns (bm / 8).
BANDS = (8, 2)
#: K5's tensor-core tiles (csrc/batched_sm90.cu): 16 rows, the rows of one
#: m16n8k16 fragment, 32 columns, and the 256-deep k-step.
BATCHED_SM90_TILES = ((16, 32, 256),)
#: Their "tile"-level band: the whole 16-row block (at M <= 16 the
#: reference's 128-row band covers the same rows).
BATCHED_SM90_BAND = 16
#: The reference's band (its 128-row MXU edge), taken at any other tiles:
#: the CPU tests run the plain version at the reference's tiles.
REFERENCE_BAND = 128


def band_of(tiles: Sequence[int]) -> int:
    """The "tile"-level band at ``tiles``: the kernel's for compiled
    tiles, the reference's otherwise."""
    tiles = tuple(tiles)
    if tiles in TILES:
        return BANDS[TILES.index(tiles)]
    if tiles in BATCHED_SM90_TILES:
        return BATCHED_SM90_BAND
    return REFERENCE_BAND


def validate(spec: KernelSpec, tiles: Sequence[int]) -> None:
    """Static legality of a launch (the reference's `registry.validate`).
    Ragged edges are masked by bounds, so the operands need not divide the
    tiles; the "tile" level's per-band checksums slice the block in bands
    of `band_of(tiles)` rows, so bm must be a multiple of it."""
    bm, band = tiles[0], band_of(tiles)
    if spec.ft_level == "tile" and bm % band != 0:
        raise ValueError(f"FT level 'tile' needs bm % band == 0, got "
                         f"bm={bm}, band={band}")


def fused(bias: bool = False, act: Optional[str] = None,
          residual: bool = False, *, ft_level: str = "off") -> KernelSpec:
    """Canonical-order spec: y = act(A·B + bias) + residual."""
    chain = []
    if bias:
        chain.append("bias")
    if act is not None:
        epilogues.get(act)
        chain.append(act)
    if residual:
        chain.append("residual")
    return KernelSpec(ft_level=ft_level, epilogue=tuple(chain))
