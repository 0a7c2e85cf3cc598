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
    report row; aux-operand epilogues are not supported, aux-free chains
    (activations) are.

    ``grouped``: A is a (t_buf, K) group-sorted buffer and B (G, K, N) one
    matrix per group, each row tile multiplied by its group's B (K7), with
    the same aux-free chains. ``tgmm``: dw[g] = X_gᵀ·G_g over two buffers
    of one layout (K8), epilogue-free (it produces a gradient)."""
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
        if self.tgmm and self.epilogue:
            raise ValueError(f"the tgmm variant is epilogue-free, got "
                             f"{self.epilogue}")


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
#: K7's compiled SIMT (bm, bn, bk) tiles (`grouped_gemm.GROUPED_TILES`)
#: and their "tile"-level band: the rows one of the CTA's 8 warps owns, 2
#: of the bf16 16-row tile, 1 of the f32 8-row one (K1's thread layout).
GROUPED_BANDS = {(8, 128, 32): 1, (16, 128, 32): 2}
#: K8's compiled SIMT (bm, bn, bk) tiles (`grouped_gemm.TGMM_TILES`) and
#: their band of dw's K rows: the 8 of the 64-row dw block one warp owns.
TGMM_BANDS = {(8, 64, 64): 8, (16, 64, 64): 8}
#: K1's tensor-core (bm, bn, bk) tiles (csrc/ft_gemm_sm90.cuh), K7's (bm
#: the layout's row tile, bk the k-step; csrc/grouped_sm90.cu) and K8's
#: (bm the layout's row tile, (bk, bn) the dw block), and their
#: "tile"-level band: the 16 rows one warp owns in the wgmma fragment (8
#: bands at bm 128, 4 at 64; K7's a layout tile of its 64-row chunk; K8's
#: 16 dw rows, 8 bands of its 128-row block).
SM90_TILES = ((128, 128, 256), (64, 128, 256))
SM90_GROUPED_TILES = (16, 128, 256)
SM90_TGMM_TILES = (16, 128, 128)
SM90_BAND = 16
#: The reference's band (its 128-row MXU edge), taken at any other tiles:
#: the CPU tests run the plain version at the reference's tiles.
REFERENCE_BAND = 128


def band_of(tiles: Sequence[int], kernel: str = "gemm") -> int:
    """The "tile"-level band at ``tiles`` of a ``kernel`` ("gemm": K1 and
    K5, rows of C; "grouped": K7, rows of the buffer; "tgmm": K8, rows of
    dw, so of bk): the kernel's for compiled tiles (SIMT and tensor-core),
    the reference's otherwise."""
    tiles = tuple(tiles)
    if kernel == "gemm":
        table = dict(zip(TILES + BATCHED_SM90_TILES + SM90_TILES,
                         BANDS + (BATCHED_SM90_BAND,)
                         + (SM90_BAND,) * len(SM90_TILES)))
    elif kernel == "grouped":
        table = {**GROUPED_BANDS, SM90_GROUPED_TILES: SM90_BAND}
    else:
        table = {**TGMM_BANDS, SM90_TGMM_TILES: SM90_BAND}
    return table.get(tiles, REFERENCE_BAND)


def validate(spec: KernelSpec, tiles: Sequence[int],
             kernel: str = "gemm") -> None:
    """Static legality of a launch (the reference's `registry.validate`).
    Ragged edges are masked by bounds, so the operands need not divide the
    tiles; the "tile" level's per-band checksums slice the block in bands
    of `band_of(tiles, kernel)` rows, so bm (bk for K8) must be a multiple
    of it."""
    edge = tiles[2] if kernel == "tgmm" else tiles[0]
    band = band_of(tiles, kernel)
    if spec.ft_level == "tile" and edge % band != 0:
        raise ValueError(f"FT level 'tile' needs a block edge that the band "
                         f"divides, got {edge} for band {band} ({kernel})")


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
