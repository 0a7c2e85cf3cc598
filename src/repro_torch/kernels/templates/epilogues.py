"""Epilogue ops of the fused GEMM (counterpart of
`repro.kernels.templates.epilogues`).

An op is one step of the post-GEMM chain (bias-add, activation,
residual-add). ``apply(y, aux)`` is the math on the f32 accumulator tile;
``linear`` ops in the leading prefix of a chain are folded into the final
checksum comparison by ``fold(colck, rowck, aux, rows)``, so verification
runs post-epilogue; the first nonlinear op ends the foldable prefix.
``grad`` is an elementwise op's derivative, the act_grad output of the
multi-output kernel variant (act'(pre-activation), saved for the backward).
``aux`` names the streamed operand: None, "vector" (a (1, bn) slice of an
N-vector: bias) or "tile" (a (bm, bn) slice of an (M, N) array: residual).
The CUDA kernel (`kernels/csrc/ft_gemm.cu`) inlines the same formulas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@dataclasses.dataclass(frozen=True)
class EpilogueOp:
    name: str
    linear: bool
    apply: Callable            # (y, aux) -> y'
    aux: Optional[str] = None  # None | "vector" | "tile"
    fold: Optional[Callable] = None  # (colck, rowck, aux, rows) -> (colck, rowck)
    grad: Optional[Callable] = None  # y -> act'(y), elementwise ops only

    def __post_init__(self):
        if self.linear and self.fold is None:
            raise ValueError(f"linear epilogue '{self.name}' needs a checksum "
                             f"fold rule")


REGISTRY: Dict[str, EpilogueOp] = {}


def register(op: EpilogueOp) -> EpilogueOp:
    if op.name in REGISTRY:
        raise ValueError(f"epilogue '{op.name}' already registered")
    REGISTRY[op.name] = op
    return op


def get(name: str) -> EpilogueOp:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown epilogue '{name}'; registered: "
                       f"{sorted(REGISTRY)}") from None


def _relu(y, aux):
    return torch.clamp_min(y, 0.0)


def _relu_grad(y):
    return (y > 0.0).to(y.dtype)


def _silu(y, aux):
    return y * (1.0 / (1.0 + torch.exp(-y)))


def _silu_grad(y):
    s = 1.0 / (1.0 + torch.exp(-y))
    return s * (1.0 + y * (1.0 - s))


def _gelu(y, aux):
    # tanh approximation, as in the reference.
    return 0.5 * y * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                       * (y + 0.044715 * y * y * y)))


def _gelu_grad(y):
    u = _SQRT_2_OVER_PI * (y + 0.044715 * y * y * y)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * y * y)
    return 0.5 * (1.0 + t) + 0.5 * y * (1.0 - t * t) * du


def activation(name: str) -> Callable:
    """The unary activation of a registered elementwise op."""
    op = get(name)
    if op.aux is not None:
        raise ValueError(f"'{name}' is not an elementwise activation")
    return lambda y: op.apply(y, None)


def activation_grad(name: str) -> Callable:
    """The derivative of a registered elementwise activation: what the
    act_grad output of the GEMM kernel stores and the backward consumes."""
    op = get(name)
    if op.aux is not None or op.grad is None:
        raise ValueError(f"'{name}' has no registered derivative (needed "
                         f"for the act_grad output)")
    return op.grad


def _bias_apply(y, aux):
    return y + aux                      # aux: (1, bn), broadcast over rows


def _bias_fold(colck, rowck, aux, rows):
    # Every tile row gains aux, padding rows included: column sums shift by
    # rows·aux, row sums by Σ aux (zero over padded columns).
    return colck + float(rows) * aux, rowck + torch.sum(aux, dim=-1,
                                                        keepdim=True)


def _residual_apply(y, aux):
    return y + aux                      # aux: (bm, bn)


def _residual_fold(colck, rowck, aux, rows):
    return (colck + torch.sum(aux, dim=-2, keepdim=True),
            rowck + torch.sum(aux, dim=-1, keepdim=True))


register(EpilogueOp("bias", linear=True, apply=_bias_apply, aux="vector",
                    fold=_bias_fold))
register(EpilogueOp("residual", linear=True, apply=_residual_apply,
                    aux="tile", fold=_residual_fold))
register(EpilogueOp("relu", linear=False, apply=_relu, grad=_relu_grad))
register(EpilogueOp("silu", linear=False, apply=_silu, grad=_silu_grad))
register(EpilogueOp("gelu", linear=False, apply=_gelu, grad=_gelu_grad))


def fold_split(chain) -> int:
    """Length of the chain's linear prefix (folded into the checksums)."""
    for i, name in enumerate(chain):
        if not get(name).linear:
            return i
    return len(chain)


def reference_apply(chain, y, *, bias=None, residual=None):
    """Unfused composition: apply the chain to a full (M, N) f32 array."""
    aux_of = {"vector": bias, "tile": residual}
    for name in chain:
        op = get(name)
        aux = aux_of[op.aux] if op.aux is not None else None
        if op.aux is not None and aux is None:
            raise ValueError(f"epilogue '{name}' needs a {op.aux} operand")
        y = op.apply(y, None if aux is None else aux.float())
    return y
