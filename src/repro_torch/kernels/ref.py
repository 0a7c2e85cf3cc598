"""Plain PyTorch oracles (counterpart of `repro.kernels.ref`)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import abft
from ..core.fault_injection import inject_spec
from ..core.policy import FTConfig, InjectionSpec


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None
               ) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def fused_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None,
                     chain: Optional[tuple] = None,
                     out_dtype=None) -> torch.Tensor:
    """f32 GEMM followed by the epilogue chain as separate ops."""
    from .templates import epilogues
    out_dtype = out_dtype or a.dtype
    if chain is None:
        chain = ((("bias",) if bias is not None else ())
                 + (("residual",) if residual is not None else ()))
    acc = torch.matmul(a.float(), b.float())
    acc = epilogues.reference_apply(
        chain, acc, bias=None if bias is None else bias.reshape(1, -1),
        residual=residual)
    return acc.to(out_dtype)


class FTRefOut(NamedTuple):
    out: torch.Tensor
    detected: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    magnitude: torch.Tensor


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Plain attention. q: (BH, Sq, dh); k, v: (BH, Skv, dh). Causal masking
    is bottom-right aligned (query i attends kv j iff j ≤ i + Skv − Sq)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask[None], scores,
                             torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ft_matmul_ref(a: torch.Tensor, b: torch.Tensor, ft: FTConfig,
                  spec: Optional[InjectionSpec] = None,
                  out_dtype=None) -> FTRefOut:
    """FT GEMM oracle on one (M, N) output tile: inject → detect → locate →
    correct, verified once at the end."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    ck = abft.product_checksums(a, b)
    acc = inject_spec(acc, spec)
    tau = (torch.tensor(ft.static_tau, dtype=torch.float32, device=a.device)
           if ft.static_tau is not None
           else abft.threshold(a, b, ft.rel_tau))
    out, v = abft.detect_and_correct(acc, ck, tau, corrects=ft.corrects)
    return FTRefOut(out=out.to(out_dtype), detected=v.detected, row=v.row,
                    col=v.col, magnitude=v.magnitude)
