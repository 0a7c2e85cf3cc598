"""Checksum algebra for algorithm-based fault tolerance (Huang–Abraham 1984),
counterpart of `repro.core.abft`.

    A : (M, K)   column checksum e^T A   (1, K)
    B : (K, N)   row checksum    B e     (K, 1)
    C = A @ B    C^c = (e^T A) @ B  (1, N)      C^r = A @ (B e)  (M, 1)

A single corrupted element (r, c, δ) shifts C^c[c] and C^r[r] by δ, so the
error is located by the argmax of the two residuals and corrected by
subtracting δ. All functions take (…, M, K) / (…, K, N) tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

F32EPS = float(torch.finfo(torch.float32).eps)


def encode_col(a: torch.Tensor) -> torch.Tensor:
    """e^T A: (…, M, K) → (…, 1, K), in f32."""
    return torch.sum(a.float(), dim=-2, keepdim=True)


def encode_row(b: torch.Tensor) -> torch.Tensor:
    """B e: (…, K, N) → (…, K, 1), in f32."""
    return torch.sum(b.float(), dim=-1, keepdim=True)


class Checksums(NamedTuple):
    col: torch.Tensor   # (…, 1, N)
    row: torch.Tensor   # (…, M, 1)


def product_checksums(a: torch.Tensor, b: torch.Tensor) -> Checksums:
    """Checksums of C = A @ B from the operands, never touching C."""
    col = torch.matmul(encode_col(a), b.float())
    row = torch.matmul(a.float(), encode_row(b))
    return Checksums(col=col, row=row)


def residuals(c: torch.Tensor, ck: Checksums) -> Checksums:
    """δ_col = colsum(C) − C^c;  δ_row = rowsum(C) − C^r."""
    cf = c.float()
    d_col = torch.sum(cf, dim=-2, keepdim=True) - ck.col.float()
    d_row = torch.sum(cf, dim=-1, keepdim=True) - ck.row.float()
    return Checksums(col=d_col, row=d_row)


def threshold(a: torch.Tensor, b: torch.Tensor, rel_tau: float
              ) -> torch.Tensor:
    """tau = rel_tau · eps(f32) · K · max|A| · max|B| per batch element,
    floored at 1e-30."""
    k = a.shape[-1]
    amax = torch.amax(torch.abs(a.float()), dim=(-2, -1))
    bmax = torch.amax(torch.abs(b.float()), dim=(-2, -1))
    tau = rel_tau * F32EPS * k * amax * bmax
    return torch.clamp_min(tau, 1e-30)


class Verdict(NamedTuple):
    detected: torch.Tensor   # bool (…,)
    row: torch.Tensor        # int64 (…,)
    col: torch.Tensor        # int64 (…,)
    magnitude: torch.Tensor  # f32 (…,), 0 where not detected


def locate(res: Checksums, tau: torch.Tensor) -> Verdict:
    """Locate a single error: first argmax of each residual; the column
    residual at the located column is the canonical magnitude."""
    d_col = res.col[..., 0, :]
    d_row = res.row[..., :, 0]
    col = torch.argmax(torch.abs(d_col), dim=-1)
    row = torch.argmax(torch.abs(d_row), dim=-1)
    mag_c = torch.gather(d_col, -1, col[..., None])[..., 0]
    mag_r = torch.gather(d_row, -1, row[..., None])[..., 0]
    detected = torch.maximum(torch.abs(mag_c), torch.abs(mag_r)) > tau
    magnitude = torch.where(detected, mag_c, torch.zeros_like(mag_c))
    return Verdict(detected=detected, row=row, col=col, magnitude=magnitude)


def correct(c: torch.Tensor, v: Verdict) -> torch.Tensor:
    """Branchless correction: subtract δ at the located element (δ = 0 when
    nothing was detected)."""
    rows = torch.arange(c.shape[-2], device=c.device)[:, None]
    cols = torch.arange(c.shape[-1], device=c.device)[None, :]
    hit = (rows == v.row[..., None, None]) & (cols == v.col[..., None, None])
    delta = v.magnitude[..., None, None].to(c.dtype)
    return c - torch.where(hit, delta, torch.zeros_like(delta))


def detect_and_correct(c: torch.Tensor, ck: Checksums, tau: torch.Tensor,
                       corrects: bool = True
                       ) -> Tuple[torch.Tensor, Verdict]:
    """Residuals → locate → (optionally) correct."""
    v = locate(residuals(c, ck), tau)
    if corrects:
        c = correct(c, v)
    return c, v
