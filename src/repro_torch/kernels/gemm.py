"""Baseline GEMM entry points (counterpart of `repro.kernels.gemm`), the
rungs of the paper's step-wise GEMM ladder (§3) below the FT levels.

`gemm` and `gemm_masked` are K1 (`ft_gemm.ft_gemm`) with FT off at one of
its compiled tiles: the tiled, register-blocked rung. The kernel masks
ragged edges by bounds, so `gemm_masked` is `gemm` on any shape (the
reference's masked variant carries the true dims for its padded TPU grid).

`naive_gemm` is K9, the bottom rung: the CUDA kernel `csrc/gemm_naive.cu`
(one thread per output element over all of K, no shared memory, no
k-tiling) on a CUDA tensor, its plain version `naive_gemm_plain` on a CPU
tensor. The reference's contract (`repro/kernels/gemm.py:61-88`) holds:
M and N are each at most 128 or a multiple of 128. The reference's grid
silently leaves the tail of an M of 200 uncomputed; here such a shape
raises `ValueError`, on the CPU and on the card alike.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import build
from . import ft_gemm as kgemm
from .ft_gemm import DTYPE_CODES

NAIVE_GEMM = build.Kernel("gemm_naive", "gemm_naive_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p])

#: The reference's output block edge: M and N are each at most this or a
#: multiple of it.
NAIVE_BLOCK = 128


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         tiles: Sequence[int]) -> torch.Tensor:
    """C = A @ B through K1 with FT off at the compiled tile ``tiles``."""
    out, _ = kgemm.ft_gemm(a, b, tiles=tuple(tiles))
    return out


def gemm_masked(a: torch.Tensor, b: torch.Tensor, *,
                tiles: Sequence[int]) -> torch.Tensor:
    """Ragged-shape GEMM: `gemm` under the reference's name, kept so the
    reference's callers port unchanged (the kernel masks the edge tiles)."""
    return gemm(a, b, tiles=tiles)


def _check_naive(a: torch.Tensor, b: torch.Tensor, out_dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"naive_gemm: bad shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    for name, d in (("M", a.shape[0]), ("N", b.shape[1])):
        if d > NAIVE_BLOCK and d % NAIVE_BLOCK != 0:
            raise ValueError(f"naive_gemm: {name} = {d} is neither at most "
                             f"{NAIVE_BLOCK} nor a multiple of it")
    if out_dtype is not None and out_dtype != a.dtype:
        raise NotImplementedError("naive_gemm writes C in the operand dtype")


def naive_gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                     out_dtype=None) -> torch.Tensor:
    """K9's function in plain PyTorch: the f32 product, cast to a's dtype."""
    _check_naive(a, b, out_dtype)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def naive_gemm(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """C = A @ B on the naive rung: K9 on a CUDA tensor (it launches the
    kernel or raises), `naive_gemm_plain` on a CPU tensor."""
    _check_naive(a, b, out_dtype)
    if a.device.type == "cpu":
        return naive_gemm_plain(a, b)
    build.check_device(a)
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype or \
            b.device != a.device:
        raise TypeError(f"naive_gemm: float32 or bfloat16 operands of one "
                        f"dtype on one device, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("naive_gemm: the kernel takes contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    NAIVE_GEMM(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
               DTYPE_CODES[a.dtype],
               torch.cuda.current_stream(a.device).cuda_stream)
    return out
