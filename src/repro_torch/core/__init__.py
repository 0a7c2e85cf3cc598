"""Fault-tolerance policy, checksum algebra, injection and the FT GEMM
dispatch fronts (counterpart of `repro.core`)."""
from .ft_gemm import ft_verdict_dot

__all__ = ["ft_verdict_dot"]
