"""Fault-tolerance policy, checksum algebra, injection and the FT GEMM
dispatch fronts (counterpart of `repro.core`)."""
