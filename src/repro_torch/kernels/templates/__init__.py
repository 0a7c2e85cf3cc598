"""Kernel variant descriptors and epilogue ops (counterpart of
`repro.kernels.templates`)."""
from .spec import BatchedKernelSpec, KernelSpec

__all__ = ["KernelSpec", "BatchedKernelSpec"]
