"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch fronts (counterpart of `repro.kernels`)."""
