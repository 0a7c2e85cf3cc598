"""repro_torch — the PyTorch + CUDA counterpart of `repro`.

The JAX package `repro` stays the reference; this package mirrors its module
names so each counterpart is easy to find (`core/`, `kernels/`,
`kernels/templates/`, `models/`, `configs/`, `train/`, `launch/`). It imports
torch and numpy only — never jax and nothing of `repro`.

Backend mapping (`FTConfig.backend`, same field and values as the reference):

  * ``"pallas"`` — the reference's kernel backend. Here it selects the
    hand-written CUDA kernels for Hopper (`kernels/csrc/*.cu`): the ABFT
    GEMM (2-D and uniform-batched) and the ABFT flash-attention forward.
    On a CPU tensor each wrapper runs its kernel's plain PyTorch version,
    which walks the same tile grid and writes the same report.
  * ``"xla"`` — the torch-op ABFT path mirroring
    `repro.core.ft_gemm._fused_ft_matmul_2d` (checksums from the operands,
    `core.abft` verify/locate/correct); its products are plain
    `torch.matmul`, as the reference left them to XLA.
  * FT off with no injection takes the plain-matmul fast path.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
the CPU tests pass ``device="cpu"``.
"""
