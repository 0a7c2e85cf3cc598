"""Phi-4-mini 3.8B — RoPE + SwiGLU + GQA. [arXiv:2412.08905]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064,
)

SMOKE = ModelConfig(
    arch_id="phi4-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
)
