"""Minitron-4B — pruned Nemotron. [arXiv:2407.14679]
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
)

SMOKE = ModelConfig(
    arch_id="minitron-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
)
