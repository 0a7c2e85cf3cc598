"""Qwen3-MoE 235B-A22B — 128 experts, top-8 routing. [hf:Qwen/Qwen3-30B-A3B
family] 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536,
                  dense_d_ff=0, group_size=256),
)

SMOKE = ModelConfig(
    arch_id="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=4, expert_d_ff=64, dense_d_ff=0,
                  group_size=64),
)
