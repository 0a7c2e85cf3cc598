"""Snowflake Arctic 480B — dense-MoE hybrid: every layer has a parallel dense
residual FFN plus a 128-expert top-2 MoE FFN. [hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, expert_d_ff=4864,
                  dense_d_ff=4864, group_size=512),
)

SMOKE = ModelConfig(
    arch_id="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=96, dense_d_ff=96,
                  group_size=64),
)
