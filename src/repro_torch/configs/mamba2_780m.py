"""Mamba2-780m — SSD (state-space duality), attention-free. [arXiv:2405.21060]
48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    attention_free=True, subquadratic=True,
)

SMOKE = ModelConfig(
    arch_id="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512,
    ssm=SSMConfig(state=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    attention_free=True, subquadratic=True,
)
