"""CodeQwen1.5-7B — qwen1.5 arch (MHA, QKV bias). [hf:Qwen/CodeQwen1.5-7B]
32L d_model=4096 32H (GQA kv=32 ⇒ MHA) d_ff=13440 vocab=92416."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True,
)
