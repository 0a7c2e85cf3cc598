"""Whisper-medium — encoder-decoder; the conv / mel frontend is a stub
input (precomputed frame embeddings). [arXiv:2212.04356]
24+24L d_model=1024 16H d_ff=4096 vocab=51865."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865, n_audio_frames=1500,
)

SMOKE = ModelConfig(
    arch_id="whisper-medium-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, n_audio_frames=32,
)
