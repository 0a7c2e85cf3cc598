"""Architecture dispatch (counterpart of `repro.models.model_zoo`, dense,
MoE, SSM and encoder-decoder branches): `module_for(cfg)` returns the family
module exposing

    init(cfg, seed, dtype, device)                 → params
    forward(params, tokens, cfg, ctx)              → (logits, aux)
    init_cache(cfg, batch, max_len, dtype, device) → cache
    prefill(params, tokens, cache, cfg, ctx)       → (logits, cache)
    decode_step(params, token, cache, cfg, ctx)    → (logits, cache)

The encoder-decoder family (whisper) also takes ``frames=`` (B, T_a, d) in
``forward`` and ``prefill``; `input_specs` names each family's inputs (the
SSM family (mamba2) needs none beyond the tokens).
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import mamba2, transformer, whisper


_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
             "encdec": whisper}


def module_for(cfg: ModelConfig) -> ModuleType:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} is "
                                  f"not ported (dense, moe, ssm and encdec "
                                  f"only)")
    return mod


def input_specs(cfg: ModelConfig, batch: int, seq: int, kind: str
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of a ``kind`` ("train", "prefill" or
    "decode") step's inputs, the reference's `input_specs`: tokens (and
    labels to train; one token to decode), and for the encoder-decoder
    family the frame embeddings (B, n_audio_frames, d) bf16."""
    if kind == "decode":
        return {"token": ((batch, 1), torch.int32)}
    specs = {"tokens": ((batch, seq), torch.int32)}
    if kind == "train":
        specs["labels"] = ((batch, seq), torch.int32)
    elif kind != "prefill":
        raise ValueError(kind)
    if cfg.family == "encdec":
        specs["frames"] = ((batch, cfg.n_audio_frames, cfg.d_model),
                           torch.bfloat16)
    return specs
