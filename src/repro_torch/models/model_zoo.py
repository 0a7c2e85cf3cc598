"""Architecture dispatch (counterpart of `repro.models.model_zoo`, dense
branch): `module_for(cfg)` returns the family module exposing

    init(cfg, seed, dtype, device)                 → params
    forward(params, tokens, cfg, ctx)              → logits
    init_cache(cfg, batch, max_len, dtype, device) → cache
    prefill(params, tokens, cache, cfg, ctx)       → (logits, cache)
    decode_step(params, token, cache, cfg, ctx)    → (logits, cache)
"""
from __future__ import annotations

from types import ModuleType

from ..configs.base import ModelConfig
from . import transformer


def module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} is "
                                  f"not ported (dense only)")
    return transformer
