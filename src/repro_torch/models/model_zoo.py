"""Architecture dispatch (counterpart of `repro.models.model_zoo`, dense
and MoE branches): `module_for(cfg)` returns the family module exposing

    init(cfg, seed, dtype, device)                 → params
    forward(params, tokens, cfg, ctx)              → (logits, aux)
    init_cache(cfg, batch, max_len, dtype, device) → cache
    prefill(params, tokens, cache, cfg, ctx)       → (logits, cache)
    decode_step(params, token, cache, cfg, ctx)    → (logits, cache)
"""
from __future__ import annotations

from types import ModuleType

from ..configs.base import ModelConfig
from . import transformer


_FAMILIES = {"dense": transformer, "moe": transformer}


def module_for(cfg: ModelConfig) -> ModuleType:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} is "
                                  f"not ported (dense and moe only)")
    return mod
