"""Architecture registry, the dense, MoE, SSM and encoder-decoder entries
(counterpart of `repro.configs.registry`): ``--arch <id>`` resolution."""
from __future__ import annotations

from .base import ModelConfig
from . import (arctic_480b, codeqwen15_7b, mamba2_780m, minitron_4b,
               phi4_mini_38b, qwen2_7b, qwen3_moe_235b, whisper_medium)

_MODULES = {
    "arctic-480b": arctic_480b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "qwen2-7b": qwen2_7b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "phi4-mini-3.8b": phi4_mini_38b,
    "minitron-4b": minitron_4b,
    "mamba2-780m": mamba2_780m,
    "whisper-medium": whisper_medium,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].SMOKE
