"""Batched serving: prefill + decode with a KV cache, greedy or temperature
sampling (counterpart of `repro.train.serve`).

Everything runs eagerly under `torch.inference_mode()`. FT telemetry goes
to the ambient `core.telemetry.ft_scope`, if the caller opened one: every
protected GEMM and flash call of prefill and decode records its
(detections, max residual) summary there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import model_zoo
from ..models.blocks import Ctx


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    batch_slots: int = 8
    temperature: float = 0.0       # 0 = greedy
    eos_id: int = -1               # -1 = never stop early


def compute_dtype(run: RunConfig) -> torch.dtype:
    return torch.bfloat16 if run.dtype == "bfloat16" else torch.float32


def check_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no GPU raises
    (entry points never fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def make_serve_fns(cfg: ModelConfig, run: RunConfig
                   ) -> Tuple[Callable, Callable]:
    """The (prefill_fn, decode_fn) pair of the model family, bound to the
    run's FT policy and dtype; both run under `torch.inference_mode()`.
    ``prefill_fn(params, tokens, cache, extra=None)``: ``extra`` is the
    encoder-decoder family's frames (B, T_a, d), as the reference's."""
    mod = model_zoo.module_for(cfg)
    ctx = Ctx(ft=run.ft, key=None, dtype=compute_dtype(run),
              attn_impl=run.attn_impl)

    def prefill_fn(params, tokens, cache, extra=None):
        kw = {}
        if cfg.family == "encdec" and extra is not None:
            kw["frames"] = extra
        with torch.inference_mode():
            return mod.prefill(params, tokens, cache, cfg, ctx,
                               chunk=run.attn_chunk, **kw)

    def decode_fn(params, token, cache):
        with torch.inference_mode():
            return mod.decode_step(params, token, cache, cfg, ctx)

    return prefill_fn, decode_fn


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def generate(params, prompts: np.ndarray, cfg: ModelConfig, run: RunConfig,
             sc: ServeConfig, *, max_new_tokens: int = 32, extra=None,
             seed: int = 0, device="cuda") -> np.ndarray:
    """Batch-generate continuations. prompts: (B, S_prompt) int. Returns
    (B, max_new_tokens) int32 tokens (fewer when every row hit eos_id).
    ``params`` must already live on ``device``. ``extra``: the
    encoder-decoder family's frames (B, T_a, d), a tensor or an array,
    moved to ``device``."""
    dev = check_device(device)
    mod = model_zoo.module_for(cfg)
    prefill_fn, decode_fn = make_serve_fns(cfg, run)
    b = prompts.shape[0]
    cache = mod.init_cache(cfg, b, sc.max_len, compute_dtype(run), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens_in = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                device=dev)
    if extra is not None and not isinstance(extra, torch.Tensor):
        extra = torch.from_numpy(np.asarray(extra, dtype=np.float32))
    if extra is not None:
        extra = extra.to(dev)
    logits, cache = prefill_fn(params, tokens_in, cache, extra)
    out: List[torch.Tensor] = []
    tok = _sample(logits.reshape(b, -1), sc.temperature, gen)[:, None]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_new_tokens):
        out.append(tok)
        logits, cache = decode_fn(params, tok, cache)
        tok = _sample(logits.reshape(b, -1), sc.temperature, gen)[:, None]
        if sc.eos_id >= 0:
            done |= tok[:, 0] == sc.eos_id
            if bool(done.all()):
                out.append(tok)
                break
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
