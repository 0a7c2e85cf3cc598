"""Decoder-only transformer LM, dense and MoE families (counterpart of
`repro.models.transformer`): qwen2-7b, codeqwen1.5-7b, phi4-mini,
minitron-4b (dense); qwen3-moe-235b and arctic-480b (MoE: every layer's FFN
is `models.moe`, arctic's with a parallel dense residual MLP beside it).

Parameters live in a `Params` module tree whose `state_dict` keys are the
reference's parameter paths joined with "." ("layers.attn.wq",
"embed.table", …). Layers stay stacked on a leading L axis, as in the
reference's `init`, so converting reference weights is a rename
(`repro_torch.convert`). The model is plain functions over tensors.

Serving differs from the reference in one deliberate way: the KV cache is
updated in place (`prefill` writes the prompt's keys and values into the
cache buffers, `decode_step` writes one position per row, and
`paged_decode_step` one position per slot into the page pools), where the
JAX reference rebuilds the cache arrays functionally every step.

Training: `forward(..., remat=...)` walks the layers in a Python loop (the
reference's `_scan_layers`), each layer under `blocks.make_remat`, over
per-layer views that one `torch.unbind` per stacked leaf makes, so the
backward stacks each leaf's gradient once. `forward` returns the logits
and the MoE load-balance loss summed over the layers (zero for the dense
family); `loss_fn` is the reference's: mean cross-entropy plus 0.01 × that
loss, with the FT report of the forward in its metrics.
"""
from __future__ import annotations

import math
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core import telemetry
from . import blocks, moe as moe_lib
from .blocks import Ctx


class Params(nn.Module):
    """A tree of parameters: nested `Params` with tensor leaves
    (`nn.Parameter`s, frozen until a trainer calls ``requires_grad_()``).
    Indexing by name (``p["wq"]``, ``p.get("bq")``) mirrors the reference's
    nested dicts."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def unbind_layers(self) -> List[Dict[str, Any]]:
        """Every layer of a stacked tree as nested dicts of views, from one
        `torch.unbind` per leaf: autograd then stacks each leaf's per-layer
        gradients once, instead of a full-size gradient per layer."""
        leaves = {n: torch.unbind(p, 0)
                  for n, p in self.named_parameters(recurse=False)}
        kids = {n: c.unbind_layers() for n, c in self.named_children()}
        n_layers = len(next(iter(leaves.values()), None)
                       or next(iter(kids.values())))
        return [{**{n: v[i] for n, v in leaves.items()},
                 **{n: v[i] for n, v in kids.items()}}
                for i in range(n_layers)]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or \
            (cfg.family == "moe") != (cfg.moe is not None):
        raise NotImplementedError(f"{cfg.arch_id}: the port's transformer "
                                  f"runs the dense and MoE families only "
                                  f"(family={cfg.family!r})")


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda") -> Params:
    """Random parameters from a seeded `torch.Generator`, in the
    reference's layout and scales (the values differ from JAX's). Stacked
    tensors are filled one layer at a time, so the f32 draw never exceeds
    one layer's size."""
    _check_family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, n_l, v = cfg.d_model, cfg.n_layers, cfg.padded_vocab()
    qd, kvd = cfg.qkv_dims
    out_scale = 0.02 / math.sqrt(2 * n_l)

    def stacked(d_in, d_out, scale):
        t = torch.empty(n_l, d_in, d_out, dtype=dtype, device=device)
        for i in range(n_l):
            t[i] = blocks.dense_init(gen, d_in, d_out, dtype, scale, device)
        return t

    attn = {"wq": stacked(d, qd, 0.02), "wk": stacked(d, kvd, 0.02),
            "wv": stacked(d, kvd, 0.02), "wo": stacked(qd, d, out_scale)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros(n_l, qd, dtype=dtype, device=device)
        attn["bk"] = torch.zeros(n_l, kvd, dtype=dtype, device=device)
        attn["bv"] = torch.zeros(n_l, kvd, dtype=dtype, device=device)
    ones = lambda *s: torch.ones(*s, dtype=torch.float32, device=device)
    # Draw order: attention, embedding, FFN, head (the dense family's
    # weights from a seed are those of the parent commits).
    embed = {"table": blocks.embed_init(gen, v, d, dtype, device=device)}
    layers = {"attn_norm": ones(n_l, d), "attn": attn,
              "ffn_norm": ones(n_l, d)}
    if cfg.moe is not None:
        layers["moe"] = moe_lib.init_moe(gen, d, cfg.moe, n_l, dtype, device)
    d_ff = cfg.moe.dense_d_ff if cfg.moe is not None else cfg.d_ff
    if d_ff:
        layers["mlp"] = {"w_gate": stacked(d, d_ff, 0.02),
                         "w_up": stacked(d, d_ff, 0.02),
                         "w_down": stacked(d_ff, d, out_scale)}
    tree = {
        "embed": embed,
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"table": blocks.dense_init(gen, d, v, dtype,
                                                   device=device)}
    return Params(tree)


def _head_table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params.embed.table.T if cfg.tie_embeddings
            else params.head.table)


def ffn(lp: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig, ctx: Ctx
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on the normed input: the MoE layer (plus arctic's
    parallel dense residual MLP) or the dense MLP. Returns (y, aux loss)."""
    if cfg.moe is None:
        return blocks.mlp(lp["mlp"], h, ctx), torch.zeros((), device=h.device)
    y, aux = moe_lib.apply_moe(lp["moe"], h, cfg.moe, ctx)
    if cfg.moe.dense_d_ff:
        y = y + blocks.mlp(lp["mlp"], h, ctx)
    return y, aux


def apply_layer(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                ctx: Ctx, *, positions: Optional[torch.Tensor] = None,
                chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block on one layer's parameters ``lp``. Returns (x, aux
    loss)."""
    h = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + blocks.attention(lp["attn"], h, cfg, ctx, causal=True,
                             positions=positions, chunk=chunk)
    h = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
    y, aux = ffn(lp, h, cfg, ctx)
    return x + y, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx, *, remat=True, chunk: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int → (logits (B, S, V), aux), aux the MoE load-balance
    loss summed over the layers (f32; zero for the dense family). FT
    summaries go to the ambient `telemetry.ft_scope`. ``remat`` ("full" /
    True, "none" / False) checkpoints each layer when gradients are
    taken."""
    _check_family(cfg)
    with telemetry.ft_scope() as scope:
        x = blocks.embed(tokens, params.embed.table).to(ctx.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        for i, lp in enumerate(params.layers.unbind_layers()):
            # Each layer draws its own SEUs (its index folded into the key);
            # the remat recompute derives the same keys.
            layer = blocks.make_remat(
                functools.partial(apply_layer, cfg=cfg, ctx=ctx.fold(i),
                                  positions=positions, chunk=chunk), remat)
            x, aux_l = layer(lp, x)
            aux = aux + aux_l
        x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
        logits = blocks.lm_head(x, _head_table(params, cfg), ctx)
    outer = telemetry.current_scope()
    if outer is not None:
        outer.extend(scope)
    ctx.check_inject_sites(scope)
    return logits, aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, ctx: Ctx, *, remat=True, chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, metrics) of a batch {"tokens", "labels"} (B, S): mean
    cross-entropy plus 0.01 × the MoE load-balance loss (zero for the
    dense family); metrics {"ce", "aux", "ft"} with "ft" the `FTReport` of
    the forward. The forward's records also reach the ambient scope."""
    with telemetry.ft_scope() as scope:
        logits, aux = forward(params, batch["tokens"], cfg, ctx, remat=remat,
                              chunk=chunk)
    outer = telemetry.current_scope()
    if outer is not None:
        outer.extend(scope)
    ce = blocks.cross_entropy(logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce.detach(), "aux": aux.detach(),
                             "ft": scope.report(device=ce.device)}


# ---------------------------------------------------------------------------
# serving: KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros(batch, dtype=torch.int32, device=device)}


def _project_qkv(p, h: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                 positions: torch.Tensor):
    b, s, _ = h.shape
    # qkv biases ride the projection GEMMs as fused epilogues.
    q = ctx.dot_fused("wq", h, p["wq"], bias=p.get("bq"))
    k = ctx.dot_fused("wk", h, p["wk"], bias=p.get("bk"))
    v = ctx.dot_fused("wv", h, p["wv"], bias=p.get("bv"))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = blocks.apply_rope(q, positions, cfg.rope_theta)
    k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig, ctx: Ctx
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B, 1); the cache holds ``length`` tokens per
    row. Writes the new keys/values into the cache in place and returns
    (logits (B, 1, V), cache) with ``length`` advanced."""
    _check_family(cfg)
    x = blocks.embed(token, params.embed.table).to(ctx.dtype)
    pos = cache["length"].long()                         # (B,)
    rows = torch.arange(x.shape[0], device=x.device)
    for i, lp in enumerate(params.layers.unbind_layers()):
        lctx = ctx.fold(i)
        hn = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(lp["attn"], hn, cfg, lctx,
                                       pos[:, None])
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c.index_put_((rows, pos), k_new[:, 0].to(k_c.dtype))
        v_c.index_put_((rows, pos), v_new[:, 0].to(v_c.dtype))
        att = blocks.decode_attention(q, k_c, v_c, pos + 1, lctx)
        x = x + lctx.dot("wo", att.reshape(x.shape[0], 1, -1),
                         lp["attn"]["wo"])
        hn = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn(lp, hn, cfg, lctx)[0]
    x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, _head_table(params, cfg), ctx)
    cache["length"] = cache["length"] + 1
    return logits, cache


def paged_decode_step(params: Params, token: torch.Tensor,
                      cache: Dict[str, Any], cfg: ModelConfig, ctx: Ctx
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step against the paged KV cache of the serving engine
    (`train.kv_cache`). token (B, 1) over the engine's slots; cache
    {"k_pages", "v_pages": (L, P, KVH, page, dh) pools, "page_table" int32
    (B, max_pages), "length" int32 (B,)}. Per layer the new key and value
    land at position ``length`` through the page table
    (`kv_cache.append_layer`, in place) and attention runs over
    ``length + 1`` positions (`blocks.paged_decode_attention`). Dead slots
    (all-NULL rows) scatter into the null page and give ignored logits.
    Returns (logits (B, 1, V), cache) with ``length`` advanced."""
    from ..train import kv_cache
    _check_family(cfg)
    x = blocks.embed(token, params.embed.table).to(ctx.dtype)
    pos = cache["length"]                                # (B,) int32
    table = cache["page_table"]
    for i, lp in enumerate(params.layers.unbind_layers()):
        lctx = ctx.fold(i)
        hn = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(lp["attn"], hn, cfg, lctx,
                                       pos.long()[:, None])
        k_p, v_p = cache["k_pages"][i], cache["v_pages"][i]
        kv_cache.append_layer(k_p, k_new[:, 0], table, pos)
        kv_cache.append_layer(v_p, v_new[:, 0], table, pos)
        att = blocks.paged_decode_attention(q, k_p, v_p, pos + 1, table,
                                            lctx)
        x = x + lctx.dot("wo", att.reshape(x.shape[0], 1, -1),
                         lp["attn"]["wo"])
        hn = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn(lp, hn, cfg, lctx)[0]
    x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, _head_table(params, cfg), ctx)
    cache["length"] = pos + 1
    return logits, cache


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, ctx: Ctx, *, chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B, S) through the model, writing its keys/values
    into the cache in place. Returns (last-position logits (B, V), cache)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = blocks.embed(tokens, params.embed.table).to(ctx.dtype)
    positions = torch.arange(s, device=x.device)
    for i, lp in enumerate(params.layers.unbind_layers()):
        lctx = ctx.fold(i)
        hn = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg, lctx, positions)
        att = blocks.chunked_attention(q, k, v, causal=True, chunk=chunk,
                                       ctx=lctx)
        x = x + lctx.dot("wo", att.reshape(b, s, -1), lp["attn"]["wo"])
        hn = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn(lp, hn, cfg, lctx)[0]
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = blocks.rmsnorm(x[:, -1:, :], params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, _head_table(params, cfg), ctx)[:, 0]
    cache["length"] = torch.full((b,), s, dtype=torch.int32,
                                 device=x.device)
    return logits, cache
