"""Whisper-style encoder-decoder (counterpart of `repro.models.whisper`,
arXiv:2212.04356): the transformer backbone only; the conv / mel audio
frontend is a stub, so the caller supplies frame embeddings (B, T_a, d).

A bidirectional encoder over the frames (sinusoidal positions plus RoPE in
its self-attention, as the reference's), a causal decoder with learned
positions, per-layer cross-attention into the encoder's output, GELU MLPs
(``w1`` is one fused-epilogue GEMM, `gelu_mlp`) and RMSNorm. Attention runs
through `blocks.chunked_attention` (the flash kernel K2 on the pallas FT
backend: non-causal over the frames in the encoder and in cross-attention,
Sq = prompt against Skv = frames there) and decode attention through
`blocks.decode_attention` (K5), the cross cache under its own site labels
("xdec_qk" / "xdec_pv").

Parameters are a `transformer.Params` tree with the reference's paths:
"embed.table", "dec_pos", "enc_layers.*" and "dec_layers.*" (stacked on a
leading layer axis; a decoder layer adds "cross_norm" and "cross"),
"enc_norm", "final_norm", "head.table". Every GEMM carries the reference's
site label. The port's telemetry keeps per-site records, not the
reference's per-layer rows.

Serving differs from the reference in one deliberate way, as the
transformer's does: the caches are written in place (`prefill` writes the
prompt's self keys / values and the cross keys / values into the cache
buffers, `decode_step` one position per row), where the reference rebuilds
the cache arrays every step.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import telemetry
from . import blocks
from .blocks import Ctx
from .transformer import Params

#: learned decoder positions (the reference's, covering decode_32k)
MAX_DEC_POS = 65_536


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise NotImplementedError(f"{cfg.arch_id}: models.whisper runs the "
                                  f"encdec family only "
                                  f"(family={cfg.family!r})")


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def gelu_mlp(p, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    h = ctx.dot_fused("w1", x, p["w1"], act="gelu")  # fused epilogue
    return ctx.dot("w2", h, p["w2"])


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda") -> Params:
    """Random parameters from a seeded `torch.Generator`, in the
    reference's layout and scales (the values differ from JAX's). Stacked
    tensors are filled one layer at a time."""
    _check_family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, v = cfg.d_model, cfg.padded_vocab()
    qd, kvd = cfg.qkv_dims
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    ones = lambda *s: torch.ones(*s, dtype=torch.float32, device=device)

    def stacked(n_l, d_in, d_out, scale):
        t = torch.empty(n_l, d_in, d_out, dtype=dtype, device=device)
        for i in range(n_l):
            t[i] = blocks.dense_init(gen, d_in, d_out, dtype, scale, device)
        return t

    def attn(n_l):
        return {"wq": stacked(n_l, d, qd, 0.02),
                "wk": stacked(n_l, d, kvd, 0.02),
                "wv": stacked(n_l, d, kvd, 0.02),
                "wo": stacked(n_l, qd, d, out_scale)}

    def mlp(n_l):
        return {"w1": stacked(n_l, d, cfg.d_ff, 0.02),
                "w2": stacked(n_l, cfg.d_ff, d, out_scale)}

    n_e, n_d = cfg.enc_layers, cfg.n_layers
    embed = {"table": blocks.embed_init(gen, v, d, dtype, device=device)}
    dec_pos = (torch.randn(MAX_DEC_POS, d, generator=gen, device=device)
               * 0.01).to(dtype)
    enc = {"attn_norm": ones(n_e, d), "attn": attn(n_e),
           "ffn_norm": ones(n_e, d), "mlp": mlp(n_e)}
    dec = {"attn_norm": ones(n_d, d), "attn": attn(n_d),
           "cross_norm": ones(n_d, d), "cross": attn(n_d),
           "ffn_norm": ones(n_d, d), "mlp": mlp(n_d)}
    return Params({
        "embed": embed, "dec_pos": dec_pos, "enc_layers": enc,
        "enc_norm": ones(d), "dec_layers": dec, "final_norm": ones(d),
        "head": {"table": blocks.dense_init(gen, d, v, dtype,
                                            device=device)}})


def _enc_layer(lp: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig,
               ctx: Ctx, chunk: int) -> torch.Tensor:
    hn = blocks.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + blocks.attention(lp["attn"], hn, cfg, ctx, causal=False,
                             chunk=chunk)
    hn = blocks.rmsnorm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + gelu_mlp(lp["mlp"], hn, ctx)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: Ctx, *, remat=True, chunk: int = 512) -> torch.Tensor:
    """frames (B, T_a, d) precomputed embeddings (the frontend stub) → the
    encoder's normed output (B, T_a, d). Layer i draws its SEUs from the
    key folded with i."""
    x = (frames.to(ctx.dtype)
         + _sinusoid(frames.shape[1], cfg.d_model, frames.device)
         .to(ctx.dtype))
    for i, lp in enumerate(params.enc_layers.unbind_layers()):
        layer = blocks.make_remat(functools.partial(
            _enc_layer, cfg=cfg, ctx=ctx.fold(i), chunk=chunk), remat)
        x = layer(lp, x)
    return blocks.rmsnorm(x, params.enc_norm, cfg.norm_eps)


def _dec_layer(lp: Dict[str, Any], h: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, ctx: Ctx, chunk: int) -> torch.Tensor:
    hn = blocks.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + blocks.attention(lp["attn"], hn, cfg, ctx, causal=True,
                             chunk=chunk)
    hn = blocks.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
    h = h + blocks.attention(lp["cross"], hn, cfg, ctx, causal=False,
                             kv=enc_out, chunk=chunk)
    hn = blocks.rmsnorm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + gelu_mlp(lp["mlp"], hn, ctx)


def _embed_dec(params: Params, tokens: torch.Tensor, ctx: Ctx,
               pos: torch.Tensor) -> torch.Tensor:
    x = blocks.embed(tokens, params.embed.table).to(ctx.dtype)
    return x + params.dec_pos[pos].to(ctx.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx, *, remat=True, chunk: int = 512,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) + frames (B, T_a, d) → (logits (B, S, V), aux), aux a
    zero (no load-balance loss in this family). Decoder layer i draws its
    SEUs from the key folded with 100 + i."""
    _check_family(cfg)
    with telemetry.ft_scope() as scope:
        enc_out = encode(params, frames, cfg, ctx, remat=remat, chunk=chunk)
        x = _embed_dec(params, tokens, ctx,
                       torch.arange(tokens.shape[1], device=tokens.device))
        for i, lp in enumerate(params.dec_layers.unbind_layers()):
            layer = blocks.make_remat(functools.partial(
                _dec_layer, cfg=cfg, ctx=ctx.fold(100 + i), chunk=chunk),
                remat)
            x = layer(lp, x, enc_out)
        x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
        logits = blocks.lm_head(x, params.head.table, ctx)
    outer = telemetry.current_scope()
    if outer is not None:
        outer.extend(scope)
    ctx.check_inject_sites(scope)
    return logits, torch.zeros((), device=logits.device)


# ---------------------------------------------------------------------------
# serving: the cross KV computed at prefill; the self KV cache grows per step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads,
           cfg.head_dim)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"k": z(kv), "v": z(kv), "xk": z(xkv), "xv": z(xkv),
            "length": torch.zeros(batch, dtype=torch.int32, device=device)}


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, ctx: Ctx, *,
            frames: Optional[torch.Tensor] = None, chunk: int = 512,
            remat=True) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode the frames, project each decoder layer's cross keys / values
    once ("xwk" / "xwv") and run the decoder over the prompt, writing the
    self and cross caches in place (a frame count other than the cache's
    replaces the cross buffers). Returns (last-position logits (B, V),
    cache)."""
    _check_family(cfg)
    b, s = tokens.shape
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    enc_out = encode(params, frames, cfg, ctx, remat=remat, chunk=chunk)
    ta = enc_out.shape[1]
    if cache["xk"].shape[2] != ta:
        shape = cache["xk"].shape[:2] + (ta,) + cache["xk"].shape[3:]
        cache["xk"] = cache["xk"].new_zeros(shape)
        cache["xv"] = cache["xv"].new_zeros(shape)
    positions = torch.arange(s, device=tokens.device)
    x = _embed_dec(params, tokens, ctx, positions)
    for i, lp in enumerate(params.dec_layers.unbind_layers()):
        lctx = ctx.fold(100 + i)
        att_p, cross = lp["attn"], lp["cross"]
        hn = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = lctx.dot("wq", hn, att_p["wq"]).reshape(b, s, cfg.n_heads, dh)
        k = lctx.dot("wk", hn, att_p["wk"]).reshape(b, s, kvh, dh)
        v = lctx.dot("wv", hn, att_p["wv"]).reshape(b, s, kvh, dh)
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
        att = blocks.chunked_attention(q, k, v, causal=True, chunk=chunk,
                                       ctx=lctx)
        x = x + lctx.dot("wo", att.reshape(b, s, -1), att_p["wo"])
        # cross-attention, and its cacheable keys and values
        hn = blocks.rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        xk = lctx.dot("xwk", enc_out, cross["wk"]).reshape(b, ta, kvh, dh)
        xv = lctx.dot("xwv", enc_out, cross["wv"]).reshape(b, ta, kvh, dh)
        qx = lctx.dot("xwq", hn, cross["wq"]).reshape(b, s, cfg.n_heads, dh)
        attx = blocks.chunked_attention(qx, xk, xv, causal=False,
                                        chunk=chunk, ctx=lctx)
        x = x + lctx.dot("xwo", attx.reshape(b, s, -1), cross["wo"])
        hn = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], hn, lctx)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        cache["xk"][i] = xk.to(cache["xk"].dtype)
        cache["xv"][i] = xv.to(cache["xv"].dtype)
    x = blocks.rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, params.head.table, ctx)[:, 0]
    cache["length"] = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
    return logits, cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig, ctx: Ctx
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B, 1); the self cache holds ``length``
    tokens per row. Writes the new keys / values into it in place; attends
    over it ("dec_qk" / "dec_pv") and over the whole cross cache ("xdec_qk"
    / "xdec_pv"). Returns (logits (B, 1, V), cache) with ``length``
    advanced."""
    _check_family(cfg)
    b = token.shape[0]
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    pos = cache["length"].long()                         # (B,)
    x = _embed_dec(params, token, ctx, pos[:, None])
    rows = torch.arange(b, device=token.device)
    ta = cache["xk"].shape[2]
    x_len = torch.full((b,), ta, dtype=torch.int32, device=token.device)
    for i, lp in enumerate(params.dec_layers.unbind_layers()):
        lctx = ctx.fold(100 + i)
        att_p, cross = lp["attn"], lp["cross"]
        hn = blocks.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = lctx.dot("wq", hn, att_p["wq"]).reshape(b, 1, cfg.n_heads, dh)
        k_new = lctx.dot("wk", hn, att_p["wk"]).reshape(b, 1, kvh, dh)
        v_new = lctx.dot("wv", hn, att_p["wv"]).reshape(b, 1, kvh, dh)
        q = blocks.apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = blocks.apply_rope(k_new, pos[:, None], cfg.rope_theta)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c.index_put_((rows, pos), k_new[:, 0].to(k_c.dtype))
        v_c.index_put_((rows, pos), v_new[:, 0].to(v_c.dtype))
        att = blocks.decode_attention(q, k_c, v_c, pos + 1, lctx)
        x = x + lctx.dot("wo", att.reshape(b, 1, -1), att_p["wo"])
        hn = blocks.rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        qx = lctx.dot("xwq", hn, cross["wq"]).reshape(b, 1, cfg.n_heads, dh)
        attx = blocks.decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                       x_len, lctx, site_prefix="xdec")
        x = x + lctx.dot("xwo", attx.reshape(b, 1, -1), cross["wo"])
        hn = blocks.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], hn, lctx)
    x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, params.head.table, ctx)
    cache["length"] = cache["length"] + 1
    return logits, cache
