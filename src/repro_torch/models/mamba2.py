"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060): the SSM family
(counterpart of `repro.models.mamba2`).

Training and prefill run the chunked SSD algorithm: within a chunk four
GEMM-shaped products, each an ABFT-protected `core.ft_batched_dot` under
the context's FT policy at its own site ("ssd_cb", "ssd_lx", "ssd_state",
"ssd_ch"; on the kernel backend the batched kernel K5, one launch each),
whatever ``protect_attention`` says, as the reference's; between chunks the
element-wise state recurrence, a Python loop over the chunks. ``in_proj``,
``out_proj`` and the head are 2-D FT GEMMs (K1). Decode is O(1) a token:
h <- exp(dt·A)·h + dt·B·x, y = C·h + D·x, the readout a plain f32 product
outside ABFT, as the reference's.

Parameters are a `transformer.Params` tree with the reference's paths:
"embed.table", "layers.ssm.{in_proj, conv_w, conv_b, A_log, D, dt_bias,
norm_w, out_proj}" and "layers.pre_norm" (stacked on a leading layer
axis), "final_norm", "head.table".

The cache is the per-layer recurrent state, "ssm" (L, B, H, N, P) f32 and
"conv" (L, B, W - 1, C) bf16 at every run dtype (the reference's rounding),
plus "length". Serving writes it in place, where the reference rebuilds
the arrays every step; the values are the same.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..core import telemetry
from ..core.ft_gemm import ft_batched_dot
from . import blocks
from .blocks import Ctx
from .transformer import Params

#: the clip of every decay exponent (the reference's)
EXP_CLIP = -60.0


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm" or cfg.ssm is None:
        raise NotImplementedError(f"{cfg.arch_id}: models.mamba2 runs the "
                                  f"ssm family only (family={cfg.family!r})")


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, state N, groups)."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim, sc.state, sc.n_groups


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, EXP_CLIP, 0.0))


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda") -> Params:
    """Random parameters from a seeded `torch.Generator`, in the
    reference's layout and scales (the values differ from JAX's). Stacked
    tensors are filled one layer at a time."""
    _check_family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    sc = cfg.ssm
    d, n_l, v = cfg.d_model, cfg.n_layers, cfg.padded_vocab()
    d_inner, h, n, g = dims(cfg)
    conv_ch = d_inner + 2 * g * n
    proj_out = 2 * d_inner + 2 * g * n + h          # z, x, B, C, dt
    ones = lambda *s: torch.ones(*s, dtype=torch.float32, device=device)

    def stacked(shape, draw):
        t = torch.empty((n_l,) + shape, dtype=dtype, device=device)
        for i in range(n_l):
            t[i] = draw()
        return t

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
    ssm = {
        "in_proj": stacked((d, proj_out), lambda: blocks.dense_init(
            gen, d, proj_out, dtype, 0.02, device)),
        "conv_w": stacked((sc.conv_width, conv_ch), lambda: (
            torch.randn(sc.conv_width, conv_ch, generator=gen,
                        device=device) * 0.02).to(dtype)),
        "conv_b": torch.zeros(n_l, conv_ch, dtype=dtype, device=device),
        "A_log": a_log.repeat(n_l, 1),
        "D": ones(n_l, h),
        "dt_bias": torch.zeros(n_l, h, dtype=torch.float32, device=device),
        "norm_w": ones(n_l, d_inner),
        "out_proj": stacked((d_inner, d), lambda: blocks.dense_init(
            gen, d_inner, d, dtype, 0.02 / math.sqrt(2 * n_l), device)),
    }
    return Params({
        "embed": {"table": blocks.embed_init(gen, v, d, dtype,
                                             device=device)},
        "layers": {"ssm": ssm, "pre_norm": ones(n_l, d)},
        "final_norm": ones(d),
        "head": {"table": blocks.dense_init(gen, d, v, dtype,
                                            device=device)}})


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, h, n, g = dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, g * n, g * n, h], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d in f32, rounded to x's dtype. x (B, L, C);
    w (W, C)."""
    wlen, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, wlen - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(wlen):
        out = out + xp[:, i:i + l, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor,
                d_skip: torch.Tensor, sc: SSMConfig, ctx: Ctx,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (B, L, H, P); dt (B, L, H) after the softplus;
    a (H,) < 0; b_mat, c_mat (B, L, G, N). A length that is not a multiple
    of the chunk is one chunk of L rows. Returns (y (B, L, H, P) in x's
    dtype, the last state (B, H, N, P) f32)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(sc.chunk, l)
    if l % q != 0:
        q = l
    nc = l // q
    rep = h // g

    def bdot(site, lhs, rhs):
        return ft_batched_dot(lhs, rhs, ft=ctx.ft, key=ctx.subkey(site),
                              site=site)

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_mat.reshape(bsz, nc, q, g, n)
    cc = c_mat.reshape(bsz, nc, q, g, n)

    dta = dtc * a                                     # (B, nc, Q, H)
    a_cum = torch.cumsum(dta, dim=2)                  # within-chunk cumsum
    a_total = a_cum[:, :, -1]                         # (B, nc, H)

    # intra-chunk: scores[b,c,h,i,j] = C[i]·B[j] exp(a_cum[i] - a_cum[j])
    # dt[j], B and C repeated to every head as the reference does
    cc_h = torch.repeat_interleave(cc, rep, dim=3)    # (B, nc, Q, H, N)
    bc_h = torch.repeat_interleave(bc, rep, dim=3)
    cc_hq = cc_h.permute(0, 1, 3, 2, 4).reshape(-1, q, n)
    cb = bdot("ssd_cb", cc_hq,
              bc_h.permute(0, 1, 3, 4, 2).reshape(-1, n, q)
              ).reshape(bsz, nc, h, q, q).float()
    seg = a_cum.permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    decay = _decay(seg[..., :, None] - seg[..., None, :])
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    l_mat = torch.where(causal, cb * decay, torch.zeros((), device=x.device))
    l_mat = l_mat * dtc.permute(0, 1, 3, 2)[..., None, :]   # · dt[j]
    xc_h = xc.permute(0, 1, 3, 2, 4).reshape(-1, q, p)
    y_diag = bdot("ssd_lx", l_mat.to(x.dtype).reshape(-1, q, q), xc_h
                  ).reshape(bsz, nc, h, q, p)

    # chunk boundary states: S[b,c,h] = Σ_q B[q] exp(a_total - a_cum[q])
    # dt[q] x[q]
    decay_end = _decay(a_total[:, :, None] - a_cum)
    bw = bc_h.float() * (decay_end * dtc)[..., None]  # (B, nc, Q, H, N)
    states = bdot("ssd_state",
                  bw.permute(0, 1, 3, 4, 2).to(x.dtype).reshape(-1, n, q),
                  xc_h).reshape(bsz, nc, h, n, p).float()

    # inter-chunk recurrence; h_prevs[c] is the state before chunk c
    chunk_decay = _decay(a_total)                     # (B, nc, H)
    h_cur = (torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_cur)
        h_cur = h_cur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)              # (B, nc, H, N, P)

    # inter-chunk output: y_off = C·h_prev·exp(a_cum)
    y_off = bdot("ssd_ch", cc_hq.to(x.dtype),
                 h_prev.to(x.dtype).reshape(-1, n, p)
                 ).reshape(bsz, nc, h, q, p).float()
    y_off = y_off * _decay(a_cum).permute(0, 1, 3, 2)[..., None]

    y = y_diag.float() + y_off
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p)
    y = y + d_skip[None, None, :, None] * x.float()
    return y.to(x.dtype), h_cur


def _gate_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
              ctx: Ctx) -> torch.Tensor:
    """rmsnorm(y · silu(z)) then ``out_proj``."""
    y = blocks.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_w"],
                       cfg.norm_eps)
    return ctx.dot("out_proj", y, p["out_proj"])


def _mix(p, hidden: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """The block up to its SSD scan: (y (B, L, d_inner), z, the last state,
    the conv tail (B, W - 1, C) bf16 of the conv's inputs)."""
    sc = cfg.ssm
    d_inner, h, n, g = dims(cfg)
    bsz, l, _ = hidden.shape
    zxbcdt = ctx.dot("in_proj", hidden, p["in_proj"])
    z, x, b_mat, c_mat, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b_mat, c_mat], dim=-1)
    conv_tail = xbc[:, -(sc.conv_width - 1):, :].to(torch.bfloat16)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x, b_mat, c_mat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y, h_last = ssd_chunked(x.reshape(bsz, l, h, sc.head_dim), dt, a,
                            b_mat.reshape(bsz, l, g, n),
                            c_mat.reshape(bsz, l, g, n), p["D"], sc, ctx)
    return y.reshape(bsz, l, d_inner), z, h_last, conv_tail


def apply_block(p, hidden: torch.Tensor, cfg: ModelConfig,
                ctx: Ctx) -> torch.Tensor:
    """The whole Mamba-2 block (training, prefill). hidden (B, L, d)."""
    y, z, _, _ = _mix(p, hidden, cfg, ctx)
    return _gate_out(p, y, z, cfg, ctx)


def _layer(lp, h: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    return h + apply_block(lp["ssm"], blocks.rmsnorm(h, lp["pre_norm"],
                                                     cfg.norm_eps), cfg, ctx)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx, *, remat=True, chunk: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux), aux a zero (no
    load-balance loss in this family). Layer i draws its SEUs from the key
    folded with i. ``chunk`` (the attention chunk) is unused here; the SSD
    chunk is the config's."""
    _check_family(cfg)
    with telemetry.ft_scope() as scope:
        x = blocks.embed(tokens, params.embed.table).to(ctx.dtype)
        for i, lp in enumerate(params.layers.unbind_layers()):
            layer = blocks.make_remat(functools.partial(
                _layer, cfg=cfg, ctx=ctx.fold(i)), remat)
            x = layer(lp, x)
        x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
        logits = blocks.lm_head(x, params.head.table, ctx)
    outer = telemetry.current_scope()
    if outer is not None:
        outer.extend(scope)
    ctx.check_inject_sites(scope)
    return logits, torch.zeros((), device=logits.device)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, ctx: Ctx, *, remat=True, chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, metrics) of a batch {"tokens", "labels"} (B, S): the mean
    cross-entropy; metrics {"ce", "aux", "ft"} as `transformer.loss_fn`'s."""
    with telemetry.ft_scope() as scope:
        logits, aux = forward(params, batch["tokens"], cfg, ctx, remat=remat)
    outer = telemetry.current_scope()
    if outer is not None:
        outer.extend(scope)
    ce = blocks.cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce.detach(), "aux": aux.detach(),
                "ft": scope.report(device=ce.device)}


# ---------------------------------------------------------------------------
# serving: the recurrent state as the cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """The per-layer recurrent state, O(1) in ``max_len``; ``dtype`` is
    unused (the state is f32, the conv window bf16, as the reference's)."""
    _check_family(cfg)
    sc = cfg.ssm
    d_inner, h, n, g = dims(cfg)
    conv_ch = d_inner + 2 * g * n
    return {
        "ssm": torch.zeros(cfg.n_layers, batch, h, n, sc.head_dim,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(cfg.n_layers, batch, sc.conv_width - 1, conv_ch,
                            dtype=torch.bfloat16, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device)}


def decode_block(p, hidden: torch.Tensor, ssm: torch.Tensor,
                 conv: torch.Tensor, cfg: ModelConfig, ctx: Ctx
                 ) -> torch.Tensor:
    """One token through a block. hidden (B, 1, d); ``ssm`` (B, H, N, P)
    and ``conv`` (B, W - 1, C), one layer's state, are updated in place.
    Returns the block's output (B, 1, d)."""
    sc = cfg.ssm
    d_inner, h, n, g = dims(cfg)
    bsz = hidden.shape[0]
    zxbcdt = ctx.dot("in_proj", hidden, p["in_proj"])
    z, x, b_mat, c_mat, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b_mat, c_mat], dim=-1)             # (B, 1, C)
    window = torch.cat([conv.to(xbc.dtype), xbc], dim=1)   # (B, W, C)
    conv_out = ((window.float() * p["conv_w"].float()[None]).sum(1)
                + p["conv_b"].float())                      # (B, C)
    x1, b1, c1 = torch.split(F.silu(conv_out), [d_inner, g * n, g * n],
                             dim=-1)
    x1 = x1.reshape(bsz, h, sc.head_dim)
    b1 = torch.repeat_interleave(b1.reshape(bsz, g, n), h // g, dim=1)
    c1 = torch.repeat_interleave(c1.reshape(bsz, g, n), h // g, dim=1)
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"])       # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p["A_log"]))
    ssm.mul_(decay[:, :, None, None]).add_(
        (dt1[:, :, None] * b1)[..., None] * x1[:, :, None, :])
    # the readout: a plain f32 product outside ABFT, as the reference's
    y = torch.einsum("bhn,bhnp->bhp", c1, ssm) + p["D"][None, :, None] * x1
    conv.copy_(window[:, 1:])
    y = y.reshape(bsz, 1, d_inner).to(hidden.dtype)
    return _gate_out(p, y, z, cfg, ctx)


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig, ctx: Ctx
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B, 1); every layer's state in the cache is
    advanced in place. Returns (logits (B, 1, V), cache) with ``length``
    advanced."""
    _check_family(cfg)
    x = blocks.embed(token, params.embed.table).to(ctx.dtype)
    for i, lp in enumerate(params.layers.unbind_layers()):
        hn = blocks.rmsnorm(x, lp["pre_norm"], cfg.norm_eps)
        x = x + decode_block(lp["ssm"], hn, cache["ssm"][i],
                             cache["conv"][i], cfg, ctx.fold(i))
    x = blocks.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, params.head.table, ctx)
    cache["length"] = cache["length"] + 1
    return logits, cache


def prefill(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            cfg: ModelConfig, ctx: Ctx, *, chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The prompt (B, S) through the model (`forward`'s blocks), each
    layer's last SSD state and the last W - 1 conv inputs written into the
    cache. ``chunk`` is unused, as in `forward`. Returns (last-position
    logits (B, V), cache)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = blocks.embed(tokens, params.embed.table).to(ctx.dtype)
    for i, lp in enumerate(params.layers.unbind_layers()):
        lctx = ctx.fold(i)
        p = lp["ssm"]
        y, z, h_last, conv_tail = _mix(
            p, blocks.rmsnorm(x, lp["pre_norm"], cfg.norm_eps), cfg, lctx)
        x = x + _gate_out(p, y, z, cfg, lctx)
        cache["ssm"][i] = h_last
        cache["conv"][i] = conv_tail
    x = blocks.rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = blocks.lm_head(x, params.head.table, ctx)[:, 0]
    cache["length"] = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
    return logits, cache
