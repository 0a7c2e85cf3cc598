"""Shared model building blocks (counterpart of `repro.models.blocks`). Every
GEMM routes through `core.ft_dot` / `ft_dot_fused` / `ft_batched_dot`, so
online ABFT protects the whole model.

Conventions:
  * parameters live in `nn.Module`s (see `models.transformer.Params`); the
    model itself is plain functions over tensors;
  * `Ctx` carries the FT policy, the compute dtype and the campaign key:
    each call site draws from its own key (`named_subkey`, crc32 of the
    site label), each layer from its own (`Ctx.fold` of the layer index),
    and ``inject_sites`` limits a campaign to the named sites;
  * prefill attention: on the pallas FT backend the core runs the CUDA
    flash-attention kernel (`kernels.flashft`, both in-kernel GEMMs ABFT
    protected, GQA without repeating KV); elsewhere (and under
    ``Ctx.attn_impl="chunked"``) the query-chunked core with protected
    batched GEMMs runs;
  * decode attention: two protected batched GEMMs (QKᵀ and PV) over the
    grouped (B, KVH, rep, dh) layout; against the serving engine's paged
    cache, the paged decode kernel K6 on the pallas FT backend (one launch
    per layer, site "dec_flash"), else the gathered pages through the
    dense path;
  * training: every front is differentiable. The flash core is a
    `torch.autograd.Function` whose forward is the flash kernel with the
    saved softmax statistics and whose backward is the dQ and dK/dV
    kernels; `make_remat` wraps a layer in a non-reentrant
    `torch.utils.checkpoint` whose recompute records no FT summary, so each
    protected call is counted once, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..core import telemetry
from ..core.fault_injection import fold_in
from ..core.ft_gemm import ft_batched_dot, ft_dot, ft_dot_fused
from ..core.policy import FTConfig, FTLike, FT_OFF, resolve_ft

NEG_INF = -1e30


def named_subkey(key: Optional[torch.Generator], name: str
                 ) -> Optional[torch.Generator]:
    """The campaign key of call site ``name``: ``key`` folded with the
    crc32 of the name (None passes through). Consumes no generator state."""
    return fold_in(key, zlib.crc32(name.encode()))


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context: FT policy (an FTConfig or a per-site FTPolicy),
    campaign key (a `torch.Generator`; with ``ft.inject_rate`` > 0 every
    protected GEMM draws stochastic SEUs from its site's key, `subkey`),
    activation dtype, and the prefill attention core: "auto" (the flash
    kernel on the pallas FT backend, the chunked core elsewhere), "flash"
    or "chunked". A campaign runs on either: the flash kernels draw their
    SEUs in kernel, both directions, as the batched GEMMs of "chunked"
    do.

    ``inject_sites`` limits a campaign to the named sites (the labels the
    GEMMs record their summaries under: "wq", "w_gate", "attn_qk", …):
    `subkey` returns None for every other site. `check_inject_sites`
    raises on a label no GEMM of the forward recorded.

    ``bwd_inject`` = (site, hook) lands a deterministic SEU in the backward
    of every call at ``site`` (conformance checks): for a GEMM site the
    hook is ("dx" | "dw", InjectionSpec) as `core.ft_dot` takes it; for
    "attn_flash" it is the keyword dict of `kernels.ops.flash_ft_bwd`'s
    injection (inject, inj_target, inj_bh, inj_blk)."""
    ft: FTLike = FT_OFF
    key: Optional[torch.Generator] = None
    dtype: Any = torch.bfloat16
    attn_impl: str = "auto"
    bwd_inject: Optional[Tuple[str, Any]] = None
    inject_sites: Optional[Tuple[str, ...]] = None

    def ft_for(self, name: Optional[str]) -> FTConfig:
        """The site's `FTConfig` under this context's policy."""
        return resolve_ft(self.ft, name)

    def site_allowed(self, name: str) -> bool:
        return self.inject_sites is None or name in self.inject_sites

    def check_inject_sites(self, scope: Optional[telemetry.FTScope]
                           ) -> None:
        """Raise if ``inject_sites`` names a label that no protected GEMM
        recorded in ``scope`` (the forward's): a filter that matches
        nothing would report a clean run as the campaign's result."""
        if self.inject_sites is None:
            return
        known = scope.sites() if scope is not None else set()
        unknown = sorted(set(self.inject_sites) - known)
        if unknown:
            raise ValueError(
                f"Ctx.inject_sites names unknown sites {unknown}: no GEMM of "
                f"this forward records under them, so the campaign would "
                f"inject nothing. Known sites: {sorted(map(str, known))}")

    def subkey(self, name: str) -> Optional[torch.Generator]:
        """The campaign key of call site ``name`` (None: no campaign there):
        this context's key folded with the site name."""
        if not self.site_allowed(name):
            return None
        return named_subkey(self.key, name)

    def fold(self, tag: int) -> "Ctx":
        """This context with its key folded with ``tag`` (the layer index):
        each layer draws its own SEUs."""
        if self.key is None:
            return self
        return dataclasses.replace(self, key=fold_in(self.key, tag))

    def bwd_hook(self, name: str):
        """The backward injection of call site ``name``, if any."""
        if self.bwd_inject is not None and self.bwd_inject[0] == name:
            return self.bwd_inject[1]
        return None

    def dot(self, name: str, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
        return ft_dot(x, w, ft=self.ft_for(name), key=self.subkey(name),
                      bwd_inject=self.bwd_hook(name), site=name)

    def dot_fused(self, name: str, x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  act: Optional[str] = None) -> torch.Tensor:
        """y = act(x @ w + bias) as one kernel-level op."""
        return ft_dot_fused(x, w, bias=bias, act=act, ft=self.ft_for(name),
                            key=self.subkey(name),
                            bwd_inject=self.bwd_hook(name), site=name)

    def bdot(self, name: str, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
        ft = self.ft_for(name)
        ft = ft if ft.protect_attention else FT_OFF
        return ft_batched_dot(a, b, ft=ft, key=self.subkey(name), site=name)


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

def _remat_contexts():
    # forward: as usual; recompute in the backward: record nothing (the
    # forward already recorded every protected call's summary).
    return contextlib.nullcontext(), telemetry.muted()


def make_remat(fn, remat):
    """Remat-policy dispatch: False / "none" — save everything; True /
    "full" — a non-reentrant `torch.utils.checkpoint` that keeps only the
    inputs and recomputes ``fn`` in the backward (the recompute records no
    FT summary). The reference's "dots" policy is not ported."""
    if not remat or remat == "none":
        return fn
    if remat not in (True, "full"):
        raise NotImplementedError(f"remat policy {remat!r} is not ported "
                                  f"(only 'none' and 'full')")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=_remat_contexts)

    return wrapped


# ---------------------------------------------------------------------------
# initializers (seeded torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02, device="cuda") -> torch.Tensor:
    return (torch.randn(d_in, d_out, generator=gen, device=device)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               scale: float = 0.02, device="cuda") -> torch.Tensor:
    return (torch.randn(vocab, d, generator=gen, device=device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# normalization / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].float() * freqs       # (…, S, dh/2)
    if angles.dim() == 2:
        angles = angles[None, :, None, :]
    else:
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _chunked_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, chunk: int, ft: FTConfig, subkey,
                  q_offset: int = 0) -> torch.Tensor:
    """Query-chunked attention core. q: (B, Sq, H, dh); k, v: (B, Sk, KVH,
    dh) → (B, Sq, H, dh). Per chunk, GQA runs as a grouped batched matmul
    over (B, KVH) with the rep·chunk rows folded together (KV never
    repeated); both GEMMs ride `ft_batched_dot`, each under its site's
    campaign key, ``subkey(site)`` (`Ctx.subkey`)."""
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    n_rep = h // kvh
    scale = dh ** -0.5
    kT = k.permute(0, 2, 3, 1)                           # (B, KVH, dh, Sk)
    vT = v.permute(0, 2, 1, 3)                           # (B, KVH, Sk, dh)
    kpos = torch.arange(sk, device=q.device)
    chunk = min(chunk, sq)
    if sq % chunk != 0:
        chunk = sq
    outs = []
    for c0 in range(0, sq, chunk):
        qc = q[:, c0:c0 + chunk]
        c = qc.shape[1]
        qpos = q_offset + c0 + torch.arange(c, device=q.device)
        qg = qc.reshape(b, c, kvh, n_rep, dh).permute(0, 2, 3, 1, 4)
        qg = qg.reshape(b, kvh, n_rep * c, dh)
        scores = ft_batched_dot(qg, kT, ft=ft, key=subkey("attn_qk"),
                                site="attn_qk").float() * scale
        if causal:
            mask = (qpos[:, None] >= kpos[None, :]).repeat(n_rep, 1)
            scores = torch.where(mask[None, None], scores,
                                 torch.full_like(scores, NEG_INF))
        p = torch.softmax(scores, dim=-1).to(qc.dtype)
        out = ft_batched_dot(p, vT, ft=ft, key=subkey("attn_pv"),
                             site="attn_pv")
        out = out.reshape(b, kvh, n_rep, c, dh).permute(0, 3, 1, 2, 4)
        outs.append(out.reshape(b, c, h, dh))
    return torch.cat(outs, dim=1)


def _flash_summary(rep: torch.Tensor):
    return rep[..., 0].sum().to(torch.int32), rep[..., 5].max()


class _FlashAttn(torch.autograd.Function):
    """Flash attention over head-major operands q3 (B·H, Sq, dh), k3, v3
    (B·KVH, Sk, dh). Forward: the flash kernel (K2) with the saved (m, l);
    backward: the dQ (K3) and dK/dV (K4) kernels over them, every backward
    GEMM verified in-kernel. A campaign key is kept for the backward, which
    draws its own stream from it folded with 0x5B (the reference's
    `blocks.py:365`). Returns (out3, det, maxres)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, ft, causal, key, bwd_inject):
        from ..kernels import ops as kops
        out, m, l, rep = kops.flash_ft(q3, k3, v3, ft=ft, causal=causal,
                                       n_rep=q3.shape[0] // k3.shape[0],
                                       key=key, save_stats=True)
        ctx.save_for_backward(q3, k3, v3, out, m, l)
        ctx.ft, ctx.causal, ctx.bwd_inject = ft, causal, bwd_inject
        ctx.key = key
        det, maxres = _flash_summary(rep)
        ctx.mark_non_differentiable(det, maxres)
        return out, det, maxres

    @staticmethod
    def backward(ctx, g, _det, _maxres):
        from ..kernels import ops as kops
        q3, k3, v3, o3, m, l = ctx.saved_tensors
        dq, dk, dv, _, _ = kops.flash_ft_bwd(
            q3, k3, v3, o3, m, l, g.to(q3.dtype), ft=ctx.ft,
            causal=ctx.causal, n_rep=q3.shape[0] // k3.shape[0],
            key=fold_in(ctx.key, 0x5B), **(ctx.bwd_inject or {}))
        return (dq, dk.to(k3.dtype), dv.to(v3.dtype), None, None, None,
                None)


def _flash_attention(q, k, v, *, causal: bool, ft: FTConfig, key,
                     bwd_inject=None) -> torch.Tensor:
    """(B, Sq, H, dh) × (B, Sk, KVH, dh) → (B, Sq, H, dh) through the flash
    kernels on head-major operands, recording one fused "attn_flash"
    summary of the forward (both in-kernel GEMMs share one report) outside
    the autograd Function: backward corrections are applied, not counted.
    A campaign key draws in kernel, forward and backward."""
    from ..kernels import ops as kops
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    q3 = q.transpose(1, 2).reshape(b * h, sq, dh)
    k3 = k.transpose(1, 2).reshape(b * kvh, sk, dh)
    v3 = v.transpose(1, 2).reshape(b * kvh, sk, dh)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (q3, k3, v3)):
        out3, det, maxres = _FlashAttn.apply(q3, k3, v3, ft, causal, key,
                                             bwd_inject)
    else:
        out3, rep = kops.flash_ft(q3, k3, v3, ft=ft, causal=causal,
                                  n_rep=h // kvh, key=key)
        det, maxres = _flash_summary(rep)
    telemetry.record_summary(det, maxres, ft.corrects, site="attn_flash")
    return out3.reshape(b, h, sq, dh).transpose(1, 2)


def _use_flash(ctx: Ctx, ft: FTConfig, causal: bool, sq: int, sk: int,
               q_offset: int) -> bool:
    """The attention core of this call site (see `Ctx.attn_impl`): the
    flash kernel's causal mask is bottom-right aligned, so causal dispatch
    needs q_offset == Sk − Sq."""
    if ctx.attn_impl == "chunked":
        return False
    geometry_ok = not causal or (sk >= sq and sk - sq == q_offset)
    if ctx.attn_impl == "flash":
        if not geometry_ok:
            raise ValueError(
                f"attn_impl='flash' needs bottom-right-aligned causal "
                f"geometry (q_offset == Sk - Sq), got Sq={sq}, Sk={sk}, "
                f"q_offset={q_offset}")
        return True
    return ft.enabled and ft.backend == "pallas" and geometry_ok


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int, ctx: Ctx,
                      q_offset: int = 0) -> torch.Tensor:
    """Prefill attention core. q: (B, Sq, H, dh); k, v: (B, Sk, KVH, dh)."""
    fft = ctx.ft_for("attn_flash")
    fft = fft if fft.protect_attention else FT_OFF
    if _use_flash(ctx, fft, causal, q.shape[1], k.shape[1], q_offset):
        return _flash_attention(q, k, v, causal=causal, ft=fft,
                                key=ctx.subkey("attn_flash"),
                                bwd_inject=ctx.bwd_hook("attn_flash"))
    cft = ctx.ft_for("attn_qk")
    cft = cft if cft.protect_attention else FT_OFF
    return _chunked_core(q, k, v, causal=causal, chunk=chunk, ft=cft,
                         subkey=ctx.subkey, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     ctx: Ctx, *, site_prefix: str = "dec") -> torch.Tensor:
    """Single-position attention against a (B, Smax, KVH, dh) cache;
    positions ≥ length are masked. q: (B, 1, H, dh). GQA is grouped: the
    cache is never repeated. ``site_prefix`` labels the two cache GEMMs in
    telemetry (``{prefix}_qk`` / ``{prefix}_pv``): "dec" for the dense
    cache, "dec_page" for the gathered paged cache."""
    b, _, h, dh = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kvh
    qg = q.reshape(b, kvh, n_rep, dh)                    # (B, KVH, rep, dh)
    kT = k_cache.permute(0, 2, 3, 1)                     # (B, KVH, dh, S)
    scores = ctx.bdot(f"{site_prefix}_qk", qg, kT).float() * dh ** -0.5
    mask = torch.arange(s, device=q.device)[None, :] < length[:, None]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    if s % 8:
        # P's rows padded to a multiple of 8 positions (masked, so exactly
        # zero after the softmax) and sliced back: the PV product then
        # reads 16-byte aligned rows, as K5's tensor-core instance needs
        # (a cross cache of 1 500 encoder frames).
        scores = torch.nn.functional.pad(scores, (0, -s % 8), value=NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)[..., :s]
    out = ctx.bdot(f"{site_prefix}_pv", p, v_cache.transpose(1, 2))
    return out.reshape(b, 1, h, dh)


def _decode_ft(ctx: Ctx) -> FTConfig:
    ft = ctx.ft_for("dec_flash")
    return ft if ft.protect_attention else FT_OFF


def uses_decode_kernel(ctx: Ctx, head_dim: int) -> bool:
    """Whether `paged_decode_attention` takes the paged decode kernel K6
    under ``ctx`` for heads of ``head_dim`` (the rule in its docstring)."""
    ft = _decode_ft(ctx)
    return (ctx.attn_impl != "chunked" and head_dim % 128 == 0
            and (ctx.attn_impl == "flash"
                 or (ft.enabled and ft.backend == "pallas")))


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           page_table: torch.Tensor, ctx: Ctx
                           ) -> torch.Tensor:
    """Single-position attention against one layer of the paged KV cache
    (`train.kv_cache`). q (B, 1, H, dh); k_pages, v_pages (P, KVH, page,
    dh) page pools; lengths int32 (B,) true kv lengths; page_table int32
    (B, max_pages) pool pages per slot (NULL-padded).

    The paged decode kernel K6 runs when ``ctx.attn_impl`` is not
    "chunked", dh is a multiple of 128, and either ``attn_impl`` is "flash"
    or FT is on the pallas backend: one launch that reads each slot's pages
    through the table, both in-kernel GEMMs verified, recorded as the one
    telemetry site "dec_flash". Otherwise the pages are gathered to the
    dense (B, S, KVH, dh) layout and `decode_attention` runs, recording
    "dec_page_qk" / "dec_page_pv"."""
    from ..kernels import ops as kops
    from ..train import kv_cache
    ft = _decode_ft(ctx)
    if uses_decode_kernel(ctx, q.shape[-1]):
        out, rep = kops.flash_ft_decode(q[:, 0], k_pages, v_pages, lengths,
                                        page_table, ft=ft,
                                        key=ctx.subkey("dec_flash"))
        det, maxres = _flash_summary(rep)
        telemetry.record_summary(det, maxres, ft.corrects, site="dec_flash")
        return out[:, None]
    kd = kv_cache.gather_layer(k_pages, page_table)
    vd = kv_cache.gather_layer(v_pages, page_table)
    return decode_attention(q, kd, vd, lengths, ctx, site_prefix="dec_page")


def attention(p, x: torch.Tensor, cfg, ctx: Ctx, *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              kv: Optional[torch.Tensor] = None,
              chunk: int = 512) -> torch.Tensor:
    """Full attention block, self- or (with ``kv`` (B, S_kv, d), the
    encoder's output) cross-attention. x: (B, S, d); ``p`` holds
    wq/wk/wv/wo (and bq/bk/bv with qkv bias); k and v are projected from
    ``kv`` when given, and RoPE applies to self-attention only."""
    b, s, _ = x.shape
    src = x if kv is None else kv
    q = ctx.dot_fused("wq", x, p["wq"], bias=p.get("bq"))
    k = ctx.dot_fused("wk", src, p["wk"], bias=p.get("bk"))
    v = ctx.dot_fused("wv", src, p["wv"], bias=p.get("bv"))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, src.shape[1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, src.shape[1], cfg.n_kv_heads, cfg.head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, chunk=chunk, ctx=ctx)
    return ctx.dot("wo", out.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLP (SwiGLU), embedding, head
# ---------------------------------------------------------------------------

def mlp(p, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    g = ctx.dot_fused("w_gate", x, p["w_gate"], act="silu")  # fused epilogue
    u = ctx.dot("w_up", x, p["w_up"])
    return ctx.dot("w_down", g * u, p["w_down"])


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_head(x: torch.Tensor, table: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return ctx.dot("lm_head", x, table)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1) -> torch.Tensor:
    """Mean CE over positions with label != ignore, in f32. logits
    (…, V)."""
    logits = logits.float()
    mask = labels != ignore
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
