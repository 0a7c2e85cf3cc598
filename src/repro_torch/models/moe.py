"""Mixture-of-Experts layer with two dispatch regimes (counterpart of
`repro.models.moe`).

Default: **grouped ragged dispatch** — every (token, slot) assignment is
routed to its expert's group in one group-sorted buffer
(`kernels.grouped.layout`), and the three expert-FFN GEMMs run as
`core.ft_grouped_matmul_buffer` over it: on the pallas backend the grouped
ABFT kernel K7 forward (and in the backward K7 for dbuf, K8 for dw), with
zero capacity padding and no dropped tokens; an SEU in one expert's rows
cannot reach a neighbour's.

Baseline (``MoEConfig.dispatch="padded"``): the GShard/Switch capacity
dispatch — one-hot dispatch and combine einsums around per-expert batched
GEMMs (`core.ft_batched_dot`, the uniform batched kernel K5), every expert
padded (and overflow dropped) to the same capacity.

The router product stays a plain f32 `torch.matmul`, as the reference's is
a plain einsum outside any kernel; dispatch and combine data movement is
not ABFT-protected (memory faults are ECC's, as in the paper's fault
model). Parameters are stacked per layer like the rest of the model:
router (L, d, E) f32, w_gate / w_up (L, E, d, f), w_down (L, E, f, d).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..core.ft_gemm import (ft_batched_dot, ft_grouped_matmul_buffer,
                            grouped_row_tile)
from ..kernels.grouped import layout as glayout
from .blocks import Ctx


def init_moe(gen: torch.Generator, d: int, mc: MoEConfig, n_layers: int,
             dtype, device="cuda") -> Dict[str, torch.Tensor]:
    """Stacked MoE parameters of ``n_layers`` layers from a seeded
    generator, in the reference's layout and scales; each leaf is drawn one
    layer at a time, so the f32 draw never exceeds one layer's leaf."""
    e, f = mc.n_experts, mc.expert_d_ff
    scale = 0.02
    down_scale = scale / math.sqrt(2 * n_layers)

    def stacked(shape, s, dt):
        t = torch.empty((n_layers,) + shape, dtype=dt, device=device)
        for i in range(n_layers):
            t[i] = (torch.randn(shape, generator=gen, device=device)
                    * s).to(dt)
        return t

    return {"router": stacked((d, e), scale, torch.float32),
            "w_gate": stacked((e, d, f), scale, dtype),
            "w_up": stacked((e, d, f), scale, dtype),
            "w_down": stacked((e, f, d), down_scale, dtype)}


def capacity(group: int, mc: MoEConfig) -> int:
    c = max(1, -(-int(group * mc.top_k * mc.capacity_factor)
                 // mc.n_experts))
    # lane-align only when it doesn't dominate (tiny decode groups)
    return ((c + 3) // 4) * 4 if c >= 4 else c


def _group_geometry(b: int, s: int, mc: MoEConfig) -> int:
    """The dispatch group size of the padded regime, the reference's rule
    (groups follow the (B, S) token grid; ≥ 16 groups along the sequence
    where it divides)."""
    g = min(mc.group_size, b * s)
    if s >= 2:
        n_seq = s // g if g and s % g == 0 else 0
        if n_seq == 0 or (n_seq < 16 and s >= 16 and s % 16 == 0):
            g = max(s // 16, 1)
        if s % g != 0:
            g = s
    else:
        g = min(g, b)
        if b % g != 0:
            g = b
    return g


def _routing(xt: torch.Tensor, router: torch.Tensor, mc: MoEConfig):
    """Shared router math. xt (T, d) → (gate_vals (T, k) f32, idx (T, k),
    aux loss): f32 logits, softmax, top-k renormalised, and the Switch
    load-balance term E·Σ f_e·P_e."""
    e = mc.n_experts
    logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, mc.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    me = probs.mean(0)
    ce = F.one_hot(idx[..., 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return gate_vals, idx, aux


def apply_moe(p: Dict[str, Any], x: torch.Tensor, mc: MoEConfig,
              ctx: Ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y, aux loss)."""
    if mc.dispatch == "padded":
        return apply_moe_padded(p, x, mc, ctx)
    if mc.dispatch != "grouped":
        raise ValueError(f"MoEConfig.dispatch must be 'grouped' or "
                         f"'padded', got {mc.dispatch!r}")
    return apply_moe_grouped(p, x, mc, ctx)


def apply_moe_grouped(p: Dict[str, Any], x: torch.Tensor, mc: MoEConfig,
                      ctx: Ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route every (token, slot) assignment to its expert's ragged group and
    run gate, up and down as protected grouped GEMMs over ONE group-sorted
    buffer: scatter once, three GEMMs in buffer space (silu·up is
    elementwise, so dead buffer rows stay zero), gather once, then the
    gate-weighted combine of each token's k outputs."""
    b, s, d = x.shape
    e, f = mc.n_experts, mc.expert_d_ff
    xt = x.reshape(b * s, d)
    gate_vals, idx, aux = _routing(xt, p["router"], mc)
    t, k = idx.shape
    expert_ids = idx.reshape(t * k)
    rows = torch.arange(t, device=x.device).repeat_interleave(k)
    # The layout's row tile is the one the first buffer GEMM resolves to.
    bm = grouped_row_tile(t * k, f, d, x.dtype, e, ctx.ft, site="moe_gate")
    lay = glayout.make_layout(expert_ids, e, bm)
    buf = glayout.scatter_rows(xt[rows], lay)                # (t_buf, d)

    def ffn(name, a, w):
        return ft_grouped_matmul_buffer(a, w, lay.gid, lay.row_end,
                                        ft=ctx.ft, key=ctx.subkey(name),
                                        bwd_inject=ctx.bwd_hook(name),
                                        site=name)

    gate_h = ffn("moe_gate", buf, p["w_gate"])
    up_h = ffn("moe_up", buf, p["w_up"])
    h = (F.silu(gate_h.float()) * up_h.float()).to(x.dtype)
    y_buf = ffn("moe_down", h, p["w_down"])                  # (t_buf, d)
    ya = glayout.gather_rows(y_buf, lay)                     # (T·k, d)
    y = torch.sum(ya.reshape(t, k, d).float() * gate_vals[..., None],
                  dim=1).to(x.dtype)
    return y.reshape(b, s, d), aux


def apply_moe_padded(p: Dict[str, Any], x: torch.Tensor, mc: MoEConfig,
                     ctx: Ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity-based one-hot dispatch baseline: every expert padded to
    the same capacity C, overflow tokens dropped; the expert GEMMs are
    protected batched GEMMs over (E, groups·C, d)."""
    b, s, d = x.shape
    e, top_k = mc.n_experts, mc.top_k
    g = _group_geometry(b, s, mc)
    n_grp = (b * s) // g
    xg = x.reshape(n_grp, g, d)
    c = capacity(g, mc)
    gate_vals, idx, aux = _routing(xg.reshape(-1, d), p["router"], mc)
    gate_vals = gate_vals.reshape(n_grp, g, top_k)
    idx = idx.reshape(n_grp, g, top_k)
    # Position of each (token, k) within its expert's queue; past C dropped.
    combine = torch.zeros(n_grp, g, e, c, device=x.device)
    fill = torch.zeros(n_grp, e, dtype=torch.long, device=x.device)
    for kk in range(top_k):
        oh = F.one_hot(idx[..., kk], e)                      # (n, g, E)
        pos = fill[:, None, :] + torch.cumsum(oh, dim=1) - oh
        keep = (pos < c) & (oh > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, c), c + 1)[..., :c].float()
        combine = combine + (pos_oh * oh[..., None]
                             * gate_vals[..., kk][..., None, None])
        fill = fill + oh.sum(1)
    dispatch = (combine > 0).to(x.dtype)                     # (n, g, E, C)
    xe = torch.einsum("ngec,ngd->necd", dispatch, xg)
    xe2 = xe.permute(1, 0, 2, 3).reshape(e, n_grp * c, d)

    def expert(name, a, w):
        return ft_batched_dot(a, w, ft=ctx.ft, key=ctx.subkey(name),
                              site=name)

    gate_h = expert("moe_gate", xe2, p["w_gate"])
    up_h = expert("moe_up", xe2, p["w_up"])
    yh = expert("moe_down", (F.silu(gate_h) * up_h).to(x.dtype),
                p["w_down"])
    ye = yh.reshape(e, n_grp, c, d).permute(1, 0, 2, 3)      # (n, E, C, d)
    y = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), ye)
    return y.reshape(b, s, d), aux
