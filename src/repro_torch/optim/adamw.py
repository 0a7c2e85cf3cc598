"""AdamW with f32 moments (counterpart of `repro.optim.adamw`).

The update is the reference's, leaf by leaf: global-norm clipping, bias-
corrected moments, decoupled weight decay on every leaf with ndim ≥ 2 —
the stacked (L, d) layer norms included, as in the reference. Unlike the
reference, `apply` updates the parameters and the moments in place, one
slice of the leading axis (one expert of a stacked expert leaf) at a time,
so the optimizer adds no full-size temporaries: the f32 m and v of a 4.45 B-parameter model (35.6 GB) and its
bf16 weights and gradients then fit one 80 GB card. The int8 moments of
the reference ("q8") are not ported and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    q8: bool = False


def _check(cfg: AdamWConfig) -> None:
    if cfg.q8:
        raise NotImplementedError("the int8 (q8) AdamW moments are not "
                                  "ported; use opt_state='f32'")


def init(params: nn.Module, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero f32 moments keyed by the parameters' `state_dict` names."""
    _check(cfg)
    named = list(params.named_parameters())
    dev = named[0][1].device
    return {
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    total = None
    for g in grads.values():
        # A stacked expert leaf (L, E, …) is summed one expert at a time.
        parts = _slices(g) if g.dim() >= 4 else [slice(None)]
        for sl in parts:
            sq = torch.sum(torch.square(g[sl].float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _slices(p: torch.Tensor, rows: int = 4096):
    """Slices of the leading axes that bound the update's temporaries: one
    expert of a stacked expert leaf (L, E, …), one layer of a stacked
    leaf, ``rows`` rows of a matrix, a vector whole."""
    if p.dim() >= 4:
        return [(i, j) for i in range(p.shape[0]) for j in range(p.shape[1])]
    if p.dim() >= 3:
        return list(range(p.shape[0]))
    if p.dim() == 2:
        return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]
    return [slice(None)]


@torch.no_grad()
def apply(params: nn.Module, grads: Mapping[str, torch.Tensor],
          state: Dict[str, Any], cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place on ``params`` and ``state``. ``grads`` maps
    the parameter names to their gradients. Returns (params, state,
    {"grad_norm", "lr"})."""
    _check(cfg)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    state["count"] = state["count"] + 1
    count = state["count"].float()
    b1c = 1.0 - torch.tensor(cfg.b1, device=count.device) ** count
    b2c = 1.0 - torch.tensor(cfg.b2, device=count.device) ** count
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=count.device) * cfg.lr
    for name, p in params.named_parameters():
        g_all, m_all, v_all = grads[name], state["m"][name], state["v"][name]
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        for sl in _slices(p):
            g = g_all[sl].float() * clip
            m, v = m_all[sl], v_all[sl]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            pf = p[sl].float()
            p[sl] = (pf - lr * (update + wd * pf)).to(p.dtype)
    return params, state, {"grad_norm": gnorm, "lr": lr}
