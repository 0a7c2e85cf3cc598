"""LR schedules (counterpart of `repro.optim.schedule`): pure functions of
the step counter, evaluated in f32 as the reference does."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1
                  ) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor`` × peak. Returns an f32
    scale in [0, 1] (0 at step 0) for the optimizer's base lr."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
