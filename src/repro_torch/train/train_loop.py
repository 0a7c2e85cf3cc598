"""Training step and host loop (counterpart of `repro.train.train_loop`).

`make_train_step` builds the step
    (params, opt_state, batch, step) → (params, opt_state, metrics)
with every GEMM of the forward and the backward, and the attention in both
directions, protected per `RunConfig.ft` (the CUDA kernels on the "pallas"
backend), the forward's `FTReport` in the metrics, and gradient-
accumulation microbatching. The step updates the parameters and the AdamW
state in place (`optim.adamw.apply`) and returns the same objects.

`train` is the host loop: the synthetic data pipeline, the step, the
straggler watchdog and a SIGTERM stop at the step boundary, and the
stochastic SEU campaign: with ``inject_every`` = N, every N-th step runs
under the key ``torch.Generator().manual_seed(step)`` (the reference's
``PRNGKey(step)``) at ``run.ft.inject_rate``. Checkpoints and resume,
gradient compression and the metrics sink are not ported: asking for them
raises.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..core import telemetry
from ..data import pipeline as data_lib
from ..models import model_zoo
from ..models.blocks import Ctx
from ..optim import adamw, schedule
from .serve import check_device, compute_dtype


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    warmup_steps: int = 100
    log_every: int = 10
    compress_grads: bool = False
    inject_every: int = 0        # inject SEUs every N steps (0 = never)


def _check_train_config(tc: TrainConfig) -> None:
    if tc.compress_grads:
        raise NotImplementedError("gradient compression is not ported")


def inject_key(tc: TrainConfig, step: int) -> Optional[torch.Generator]:
    """The campaign key of ``step``: a generator seeded with the step on
    every ``inject_every``-th step, None on the others."""
    if not (tc.inject_every and step % tc.inject_every == 0):
        return None
    return torch.Generator().manual_seed(step)


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    opt_cfg: adamw.AdamWConfig, tc: TrainConfig) -> Callable:
    """The train step of the model family under ``run``'s FT policy, dtype,
    remat policy and microbatching. ``batch`` holds "tokens" and "labels"
    (B, S) on the parameters' device; ``step`` drives the LR schedule
    (lr 0 at step 0); ``inject_key`` (`inject_key`) runs the step under a
    stochastic SEU campaign at ``run.ft.inject_rate``."""
    _check_train_config(tc)
    mod = model_zoo.module_for(cfg)
    dtype = compute_dtype(run)
    remat = run.remat if run.remat != "none" else False

    def loss_and_grad(params, batch, ctx):
        loss, metrics = mod.loss_fn(params, batch, cfg, ctx, remat=remat,
                                    chunk=run.attn_chunk)
        loss.backward()
        return loss.detach(), metrics

    def train_step(params, opt_state, batch, step, inject_key=None):
        ctx = Ctx(ft=run.ft, key=inject_key, dtype=dtype,
                  attn_impl=run.attn_impl)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if run.microbatch and run.microbatch > 1:
            n_micro = run.microbatch
            micro = [dict(zip(batch, parts)) for parts in
                     zip(*(torch.chunk(v, n_micro) for v in batch.values()))]
            # Gradients accumulate in f32, as the reference's scan does.
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            losses, mets = [], []
            for mb in micro:
                loss, m = loss_and_grad(params, mb, ctx)
                for k, p in named.items():
                    grads[k] += p.grad.float()
                    p.grad = None
                losses.append(loss)
                mets.append(m)
            grads = {k: g / n_micro for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            # FT counters SUM across microbatches; float metrics average.
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0] if k != "ft"}
            metrics["ft"] = telemetry.reduce_microbatch(
                [m["ft"] for m in mets])
        else:
            loss, metrics = loss_and_grad(params, batch, ctx)
            grads = {k: p.grad for k, p in named.items()}
        lr_scale = schedule.warmup_cosine(
            step, warmup=tc.warmup_steps, total=tc.total_steps).to(loss.device)
        params, adam_state, opt_metrics = adamw.apply(
            params, grads, opt_state["adam"], opt_cfg, lr_scale)
        for p in named.values():
            p.grad = None
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, {"adam": adam_state}, metrics

    return train_step


def init_opt_state(params, opt_cfg: adamw.AdamWConfig,
                   tc: TrainConfig) -> Dict[str, Any]:
    _check_train_config(tc)
    return {"adam": adamw.init(params, opt_cfg)}


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------

class Watchdog:
    """Step-time straggler detector: flags steps slower than
    mean + k·std over a trailing window."""

    def __init__(self, window: int = 50, k: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window, self.k, self.clock = window, k, clock
        self.times: List[float] = []
        self.stragglers: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        dt = self.clock() - self._t0
        hist = self.times[-self.window:]
        slow = False
        if len(hist) >= 10:
            mean = sum(hist) / len(hist)
            var = sum((x - mean) ** 2 for x in hist) / len(hist)
            slow = dt > mean + self.k * (var ** 0.5) and dt > 1.5 * mean
            if slow:
                self.stragglers.append((step, dt, mean))
        self.times.append(dt)
        return slow


def train(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
          tc: TrainConfig, *, batch_override: Optional[int] = None,
          ckpt_dir: Optional[str] = None, resume: bool = False,
          stop_at: Optional[int] = None,
          log: Callable[[str], None] = print, sink=None,
          device="cuda") -> Dict[str, Any]:
    """End-to-end training on one device (`launch/train.py` calls this):
    random parameters from ``run.seed``, AdamW, the synthetic pipeline.
    Returns {"params", "opt_state", "history", "stragglers", "step_times",
    "final_step"}; ``history`` has one entry per logged step (loss, the MoE
    load-balance loss "aux", grad_norm, lr and the step's FT counters)."""
    if ckpt_dir is not None or resume:
        raise NotImplementedError("checkpoints and resume are not ported")
    if sink is not None:
        raise NotImplementedError("the metrics sink is not ported")
    _check_train_config(tc)
    dev = check_device(device)
    mod = model_zoo.module_for(cfg)
    opt_cfg = adamw.AdamWConfig(
        lr=run.learning_rate, weight_decay=run.weight_decay,
        grad_clip=run.grad_clip, q8=(run.opt_state == "q8"))
    params = mod.init(cfg, seed=run.seed, dtype=compute_dtype(run),
                      device=dev)
    params.requires_grad_(True)
    opt_state = init_opt_state(params, opt_cfg, tc)
    step_fn = make_train_step(cfg, run, opt_cfg, tc)
    pipe = data_lib.for_model(cfg, shape, seed=run.seed,
                              batch=batch_override)
    wd = Watchdog()
    history: List[Dict[str, float]] = []
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    old = signal.signal(signal.SIGTERM, on_sigterm)
    end_step = min(stop_at, tc.total_steps) if stop_at else tc.total_steps
    step = -1
    try:
        it = pipe.iter_from(0)
        for step in range(end_step):
            batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                     for k, v in next(it).items()}
            wd.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step, inject_key(tc, step))
            loss = float(metrics["loss"])          # waits for the step
            slow = wd.stop(step)
            ft = metrics["ft"]
            if step % tc.log_every == 0 or step == tc.total_steps - 1:
                msg = (f"step {step:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"sdc_det {int(ft.detected)} "
                       f"sdc_fix {int(ft.corrected)}")
                if slow:
                    msg += " [STRAGGLER]"
                log(msg)
                history.append({"step": step, "loss": loss,
                                "aux": float(metrics["aux"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "lr": float(metrics["lr"]),
                                "detected": float(ft.detected),
                                "corrected": float(ft.corrected)})
            if preempted["flag"]:
                log(f"SIGTERM at step {step}: stopping (checkpoints are not "
                    f"ported)")
                break
    finally:
        signal.signal(signal.SIGTERM, old)
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": wd.stragglers, "step_times": wd.times,
            "final_step": step + 1}
