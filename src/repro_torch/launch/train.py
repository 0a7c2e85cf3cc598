"""Training launcher (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 4 --batch 2 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi4-mini-3.8b-smoke --device cpu --dtype float32 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-235b-a22b-smoke --device cpu --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi4-mini-3.8b-smoke --device cpu --dtype float32 --steps 3 \
        --inject-every 1 --inject-rate 0.5

Every GEMM of the step and the attention in both directions run through
the CUDA kernels ("--backend pallas", the default) or, on a CPU device,
their plain versions. The arch ids are those of `configs.registry`: the
dense family and the MoE family (qwen3-moe-235b-a22b, arctic-480b).
``--inject-every N`` runs every N-th step under a stochastic SEU campaign
at ``--inject-rate`` (per output block of each GEMM and flash-attention
kernel, both directions).
"""
from __future__ import annotations

import argparse

from ..configs import registry
from ..configs.base import RunConfig, ShapeConfig
from ..core.policy import FT_OFF, ONLINE_BLOCK
from ..train import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="arch id (append '-smoke' for the reduced config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-ft", action="store_true")
    ap.add_argument("--backend", choices=("pallas", "xla"), default="pallas",
                    help="pallas: the CUDA kernels; xla: torch-op ABFT")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--inject-every", type=int, default=0)
    ap.add_argument("--inject-rate", type=float, default=1e-3)
    args = ap.parse_args(argv)

    if args.arch.endswith("-smoke"):
        cfg = registry.get_smoke(args.arch[:-len("-smoke")])
    else:
        cfg = registry.get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    ft = FT_OFF if args.no_ft else ONLINE_BLOCK.replace(backend=args.backend)
    if args.inject_every > 0:
        ft = ft.replace(inject_rate=args.inject_rate)
    run = RunConfig(model=cfg, ft=ft, dtype=args.dtype,
                    learning_rate=args.lr, microbatch=args.microbatch,
                    attn_chunk=min(128, args.seq))
    tc = train_loop.TrainConfig(
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        inject_every=args.inject_every)
    out = train_loop.train(cfg, run, shape, tc, device=args.device)
    print(f"finished at step {out['final_step']}; "
          f"final loss {out['history'][-1]['loss']:.4f}; "
          f"stragglers {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
