"""Serving launcher: batched generation with the FT-protected decode path
(counterpart of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --batch 4 --prompt-len 128 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b-smoke \
        --device cpu --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch arctic-480b-smoke --device cpu --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --batch 4 --prompt-len 16 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2-780m-smoke --device cpu --dtype float32

The arch ids are those of `configs.registry`: the dense family, the MoE
family (qwen3-moe-235b-a22b, arctic-480b), mamba2-780m (the SSM family)
and whisper-medium, whose frame embeddings (the frontend stub) are drawn
from the seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..configs.base import RunConfig
from ..core import telemetry
from ..core.policy import FT_OFF, ONLINE_BLOCK
from ..models import model_zoo
from ..train import serve as serve_lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--no-ft", action="store_true")
    ap.add_argument("--backend", choices=("pallas", "xla"), default="pallas",
                    help="pallas: the CUDA kernels; xla: torch-op ABFT")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = serve_lib.check_device(args.device)
    if args.arch.endswith("-smoke"):
        cfg = registry.get_smoke(args.arch[:-len("-smoke")])
    else:
        cfg = registry.get_config(args.arch)
    ft = FT_OFF if args.no_ft else ONLINE_BLOCK.replace(backend=args.backend)
    run = RunConfig(model=cfg, ft=ft, dtype=args.dtype)
    mod = model_zoo.module_for(cfg)
    params = mod.init(cfg, seed=args.seed, dtype=serve_lib.compute_dtype(run),
                      device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(args.batch, cfg.n_audio_frames,
                                  cfg.d_model)).astype(np.float32)
    sc = serve_lib.ServeConfig(max_len=args.max_len,
                               temperature=args.temperature)
    t0 = time.perf_counter()
    with telemetry.ft_scope() as scope:
        out = serve_lib.generate(params, prompts, cfg, run, sc,
                                 max_new_tokens=args.new_tokens,
                                 extra=frames, seed=args.seed, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        totals = scope.totals()
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s); FT totals {totals}")
    print(out[:, :12])


if __name__ == "__main__":
    main()
