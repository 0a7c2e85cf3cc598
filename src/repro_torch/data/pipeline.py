"""Deterministic, shardable synthetic-token data pipeline (a numpy-only
copy of `repro.data.pipeline`; the port imports nothing of the reference).

Production properties this substrate provides:
  * O(1) resume — `batch_at(step)` is a pure function of (seed, step), so a
    restart from checkpoint step N replays exactly the data the failed run
    would have seen (no file offsets to persist);
  * host sharding — each host materializes only its `[host_id::n_hosts]`
    slice of the global batch (what a multi-host TPU pod loader does);
  * background prefetch — a one-slot lookahead thread overlaps host-side
    batch synthesis with device compute.

Tokens are Zipf-distributed (vocab realism for embedding-gather benches);
labels are next-token shifted.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 n_patches: int = 0, n_frames: int = 0, d_model: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq = seq_len
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.n_patches = n_patches
        self.n_frames = n_frames
        self.d_model = d_model

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s = self.local_batch, self.seq
        # Zipf-ish: inverse-CDF of a power law over the vocab
        u = rng.random((b, s + 1))
        ranks = np.floor((self.vocab ** u - 1.0)).astype(np.int64)
        tokens = np.clip(ranks, 0, self.vocab - 1).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.n_patches:
            out["patches"] = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32) * 0.02
        if self.n_frames:
            out["frames"] = rng.standard_normal(
                (b, self.n_frames, self.d_model)).astype(np.float32) * 0.02
        return out

    def iter_from(self, start_step: int, prefetch: int = 1
                  ) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator, resumable at any step."""
        if prefetch <= 0:
            step = start_step
            while True:
                yield self.batch_at(step)
                step += 1
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def for_model(cfg, shape, *, seed: int = 0, host_id: int = 0,
              n_hosts: int = 1, batch: Optional[int] = None) -> TokenPipeline:
    b = batch if batch is not None else shape.global_batch
    return TokenPipeline(
        vocab_size=cfg.vocab_size, global_batch=b, seq_len=shape.seq_len,
        seed=seed, host_id=host_id, n_hosts=n_hosts,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        n_frames=cfg.n_audio_frames if cfg.family == "encdec" else 0,
        d_model=cfg.d_model)
