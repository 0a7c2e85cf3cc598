"""Continuous-batching FT serving engine over the paged KV cache
(counterpart of `repro.train.engine`).

`train/serve.py` is the slot-batch baseline: one prefill fills every slot
and decode runs until the whole batch finishes. This engine admits requests
into slots as they arrive (FIFO) whenever a slot and the page pool have
room; each admitted request runs its own unpadded batch-1 prefill, whose
keys and values are scattered into freshly allocated pages
(`kv_cache.write_prefill`). Every decode step is one
`transformer.paged_decode_step` over all slots — one paged decode kernel
(K6) launch per layer, dead slots riding along into the null page — and a
finished slot returns its pages to the free list at once.

Length protocol (the reference's): `PageAllocator.ensure(slot, cur_len + 1)`
reserves the page of the incoming token before each step, while the device
sees ``cur_len``, the tokens already in the cache. Per step the page table
and the lengths go host → device as int32 tensors, and the greedy sample is
the one device → host synchronisation.

Everything runs on ``device`` ("cuda" by default; the engine never moves
to the CPU on its own) under `torch.inference_mode()`. FT telemetry goes to
the caller's `core.telemetry.ft_scope`, if one is open: every prefill and
decode call records its per-site summaries there, "dec_flash" included.
The reference's metrics sink is not part of this package. Temperature
sampling draws from a `torch.Generator` seeded from `EngineConfig.seed`
(other numbers than the reference's PRNG; greedy decoding is what the
conformance tests compare).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import transformer as tfm
from ..models.blocks import Ctx, uses_decode_kernel
from . import kv_cache
from .serve import check_device, compute_dtype


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    t_submit: float = 0.0


@dataclasses.dataclass
class Result:
    rid: int
    prompt_len: int
    tokens: List[int]             # generated tokens (eos included if hit)
    ttft_s: float                 # submit → first token (prefill) latency


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 512            # prompt + generated ceiling per request
    n_slots: int = 8
    max_new_tokens: int = 32      # default per-request budget
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = -1              # -1 = never stop early
    page_size: Optional[int] = None   # None = kv_cache.DEFAULT_PAGE
    slack: float = 1.0            # pool oversubscription (<1 may exhaust)
    seed: int = 0


class ServeEngine:
    """Continuous-batching serving engine for the transformer KV layout.

    Usage::

        eng = ServeEngine(params, cfg, run, EngineConfig(...))
        eng.submit(prompt_a); eng.submit(prompt_b)
        results = eng.run()           # or: while eng.step(): ...

    ``params`` must already live on ``device``. ``clock`` (seconds, as
    `time.perf_counter`) stamps submissions and first tokens, so TTFT is
    read on the caller's clock. On a CUDA device, a page size that the
    paged decode kernel K6 does not compile raises here when the decode
    steps will launch K6."""

    def __init__(self, params, cfg: ModelConfig, run: RunConfig,
                 ec: EngineConfig, *, device="cuda",
                 clock=time.perf_counter):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"paged serving needs the transformer KV layout; family "
                f"{cfg.family!r} is a ROADMAP follow-up")
        self.params = params
        self.cfg = cfg
        self.ec = ec
        self._clock = clock
        self.dtype = compute_dtype(run)
        self.ctx = Ctx(ft=run.ft, key=None, dtype=self.dtype,
                       attn_impl=run.attn_impl)
        self.plan = kv_cache.plan_pages(
            n_slots=ec.n_slots, max_len=ec.max_len, dtype=self.dtype,
            page_size=ec.page_size, slack=ec.slack)
        # A page K6 does not compile would only raise at the first decode
        # step, after the prefills: refuse it here.
        if torch.device(device).type == "cuda" and \
                uses_decode_kernel(self.ctx, cfg.head_dim):
            kv_cache.check_decode_page(self.plan.page_size)
        self.dev = check_device(device)
        p = self.plan
        self.alloc = kv_cache.PageAllocator(p.n_pages, p.n_slots,
                                            p.max_pages, p.page_size)
        self.cache = kv_cache.init_paged_cache(
            cfg.n_layers, p.n_pages, p.n_slots, p.max_pages, cfg.n_kv_heads,
            p.page_size, cfg.head_dim, self.dtype, self.dev)
        n = ec.n_slots
        self.cur_len = np.zeros((n,), np.int32)     # prompt + decoded so far
        self.next_tok = np.zeros((n,), np.int32)    # sampled, not yet in KV
        self.n_new = np.zeros((n,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n
        self.gen: List[List[int]] = [[] for _ in range(n)]
        self.ttft: List[float] = [0.0] * n
        self.queue: Deque[Request] = collections.deque()
        self.results: List[Result] = []
        self._rid = 0
        self._gen = torch.Generator(device=self.dev).manual_seed(ec.seed)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mnt = self.ec.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if mnt < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + mnt > self.plan.max_len:
            raise ValueError(
                f"prompt_len {len(prompt)} + max_new {mnt} exceeds "
                f"max_len {self.plan.max_len}")
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, prompt, mnt, self._clock()))
        return rid

    # -- internals ---------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.ec.temperature <= 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / self.ec.temperature, -1)
            tok = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.results.append(Result(req.rid, len(req.prompt),
                                   list(self.gen[slot]), self.ttft[slot]))
        self.alloc.free_slot(slot)
        self.slot_req[slot] = None
        self.gen[slot] = []
        self.cur_len[slot] = 0
        self.next_tok[slot] = 0
        self.n_new[slot] = 0

    def _admit(self) -> None:
        """FIFO-admit queued requests while a slot AND pages are free: the
        request's batch-1 prefill, its KV scattered into fresh pages, and
        its first token sampled."""
        while self.queue and self.alloc.can_admit(len(self.queue[0].prompt)):
            req = self.queue.popleft()
            length = len(req.prompt)
            slot, _ = self.alloc.alloc_slot(length)
            dcache = tfm.init_cache(self.cfg, 1, length, self.dtype, self.dev)
            toks = torch.as_tensor(req.prompt[None], dtype=torch.long,
                                   device=self.dev)
            with torch.inference_mode():
                logits, dcache = tfm.prefill(self.params, toks, dcache,
                                             self.cfg, self.ctx)
                kv_cache.write_prefill(
                    self.cache, slot,
                    torch.as_tensor(self.alloc.page_table[slot],
                                    device=self.dev),
                    dcache["k"][:, 0], dcache["v"][:, 0], length)
            tok = int(self._sample(logits.reshape(1, -1))[0])
            self.slot_req[slot] = req
            self.cur_len[slot] = length
            self.next_tok[slot] = tok
            self.n_new[slot] = 1
            self.gen[slot] = [tok]
            self.ttft[slot] = self._clock() - req.t_submit
            if self._done(slot, tok):
                self._finish(slot)

    def _done(self, slot: int, tok: int) -> bool:
        req = self.slot_req[slot]
        return (self.n_new[slot] >= req.max_new_tokens
                or (self.ec.eos_id >= 0 and tok == self.ec.eos_id))

    # -- the engine loop ---------------------------------------------------

    def step(self) -> bool:
        """Admit what fits, then run ONE decode step over every slot.
        Returns False when the engine is drained (no live slot and an empty
        queue): ``while eng.step(): pass`` serves everything."""
        self._admit()
        live = [s for s in range(self.ec.n_slots)
                if self.slot_req[s] is not None]
        if not live:
            if self.queue:
                # An idle engine (every page free) that still cannot admit
                # the head request never will: fail instead of spinning.
                raise RuntimeError(
                    f"request rid={self.queue[0].rid} (prompt_len="
                    f"{len(self.queue[0].prompt)}) cannot be admitted even "
                    f"by an idle engine: page pool too small "
                    f"({self.alloc.n_free} free pages)")
            return False
        for s in live:
            self.alloc.ensure(s, int(self.cur_len[s]) + 1)
        self.cache["page_table"] = torch.as_tensor(self.alloc.page_table,
                                                   device=self.dev)
        self.cache["length"] = torch.as_tensor(self.cur_len, device=self.dev)
        tok = torch.as_tensor(self.next_tok[:, None], dtype=torch.long,
                              device=self.dev)
        with torch.inference_mode():
            logits, self.cache = tfm.paged_decode_step(
                self.params, tok, self.cache, self.cfg, self.ctx)
        nxt = self._sample(logits.reshape(self.ec.n_slots, -1))
        for s in live:
            self.cur_len[s] += 1
            t = int(nxt[s])
            self.next_tok[s] = t
            self.gen[s].append(t)
            self.n_new[s] += 1
            if self._done(s, t):
                self._finish(s)
        return True

    def run(self) -> List[Result]:
        """Drain the queue; returns results sorted by request id."""
        while self.step():
            pass
        self.alloc.check_invariants()
        return sorted(self.results, key=lambda r: r.rid)
