"""Serving engine: :class:`PagedServeEngine`, continuous batching over a
paged KV cache (docs/serving.md of the JAX package describes the design).

Requests are admitted from a FIFO queue whenever a batch slot, KV pages
and token budget are free, prefilled one at a time through power-of-two
buckets (at the exact prompt length for models with SSM layers), written
into the pools, and join the fixed-shape decode step on the very next
tick.  Finished sequences free their pages at
once.  The JAX package's legacy static-batch ``ServeEngine`` is not
ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import MAMBA, RunConfig
from repro_torch.models.model import Model
from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.serve.paged_cache import PagedKVCache, commit_prefill, pages_for
from repro_torch.serve.scheduler import FifoScheduler, Request
from repro_torch.train.train_step import (_act_dtype, make_paged_decode_step,
                                          make_paged_prefill_step)


def _bucket_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class PagedServeEngine:
    """Continuous batching over a paged KV cache, on the model's device.

    ``submit`` enqueues requests; each ``step`` admits whatever fits
    (prefill + commit + first token), runs ONE decode tick for all
    active slots, and returns the requests that finished on this tick.
    ``serve`` drives steps until everything submitted has completed.

    Prompt buckets: right-padded to the smallest power-of-two multiple of
    the page size (keys past the true length are never attended).  A
    model with SSM layers prefills at the exact prompt length instead:
    padding would run through the recurrence and change the state.

    ``samples`` keeps the raw TTFT and decode-tick times (ms), the one
    record of both; ``metrics`` carries request counters, admission
    rejects and pool gauges under the JAX engine's series names.
    ``decode_ticks`` counts the decode steps run.
    """
    model: Model
    run: RunConfig
    page: int = 16
    n_pages: int = 256
    max_slots: int = 8
    max_pages: Optional[int] = None        # per-seq page cap = max seq len
    max_tokens: Optional[int] = None       # live-token budget (scheduler)
    metrics: Optional[MetricsRegistry] = None

    def __post_init__(self):
        cfg = self.model.cfg
        assert not cfg.is_encoder_decoder and not cfg.n_image_tokens, \
            "paged engine serves decoder-only LMs"
        self.device = next(self.model.parameters()).device
        if self.max_pages is None:
            self.max_pages = max(1, (self.n_pages - 1) // self.max_slots)
        if self.max_tokens is None:
            self.max_tokens = (self.n_pages - 1) * self.page
        self.kv = PagedKVCache.build(
            cfg, page=self.page, n_pages=self.n_pages,
            max_slots=self.max_slots, max_pages=self.max_pages,
            dtype=_act_dtype(self.run),    # the paged kernel takes q's dtype
            device=self.device)
        self.sched = FifoScheduler(self.max_tokens)
        self._exact_prefill = any(
            s.kind == MAMBA for g in cfg.schedule for s in g.pattern)
        self._prefill = make_paged_prefill_step(self.model, self.run)
        self._decode = make_paged_decode_step(self.model, self.run, self.page)
        self._active: Dict[int, Request] = {}
        self._next_tok = np.zeros((self.max_slots,), np.int32)
        self._positions = np.zeros((self.max_slots,), np.int32)
        self._next_rid = 0
        self._step_count = 0
        self.decode_ticks = 0
        self._gen = torch.Generator(device=self.device)   # temperature > 0
        self._gen.manual_seed(0)
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        self.samples: Dict[str, List[float]] = {"ttft_ms": [],
                                                "decode_tick_ms": []}
        self._submit_t: Dict[int, float] = {}

    # ---- introspection ----------------------------------------------
    def utilization(self) -> float:
        return self.kv.utilization()

    def _update_gauges(self) -> None:
        m = self.metrics
        m.gauge("serve_kv_utilization").set(self.kv.utilization())
        m.gauge("serve_queue_depth").set(len(self.sched.queue))
        m.gauge("serve_live_tokens").set(self.sched.live_tokens)
        m.gauge("serve_active_slots").set(len(self._active))
        for reason, n in self.sched.rejects.items():
            m.gauge(f"serve_admission_rejects_{reason}").set(n)

    # ---- submission --------------------------------------------------
    def submit(self, tokens: Sequence[int], max_new: int,
               arrival: float = 0.0) -> int:
        total = len(tokens) + max_new
        cap = self.max_pages * self.page
        if total > cap:     # would wait in the queue forever
            raise ValueError(
                f"request needs {total} tokens > per-sequence capacity "
                f"{cap} (max_pages={self.max_pages} x page={self.page})")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid=rid, tokens=list(tokens),
                                  max_new=max_new, arrival=arrival))
        self._submit_t[rid] = time.perf_counter()
        self.metrics.counter("serve_requests_submitted").inc()
        return rid

    # ---- internals ---------------------------------------------------
    def _bucket(self, L: int) -> int:
        if self._exact_prefill:
            return L
        return _bucket_pow2(pages_for(L, self.page)) * self.page

    def _sample(self, logits, temperature: float) -> np.ndarray:
        """(N, V) logits on the device -> (N,) token ids on the host."""
        if temperature <= 0.0:
            return logits.argmax(-1).cpu().numpy()
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].cpu().numpy()

    def _admit(self, params, req: Request, temperature: float) -> None:
        L = len(req.tokens)
        slot = self.kv.admit(req.total_len)
        padded = np.zeros((1, self._bucket(L)), np.int64)
        padded[0, :L] = req.tokens
        logits, cache = self._prefill(
            params, torch.from_numpy(padded).to(self.device), L)
        pages = self.kv.slot_pages[slot][:pages_for(L, self.page)]
        commit_prefill(self.kv.pools, cache, self.model.cfg, page=self.page,
                       slot=slot, pages=torch.tensor(pages, device=self.device))
        tok = int(self._sample(logits[:, -1], temperature)[0])
        t_sub = self._submit_t.pop(req.rid, None)
        if t_sub is not None:  # host-visible first token: TTFT
            ms = (time.perf_counter() - t_sub) * 1e3
            self.samples["ttft_ms"].append(ms)
        req.out.append(tok)
        req.slot = slot
        if req.max_new == 1:
            self._finish(req)
            self._done_now.append(req)
            return
        self._active[slot] = req
        self._next_tok[slot] = tok
        self._positions[slot] = L

    def _finish(self, req: Request) -> None:
        req.finish_step = self._step_count
        self.kv.release(req.slot)
        self.sched.release(req)
        self._active.pop(req.slot, None)
        self.metrics.counter("serve_requests_finished").inc()

    # ---- the engine loop --------------------------------------------
    @torch.inference_mode()
    def step(self, params=None, temperature: float = 0.0) -> List[Request]:
        """Admit what fits, run one decode tick, return finished requests.
        ``params`` defaults to the engine's model."""
        params = self.model if params is None else params
        self._step_count += 1
        self._done_now: List[Request] = []
        while True:
            req = self.sched.try_admit(self.kv)
            if req is None:
                break
            self._admit(params, req, temperature)
        if not self._active:
            self._update_gauges()
            return self._done_now
        t0 = time.perf_counter()
        logits, _ = self._decode(
            params, self.kv.pools,
            torch.from_numpy(self._next_tok[:, None].astype(np.int64)).to(self.device),
            torch.from_numpy(self._positions).to(self.device),
            self.kv.tables())
        toks = self._sample(logits[:, 0], temperature)  # host copy: the tick ends
        ms = (time.perf_counter() - t0) * 1e3
        self.decode_ticks += 1
        self.samples["decode_tick_ms"].append(ms)
        done = self._done_now
        for slot, req in list(self._active.items()):
            tok = int(toks[slot])
            req.out.append(tok)
            self._positions[slot] += 1
            self._next_tok[slot] = tok
            if len(req.out) >= req.max_new:
                self._finish(req)
                done.append(req)
        self._update_gauges()
        return done

    def serve(self, params=None, temperature: float = 0.0,
              max_steps: int = 100000) -> Dict[int, List[int]]:
        """Drive steps until queue and batch drain; returns rid -> tokens."""
        finished: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.sched.queue and not self._active:
                break
            for req in self.step(params, temperature):
                finished[req.rid] = req.out
        return finished
