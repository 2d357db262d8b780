"""Continuous-batching admission: FIFO queue with a token-budget policy.

Requests queue in arrival order; every engine step the scheduler admits
from the head of the queue while three resources hold out:

* a free batch slot (the decode step runs at a fixed ``max_slots``);
* enough free KV pages for the request's WORST CASE footprint,
  ``ceil((prompt + max_new) / page)`` — reserving up front means a
  running sequence can never deadlock mid-decode waiting for a page;
* the token budget: total live tokens (every admitted request counted
  at ``prompt + max_new``) stays under ``max_tokens``, which caps
  decode-step arithmetic independently of the page pool size.

Admission is strict FIFO — the scan stops at the first request that
does not fit, rather than letting small latecomers starve a large head
request.  Finished sequences release their slot and pages immediately
(see ``PagedServeEngine.step``), so freed capacity re-enters admission
on the very next step.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence


@dataclass
class Request:
    """One generation request."""
    rid: int
    tokens: Sequence[int]            # prompt token ids
    max_new: int
    arrival: float = 0.0             # submit time (bench clock)
    # filled in by the engine:
    out: List[int] = field(default_factory=list)
    slot: int = -1
    finish_step: int = -1

    @property
    def total_len(self) -> int:
        return len(self.tokens) + self.max_new


class FifoScheduler:
    """FIFO admission queue under a live-token budget."""

    def __init__(self, max_tokens: int):
        self.max_tokens = max_tokens
        self.queue: Deque[Request] = deque()
        self.live_tokens = 0         # sum of total_len over admitted reqs
        # admission-reject counts by resource (the head request was
        # blocked this many admission attempts) — exported as the
        # serve_admission_rejects_* metric series
        self.rejects = {"tokens": 0, "kv": 0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)

    def try_admit(self, kv) -> Optional[Request]:
        """Pop the head request if slot + pages + token budget allow it;
        ``kv`` is the :class:`~repro_torch.serve.paged_cache.PagedKVCache`."""
        if not self.queue:
            return None
        req = self.queue[0]
        if self.live_tokens + req.total_len > self.max_tokens:
            self.rejects["tokens"] += 1
            return None
        if not kv.can_admit(req.total_len):
            self.rejects["kv"] += 1
            return None
        self.queue.popleft()
        self.live_tokens += req.total_len
        return req

    def release(self, req: Request) -> None:
        self.live_tokens -= req.total_len
        assert self.live_tokens >= 0
