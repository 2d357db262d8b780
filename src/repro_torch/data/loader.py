"""R3: parallel prefetching data loader with a tunable worker count.

The paper's recommendation: increase loader parallelism until accelerator
utilization stabilizes near 100% — "and no more".  ``PrefetchLoader``
exposes exactly that knob (``n_workers``) plus the utilization proxy the
tuning loop needs (``stall_fraction``: how often the consumer found the
queue empty).  ``tune_workers`` implements recommendation 3 as code.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.data.cache import StagedDataset
from repro_torch.observability import get_tracer


_SENTINEL = object()  # queued by stop() so a blocked consumer wakes up


class PrefetchLoader:
    def __init__(self, ds: StagedDataset, batch_size: int, *,
                 n_workers: int = 1, seq_len: Optional[int] = None,
                 prefetch: int = 4, seed: int = 0,
                 work_fn: Optional[Callable] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.n_workers = max(1, n_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.work_fn = work_fn          # per-batch CPU work (masking etc.)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: list = []
        self.batches_out = 0
        self.consumer_stalls = 0

    # -- worker ----------------------------------------------------------------
    def _worker(self, wid: int):
        rng = np.random.default_rng(self.seed + wid)
        n_shards = len(self.ds.shards)
        while not self._stop.is_set():
            si = int(rng.integers(0, n_shards))
            toks, mask = self.ds.read_shard(si)
            n = toks.shape[0]
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[i:i + self.batch_size]
                batch = {"tokens": toks[idx].astype(np.int32),
                         "attn_mask": mask[idx].astype(np.float32)}
                if self.work_fn is not None:
                    batch = self.work_fn(batch, rng)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

    def start(self):
        for w in range(self.n_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        try:
            self._q.put_nowait(_SENTINEL)
        except queue.Full:
            pass  # consumer will drain to the timeout check instead
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    # -- consumer ----------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._threads and not self._stop.is_set():
            self.start()
        while True:
            try:
                b = self._q.get_nowait()
            except queue.Empty:
                self.consumer_stalls += 1
                b = None
                # never block forever: stop() may fire after the queue
                # drained, so poll with a timeout and re-check the flag
                while b is None:
                    if self._stop.is_set() and self._q.empty():
                        return
                    try:
                        b = self._q.get(timeout=0.05)
                    except queue.Empty:
                        continue
            if b is _SENTINEL:
                return
            self.batches_out += 1
            yield b

    @property
    def stall_fraction(self) -> float:
        if self.batches_out == 0:
            return 1.0
        return self.consumer_stalls / self.batches_out


class OrderedPrefetchLoader:
    """Deterministic, order-preserving parallel prefetch.

    Workers compute batches by *global batch index*: worker ``w`` of ``W``
    produces indices ``start+w, start+w+W, ...`` into its own bounded
    queue, and the consumer round-robins the queues in index order — so
    the emitted sequence is exactly ``batch_fn(start), batch_fn(start+1),
    ...`` no matter how many workers race ahead.  This is the loader the
    resumable :class:`repro_torch.data.pipeline.DataPipeline` builds on: the
    whole stream is a pure function of ``start``, so a checkpoint only
    needs the integer cursor, not queue contents or thread state.

    ``batch_fn(k)`` must be thread-safe and a pure function of ``k``.
    """

    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
                 n_workers: int = 1, prefetch: int = 4, start: int = 0):
        self.batch_fn = batch_fn
        self.n_workers = max(1, n_workers)
        self.prefetch = max(1, prefetch)
        self.start = start
        self._qs = [queue.Queue(maxsize=self.prefetch)
                    for _ in range(self.n_workers)]
        self._stop = threading.Event()
        self._threads: list = []
        self._err: Optional[BaseException] = None
        self.batches_out = 0
        self.consumer_stalls = 0

    def _worker(self, wid: int):
        # each worker claims its own trace lane so overlapping fetches
        # render side by side; thread_lane makes spans emitted deeper in
        # the stack (DataPipeline._batch) land on the same lane
        lane = f"fetch-w{wid}"
        k = self.start + wid
        try:
            while not self._stop.is_set():
                tracer = get_tracer()
                tracer.thread_lane(lane)
                with tracer.span("batch_fetch", lane, index=k):
                    batch = self.batch_fn(k)
                while not self._stop.is_set():
                    try:
                        self._qs[wid].put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                k += self.n_workers
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            self._err = e
            self._stop.set()        # wake the consumer instead of hanging

    def start_workers(self):
        for w in range(self.n_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for q in self._qs:  # unblock any consumer waiting on an empty queue
            try:
                q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._threads and not self._stop.is_set():
            self.start_workers()
        k = 0
        while True:
            q = self._qs[k % self.n_workers]
            try:
                b = q.get_nowait()
            except queue.Empty:
                self.consumer_stalls += 1
                b = None
                while b is None:
                    if self._stop.is_set():
                        self._check()
                        return
                    try:
                        b = q.get(timeout=0.05)
                    except queue.Empty:
                        continue
            if b is _SENTINEL:
                self._check()
                return
            self.batches_out += 1
            k += 1
            yield b

    @property
    def stall_fraction(self) -> float:
        if self.batches_out == 0:
            return 1.0
        return self.consumer_stalls / self.batches_out


def measure_throughput(ds: StagedDataset, batch_size: int, n_workers: int,
                       *, n_batches: int = 50, step_time_s: float = 0.0,
                       work_fn=None, seq_len=None) -> Dict[str, float]:
    """Consume ``n_batches`` with a simulated accelerator step of
    ``step_time_s``; returns throughput + utilization proxy."""
    loader = PrefetchLoader(ds, batch_size, n_workers=n_workers,
                            work_fn=work_fn).start()
    it = iter(loader)
    next(it)  # warm
    t0 = time.perf_counter()
    busy = 0.0
    for _ in range(n_batches):
        tw0 = time.perf_counter()
        next(it)
        wait = time.perf_counter() - tw0
        if step_time_s:
            time.sleep(step_time_s)
            busy += step_time_s
        _ = wait
    dt = time.perf_counter() - t0
    loader.stop()
    return {
        "batches_per_s": n_batches / dt,
        "samples_per_s": n_batches * batch_size / dt,
        "utilization": busy / dt if step_time_s else float("nan"),
        "stall_fraction": loader.stall_fraction,
    }


def tune_workers(ds: StagedDataset, batch_size: int, *,
                 step_time_s: float, max_workers: int = 8,
                 target_util: float = 0.95, n_batches: int = 30,
                 work_fn=None) -> Dict[str, object]:
    """R3 as code: grow n_workers until utilization stabilizes, stop there."""
    history = []
    for w in range(1, max_workers + 1):
        m = measure_throughput(ds, batch_size, w, n_batches=n_batches,
                               step_time_s=step_time_s, work_fn=work_fn)
        history.append({"n_workers": w, **m})
        if m["utilization"] >= target_util:
            break
    return {"chosen": history[-1]["n_workers"], "history": history}
