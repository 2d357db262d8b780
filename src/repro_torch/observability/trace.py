"""Per-process span tracing with Chrome-trace/Perfetto JSON export.

The paper's method is to instrument the pipeline until every wasted
accelerator-second has a name; this module is the naming device.  A
:class:`Tracer` records *spans* (named, nestable wall-time intervals),
*instant events* (point markers: a rollback, an injected fault) and
*async events* (intervals that cross engine ticks, e.g. one serve
request from submit to finish) into a bounded per-process ring buffer,
and flushes them as Chrome-trace JSON — loadable directly in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

Design constraints, in order:

1. **The step path never blocks on the tracer.**  Recording is an
   O(1) deque append under a lock held for nanoseconds; when the ring
   buffer is full the OLDEST event is dropped (``dropped`` counts them)
   rather than the writer waiting.  The disabled path
   (:class:`NullTracer`) is a single attribute check + no-op context
   manager — the ``trace_overhead`` benchmark pins the enabled path at
   ≤ 3% step-time overhead.

2. **Trace == telemetry.**  Call sites that already time a region for
   stall accounting (``TrainLoop``'s ``blocked`` bookkeeping) hand the
   SAME ``perf_counter`` readings to :meth:`Tracer.complete`, so the
   sum of e.g. ``data_wait`` spans in the trace is bit-identical to the
   seconds added to ``telemetry['host_blocked_s']`` — the trace can be
   cross-validated against the numbers, and vice versa.

3. **Multi-process merge.**  Timestamps are wall-clock anchored
   (``time.time()`` at tracer construction + ``perf_counter`` deltas),
   ``pid`` is the process index, so trace files from different
   hosts concatenate into one coherent timeline
   (``tools/trace_summary.py`` merges them).

Lanes (Chrome ``tid``) are logical phases, not OS threads: the default
taxonomy is loop / compute / data / comm / ckpt / metrics / serve, and
new lanes (e.g. one per loader worker: ``fetch-w0``) are assigned ids
on first use.  Worker threads may set a thread-local *default lane*
(:meth:`Tracer.thread_lane`) so code deeper in the stack
(``DataPipeline._batch``) lands on its caller's lane without plumbing.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "NullTracer", "get_tracer", "set_tracer",
           "NULL_TRACER", "DEFAULT_LANES"]

# canonical lane order (Chrome tid); extra lanes get ids past these
DEFAULT_LANES = ("loop", "compute", "data", "comm", "ckpt", "metrics",
                 "serve")


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tr", "name", "lane", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, lane: Optional[str],
                 args: Optional[Dict[str, Any]]):
        self._tr = tracer
        self.name = name
        self.lane = lane
        self.args = args

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.complete(self.name, self.lane, self.t0,
                          time.perf_counter(), **(self.args or {}))
        return False


class _NullSpan:
    """Shared no-op span: the disabled tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span recorder (module docstring).

    ``capacity`` bounds the event buffer; overflow drops the oldest
    event and increments ``dropped`` — recording never blocks.
    ``totals``/``take_window()`` accumulate per-span-name seconds for
    the straggler aggregation (``observability.aggregate``) without a
    pass over the buffer.
    """

    enabled = True

    def __init__(self, *, capacity: int = 1 << 16, process_index: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.process_index = process_index
        self.dropped = 0
        self._buf: "collections.deque" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._lanes: Dict[str, int] = {n: i
                                       for i, n in enumerate(DEFAULT_LANES)}
        self._tls = threading.local()
        self.totals: Dict[str, float] = {}
        self._window: Dict[str, float] = {}
        # wall-clock anchor: ts = (wall0 + (perf - perf0)) so intra-process
        # precision comes from perf_counter while cross-process files share
        # the system clock epoch and merge into one timeline
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # -- lanes -----------------------------------------------------------

    def lane_id(self, lane: str) -> int:
        tid = self._lanes.get(lane)
        if tid is None:
            with self._lock:
                tid = self._lanes.setdefault(lane, len(self._lanes))
        return tid

    def thread_lane(self, lane: Optional[str]) -> None:
        """Set this thread's default lane (used when an event passes
        ``lane=None``) — loader workers each claim a ``fetch-w<i>``
        lane once, and everything they call lands on it."""
        self._tls.lane = lane

    def _resolve_lane(self, lane: Optional[str]) -> str:
        if lane is not None:
            return lane
        return getattr(self._tls, "lane", None) or "compute"

    # -- recording -------------------------------------------------------

    def _push(self, ev: tuple) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1  # deque maxlen evicts the oldest
            self._buf.append(ev)

    def span(self, name: str, lane: Optional[str] = None,
             **args: Any) -> _Span:
        """Nestable context manager; records on exit."""
        return _Span(self, name, lane, args or None)

    def complete(self, name: str, lane: Optional[str], t0: float,
                 t1: float, **args: Any) -> None:
        """Record a finished interval from explicit ``perf_counter``
        readings — the form used where the caller already timed the
        region, so trace and telemetry share the same numbers."""
        lane = self._resolve_lane(lane)
        dur = t1 - t0
        self._push(("X", name, lane, t0, dur, args or None))
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + dur
            self._window[name] = self._window.get(name, 0.0) + dur

    def instant(self, name: str, lane: Optional[str] = None,
                **args: Any) -> None:
        self._push(("i", name, self._resolve_lane(lane),
                    time.perf_counter(), args or None))

    def begin_async(self, name: str, aid: Any,
                    lane: Optional[str] = None, **args: Any) -> None:
        """Open an async interval (Chrome ``b`` event) keyed by ``aid``
        — intervals that cross engine ticks (a serve request's
        lifetime) and may overlap freely on one lane."""
        self._push(("b", name, self._resolve_lane(lane),
                    time.perf_counter(), aid, args or None))

    def end_async(self, name: str, aid: Any,
                  lane: Optional[str] = None, **args: Any) -> None:
        self._push(("e", name, self._resolve_lane(lane),
                    time.perf_counter(), aid, args or None))

    # -- aggregation windows --------------------------------------------

    def take_window(self) -> Dict[str, float]:
        """Per-span-name seconds accumulated since the last call (the
        straggler monitor's unit of comparison); resets the window."""
        with self._lock:
            w, self._window = self._window, {}
        return w

    # -- export ----------------------------------------------------------

    def _ts_us(self, t_perf: float) -> float:
        return (self._wall0 + (t_perf - self._perf0)) * 1e6

    def __len__(self) -> int:
        return len(self._buf)

    def chrome_events(self) -> List[Dict[str, Any]]:
        """The buffer as Chrome-trace event dicts (metadata first)."""
        pid = self.process_index
        with self._lock:
            snap = list(self._buf)
            lanes = dict(self._lanes)
        out: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"host{pid}"}}]
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": lane}})
            out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                        "tid": tid, "args": {"sort_index": tid}})
        for ev in snap:
            ph = ev[0]
            if ph == "X":
                _, name, lane, t0, dur, args = ev
                d = {"ph": "X", "name": name, "cat": lane, "pid": pid,
                     "tid": self.lane_id(lane), "ts": self._ts_us(t0),
                     "dur": dur * 1e6}
            elif ph == "i":
                _, name, lane, t, args = ev
                d = {"ph": "i", "name": name, "cat": lane, "pid": pid,
                     "tid": self.lane_id(lane), "ts": self._ts_us(t),
                     "s": "t"}
            else:  # b / e
                _, name, lane, t, aid, args = ev
                d = {"ph": ph, "name": name, "cat": lane, "pid": pid,
                     "tid": self.lane_id(lane), "ts": self._ts_us(t),
                     "id": str(aid)}
            if args:
                d["args"] = args
            out.append(d)
        return out

    def flush(self, trace_dir: str) -> str:
        """Write ``<trace_dir>/trace-<pidx>.json`` (atomic rename);
        returns the path.  The buffer is kept — flush is idempotent."""
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace-{self.process_index}.json")
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "otherData": {"process_index": self.process_index,
                             "dropped": self.dropped,
                             "capacity": self.capacity}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


class NullTracer:
    """Disabled tracing: every call is a no-op, ``span`` returns one
    shared reusable context manager.  This is the default installed
    tracer, so instrumented code needs no ``if tracer:`` guards."""

    enabled = False
    dropped = 0
    process_index = 0

    def span(self, name: str, lane: Optional[str] = None,
             **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name, lane, t0, t1, **args) -> None:
        pass

    def instant(self, name, lane=None, **args) -> None:
        pass

    def begin_async(self, name, aid, lane=None, **args) -> None:
        pass

    def end_async(self, name, aid, lane=None, **args) -> None:
        pass

    def thread_lane(self, lane) -> None:
        pass

    def take_window(self) -> Dict[str, float]:
        return {}

    def chrome_events(self) -> List[Dict[str, Any]]:
        return []

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()
_current: Any = NULL_TRACER
_current_lock = threading.Lock()


def get_tracer():
    """The installed process-wide tracer (NullTracer by default)."""
    return _current


def set_tracer(tracer) -> Any:
    """Install ``tracer`` (None -> NullTracer); returns the previous
    one so tests can restore it."""
    global _current
    with _current_lock:
        prev = _current
        _current = tracer if tracer is not None else NULL_TRACER
    return prev
