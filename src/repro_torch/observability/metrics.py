"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

A trimmed copy of the JAX package's ``observability/metrics.py`` (the
serve engine's subset: no Prometheus export, no bulk gauge import).
Series names are the same as there (``docs/observability.md``).
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "TTFT_BUCKETS_MS", "DECODE_BUCKETS_MS"]

# bucket presets (milliseconds, upper bounds; +inf is implicit)
TTFT_BUCKETS_MS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)
DECODE_BUCKETS_MS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or any(c not in _NAME_OK
                                            for c in name):
        raise ValueError(
            f"metric name {name!r} is not Prometheus-safe "
            "([a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be a sorted "
                             f"non-empty sequence, got {buckets!r}")
        self.name = _check_name(name)
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th sample falls in; the last finite bound for +inf)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
        return self.buckets[-1]

    def snapshot(self) -> Dict[str, Any]:
        cum, out = 0, {}
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out[str(b)] = cum
        return {"count": self.count, "sum": self.sum, "buckets": out}


class MetricsRegistry:
    """Ordered name -> metric map with get-or-create accessors.

    Accessors are idempotent: asking for an existing name returns the
    existing series (and raises if the type differs)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, buckets, help=help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return list(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            out[name] = m.snapshot() if isinstance(m, Histogram) \
                else m.value
        return out

    def write_jsonl(self, path: str, *, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
        """Append one snapshot line to ``path``."""
        rec: Dict[str, Any] = {"ts": time.time()}
        if step is not None:
            rec["step"] = step
        if extra:
            rec.update(extra)
        rec["metrics"] = self.snapshot()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
