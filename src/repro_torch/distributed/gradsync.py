"""Bucketed, backward-overlapped gradient synchronisation for ddp.

The port's copy of the ddp half of the JAX package's
``distributed/gradsync.py``.  :func:`partition_buckets` slices the flat
gradient leaf list, in the JAX flatten order (sorted keys,
``models.params.flatten_tree``; not ``named_parameters()`` order), into
size-targeted buckets walked back to front, the order the backward
produces gradients in.  :class:`BucketedAllReduce` issues exactly ONE
``all_reduce`` per bucket per step: a ``post_accumulate_grad`` hook on
every parameter counts the bucket's leaves as their ``.grad`` completes
during the final microbatch's backward, flattens the full bucket into one
buffer, scales it by ``1 / n_micro`` and starts the reduction
asynchronously, so that it runs under the rest of the backward.
``finish`` waits for every bucket and copies the sums back into
``.grad``, or into the f32 accumulator of a parameter whose microbatch
gradients are summed in f32 (``core.accum``): there the bucket reduces
that accumulator plus the final microbatch's gradient.

Gradient-correctness invariant (the classic ddp bucketing bug): the sync
is a plain SUM, issued once per STEP, after the final microbatch, never
once per microbatch.  The per-shard loss (``train_step.loss_for`` with a
group) is scaled so that the ranks' gradients sum to the global-batch
gradient.

Buckets are issued in bucket order on every rank, whatever order their
hooks complete in: collectives are matched by their order of issue, so a
rank that started bucket 3 before bucket 2 would pair it with its peer's
bucket 2.

``counts["grad_all_reduce"]`` counts the gradient collectives issued in
this process.  The fsdp half of the JAX module waits for ROADMAP A8.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.accum import fold
from repro_torch.observability import get_tracer

__all__ = ["DEFAULT_BUCKET_MB", "GradBucket", "BucketedAllReduce",
           "partition_buckets", "bucketed_all_reduce", "fused_all_reduce",
           "bucket_plan_stats", "ring_allreduce_bytes", "leaf_nbytes", "metric_series",
           "counts", "reset_counts", "flat_leaves"]

DEFAULT_BUCKET_MB = 25.0

# collective name -> issued since the last reset, in this process
counts: collections.Counter = collections.Counter()


def reset_counts() -> None:
    counts.clear()


@dataclass(frozen=True)
class GradBucket:
    """One all-reduce's worth of gradient leaves.

    ``indices`` are positions in the flattened leaf list (JAX flatten
    order), in the order the bucket concatenates them.  ``nbytes`` is the
    bucket's payload."""

    indices: Tuple[int, ...]
    nbytes: int
    dtype: torch.dtype

    @property
    def mb(self) -> float:
        return self.nbytes / 1e6


def leaf_nbytes(leaf) -> int:
    """Payload bytes of one leaf (a tensor, a meta tensor for shapes only)."""
    return leaf.numel() * leaf.element_size()


def partition_buckets(leaves: Sequence[torch.Tensor], *,
                      bucket_mb: float = DEFAULT_BUCKET_MB,
                      reverse: bool = True) -> List[GradBucket]:
    """Partition gradient leaves into size-targeted buckets, the JAX rule.

    ``reverse=True`` walks the flat leaf list back to front: the tree
    flattens roughly input to output and the backward produces gradients
    output to input.  Every leaf lands in exactly one bucket; a bucket
    closes when it would pass ``bucket_mb`` or when the leaf dtype
    changes (a bucket is one buffer of one dtype).  A leaf larger than
    ``bucket_mb`` gets a bucket of its own, never split."""
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
    target = int(bucket_mb * 1e6)
    order = range(len(leaves) - 1, -1, -1) if reverse else range(len(leaves))
    buckets: List[GradBucket] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in order:
        nb = leaf_nbytes(leaves[i])
        dt = leaves[i].dtype
        if cur and (cur_dtype != dt or cur_bytes + nb > target):
            buckets.append(GradBucket(tuple(cur), cur_bytes, cur_dtype))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = dt
    if cur:
        buckets.append(GradBucket(tuple(cur), cur_bytes, cur_dtype))
    return buckets


def flat_leaves(params: torch.nn.Module, prefix: str = "") -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, parameter)`` of a parameter tree (``models.params.ParamTree``)
    in the JAX flatten order: a dict node's leaves and children by sorted
    key, a list's items in order.  ``named_parameters()`` gives
    registration order instead, which would make other buckets."""
    if isinstance(params, torch.nn.ModuleList):
        keys = [str(i) for i in range(len(params))]
    else:
        keys = sorted({*params._parameters, *params._modules})
    out = []
    for k in keys:
        if k in params._parameters:
            out.append((prefix + k, params._parameters[k]))
        else:
            out += flat_leaves(params._modules[k], f"{prefix}{k}.")
    return out


def _flat(grads, bucket: GradBucket, scale: float) -> torch.Tensor:
    """The bucket's leaves (``grads[i]`` for each flat index i: a list of
    every leaf, or a dict of the bucket's) raveled into one buffer of the
    bucket's dtype, scaled."""
    flat = torch.cat([grads[i].reshape(-1).to(bucket.dtype) for i in bucket.indices])
    if scale != 1.0:
        flat.mul_(scale)
    return flat


def _unflat(flat: torch.Tensor, grads: Sequence[torch.Tensor], bucket: GradBucket) -> None:
    off = 0
    for i in bucket.indices:
        g = grads[i]
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()


def bucketed_all_reduce(grads: Sequence[torch.Tensor], buckets: Sequence[GradBucket],
                        group=None, scale: float = 1.0) -> None:
    """Sum ``grads`` (the flat leaf list, in place) across ``group`` with
    one collective per bucket, each bucket raveled into one buffer and
    scaled by ``scale`` first.  The functional form: it runs after the
    backward, so nothing overlaps."""
    for b in buckets:
        flat = _flat(grads, b, scale)
        counts["grad_all_reduce"] += 1
        dist.all_reduce(flat, group=group)
        _unflat(flat, grads, b)


def fused_all_reduce(grads: Sequence[torch.Tensor], group=None, scale: float = 1.0) -> None:
    """The baseline the buckets beat: one collective over every leaf,
    after the whole backward (a single bucket of unbounded size; leaves
    of several dtypes each get their own)."""
    bucketed_all_reduce(grads, partition_buckets(grads, bucket_mb=1e12), group, scale)


class BucketedAllReduce:
    """Per-bucket all-reduce over the default process group from backward
    hooks, armed once per step.

    Bind it to the parameter tree with :meth:`bind` (re-binding to another
    tree moves the hooks).  :meth:`arm` before the final microbatch's
    backward, then :meth:`finish` after it.  Each leaf's hook must fire
    exactly once in the armed backward (``hook_fires``); a second firing
    raises, since its bucket may already be on the wire.

    ``timed``: :meth:`finish` synchronises the device on entry (the end
    of the backward) and after each bucket's wait, so ``last_wait_s``
    and ``last_exposed_s`` are device-accurate; otherwise they are host
    times and the step stays asynchronous where the backend allows."""

    def __init__(self, buckets: Sequence[GradBucket], *, timed: bool = False):
        self.buckets = list(buckets)
        self.timed = timed
        self._bucket_of = {i: b for b, bk in enumerate(self.buckets) for i in bk.indices}
        self._params: Optional[torch.nn.Module] = None
        self._leaves: List[torch.Tensor] = []
        self._handles: list = []
        self.armed = False
        self.hook_fires: List[int] = []
        self.last_wait_s: List[float] = []
        self.last_exposed_s = 0.0

    def bind(self, params: torch.nn.Module) -> None:
        if params is self._params:
            return
        for h in self._handles:
            h.remove()
        leaves = [p for _, p in flat_leaves(params)]
        if len(leaves) != len(self._bucket_of):
            raise ValueError(f"{len(leaves)} parameters but the buckets hold "
                             f"{len(self._bucket_of)} leaves")
        self._params, self._leaves = params, leaves
        self._handles = [p.register_post_accumulate_grad_hook(self._hook(i))
                         for i, p in enumerate(leaves)]

    def _hook(self, i: int):
        def hook(p):
            if self.armed:
                self._ready(i)
        return hook

    def arm(self, scale: float = 1.0, acc=None) -> None:
        """``acc``: {parameter: its f32 accumulator} of the parameters whose
        earlier microbatches were summed in f32; their buckets reduce
        accumulator + gradient and the result is left in the accumulator."""
        self.armed = True
        self.scale = scale
        acc = acc or {}
        self._acc = [acc.get(p) for p in self._leaves]
        self.hook_fires = [0] * len(self._leaves)
        self._pending = [len(b.indices) for b in self.buckets]
        self._next = 0
        self._works: list = []

    def _ready(self, i: int) -> None:
        self.hook_fires[i] += 1
        if self.hook_fires[i] > 1:
            raise RuntimeError(f"gradient hook of leaf {i} fired twice in one backward")
        self._pending[self._bucket_of[i]] -= 1
        # issue in bucket order: every rank starts the same collective next
        while self._next < len(self.buckets) and self._pending[self._next] == 0:
            self._issue(self._next)
            self._next += 1

    def _source(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s gradient to reduce: its ``.grad``, or the f32
        accumulator with the final microbatch's ``.grad`` added in (then
        dropped)."""
        p, a = self._leaves[i], self._acc[i]
        return p.grad if a is None else fold(p, a)

    def _issue(self, b: int) -> None:
        bucket = self.buckets[b]
        srcs = {i: self._source(i) for i in bucket.indices}
        flat = _flat(srcs, bucket, self.scale)
        counts["grad_all_reduce"] += 1
        self._works.append((b, flat, dist.all_reduce(flat, async_op=True)))

    def finish(self) -> None:
        """Wait for every bucket and write the sums into ``.grad``.  A
        leaf whose hook never fired (a parameter the loss does not reach)
        contributes zeros; its bucket is issued here, in order."""
        if not self.armed:
            raise RuntimeError("finish() without arm()")
        tracer = get_tracer()
        cuda = self._leaves[0].is_cuda
        if self.timed and cuda:
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for p, a in zip(self._leaves, self._acc):
            if p.grad is None and a is None:
                p.grad = torch.zeros_like(p)
        while self._next < len(self.buckets):
            self._issue(self._next)
            self._next += 1
        self.last_wait_s = []
        for b, flat, work in self._works:
            t0 = time.perf_counter()
            work.wait()
            if self.timed and cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.last_wait_s.append(t1 - t0)
            tracer.complete("allreduce_wait", "gradsync", t0, t1, bucket=b,
                            mb=self.buckets[b].mb)
            _unflat(flat, [p.grad if a is None else a for p, a in zip(self._leaves, self._acc)],
                    self.buckets[b])
        self.last_exposed_s = time.perf_counter() - t_start
        self.armed = False
        self._works = []


def bucket_plan_stats(buckets: Sequence[GradBucket]) -> dict:
    """Telemetry summary: collective count and payload distribution."""
    if not buckets:
        return {"n_buckets": 0, "comm_bytes": 0, "max_bucket_mb": 0.0,
                "min_bucket_mb": 0.0}
    sizes = [b.nbytes for b in buckets]
    return {"n_buckets": len(buckets), "comm_bytes": int(sum(sizes)),
            "max_bucket_mb": max(sizes) / 1e6, "min_bucket_mb": min(sizes) / 1e6}


def ring_allreduce_bytes(total_bytes: int, n_devices: int) -> float:
    """Wire bytes per device for a ring all-reduce of ``total_bytes``:
    2 (n - 1) / n of the payload (reduce-scatter plus all-gather)."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * total_bytes


def metric_series(info: dict) -> dict:
    """Flatten a ``StepRunner.grad_sync_info()`` dict into numeric
    series: numbers pass through, ``bucket_bytes`` collapses to its sum,
    strings and other structure are dropped."""
    out = {}
    for k, v in info.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[k] = float(v)
        elif k == "bucket_bytes" and isinstance(v, (list, tuple)):
            out["bucket_bytes_total"] = float(sum(v))
    return out
