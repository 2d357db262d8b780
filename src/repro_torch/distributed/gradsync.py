"""Bucketed, backward-overlapped gradient synchronisation for ddp and
fsdp.

The port's copy of the JAX package's ``distributed/gradsync.py``.
:func:`partition_buckets` slices the flat gradient leaf list, in the JAX
flatten order (sorted keys, ``models.params.flatten_tree``; not
``named_parameters()`` order), into size-targeted buckets walked back to
front, the order the backward produces gradients in.  :class:`BucketedAllReduce` issues exactly ONE
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

fsdp (ZeRO-3, ``scatter_overlap``): :func:`partition_fsdp_buckets`
splits the leaves into scatter buckets (each leaf cut on its first
dimension the data-parallel size divides, :func:`shard_dim`) and psum
buckets (the leaves no such dimension cuts, kept whole).  Each rank holds
its slice of every scatter leaf.  :func:`gather_fsdp_params` rebuilds the
full leaves with ONE ``all_gather_into_tensor`` per scatter bucket, in
forward-layer order, as a ``torch.autograd.Function`` whose backward is
ONE ``reduce_scatter_tensor`` of the bucket's full gradients: the
transpose, so that the gradient arrives at each shard already summed.
:func:`bucketed_psum_scatter` is the same reduce-scatter on gradients
formed outside autograd (the gather-once path); the whole leaves go
through :func:`bucketed_all_reduce`.

MoE: :func:`router_stat_mean` is the port's ``pmean`` of the router's
batch statistics (``models/moe.py``): ONE all-reduce of ``(me, ce)`` a
MoE layer a forward (again in a rematerialised layer's recompute), and
one of ``me``'s cotangent a layer in the backward, its transpose.

``counts`` counts the collectives issued in this process:
``grad_all_reduce``, ``param_all_gather`` (a scatter bucket's gather,
again when a checkpointed gather runs in the backward),
``grad_reduce_scatter``, ``grad_all_gather`` (gradient shards
gathered for a comparison by ``train_step.make_grad_fn``, not by a
step), and ``router_stat_all_reduce``.
"""
from __future__ import annotations

import collections
import functools
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.core.accum import fold
from repro_torch.observability import get_tracer

__all__ = ["DEFAULT_BUCKET_MB", "GradBucket", "BucketedAllReduce", "FsdpBucketPlan",
           "partition_buckets", "partition_fsdp_buckets", "shard_dim", "local_shape",
           "bucketed_all_reduce", "fused_all_reduce", "gather_fsdp_params",
           "gather_grad_shards", "bucketed_psum_scatter", "fsdp_global_norm",
           "bucket_plan_stats", "ring_allreduce_bytes", "reduce_scatter_bytes",
           "all_gather_bytes", "leaf_nbytes", "metric_series", "counts", "reset_counts",
           "flat_leaves", "router_stat_mean"]

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

# ---------------------------------------------------------------------------
# fsdp (ZeRO-3): sharded leaves, per-bucket all-gather / reduce-scatter
# ---------------------------------------------------------------------------


def shard_dim(leaf, n_shards: int) -> Optional[int]:
    """The dimension a leaf is cut on under ``scatter_overlap``: the FIRST
    one ``n_shards`` divides, or None (the leaf stays whole).  Dim 0 is
    not required: a stacked block leaf's leading ``layers`` axis is often
    1."""
    if n_shards <= 1:
        return None
    for d, s in enumerate(leaf.shape):
        if s > 0 and s % n_shards == 0:
            return d
    return None


def local_shape(shape: Sequence[int], dim: int, n_shards: int) -> Tuple[int, ...]:
    """One rank's shard shape of a leaf cut on ``dim``."""
    shape = tuple(shape)
    return shape[:dim] + (shape[dim] // n_shards,) + shape[dim + 1:]


@dataclass(frozen=True)
class FsdpBucketPlan:
    """The ``scatter_overlap`` communication plan.  ``scatter`` buckets hold
    cut leaves (one all-gather forward, one reduce-scatter backward);
    ``psum`` buckets the whole ones (one all-reduce).  ``shard_dims[i]`` is
    flat leaf i's cut dimension (None: whole); bucket indices are flat leaf
    positions, as in :class:`GradBucket`."""

    n_shards: int
    scatter: Tuple[GradBucket, ...]
    psum: Tuple[GradBucket, ...]
    shard_dims: Tuple[Optional[int], ...]

    @property
    def buckets(self) -> Tuple[GradBucket, ...]:
        """Every bucket, scatter first."""
        return self.scatter + self.psum

    @property
    def scatter_indices(self) -> Tuple[int, ...]:
        return tuple(i for b in self.scatter for i in b.indices)

    @property
    def scatter_bytes(self) -> int:
        return sum(b.nbytes for b in self.scatter)

    @property
    def psum_bytes(self) -> int:
        return sum(b.nbytes for b in self.psum)


def _remap(bucket: GradBucket, orig: Sequence[int]) -> GradBucket:
    return GradBucket(tuple(orig[i] for i in bucket.indices), bucket.nbytes, bucket.dtype)


def partition_fsdp_buckets(leaves: Sequence[torch.Tensor], n_shards: int, *,
                           bucket_mb: float = DEFAULT_BUCKET_MB) -> FsdpBucketPlan:
    """Cut leaves and whole leaves bucketed apart, each group by the
    reverse-layer walk of :func:`partition_buckets`: a scatter bucket's
    flat buffer must split into ``n_shards`` equal rows with no padding.
    (The JAX ``pinned`` leaves, kept whole for fsdp_tp, come with A11.)"""
    dims = tuple(shard_dim(x, n_shards) for x in leaves)
    sc = [i for i, d in enumerate(dims) if d is not None]
    rp = [i for i, d in enumerate(dims) if d is None]
    scatter = tuple(_remap(b, sc) for b in partition_buckets(
        [leaves[i] for i in sc], bucket_mb=bucket_mb)) if sc else ()
    psum = tuple(_remap(b, rp) for b in partition_buckets(
        [leaves[i] for i in rp], bucket_mb=bucket_mb)) if rp else ()
    return FsdpBucketPlan(n_shards, scatter, psum, dims)


def _leaf_to_blocks(full: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """(n, size / n) of a full leaf: row r is rank r's slice along
    ``dim``, raveled, the layout ``reduce_scatter_tensor`` scatters by
    leading chunk."""
    s = full.shape
    x = full.reshape(s[:dim] + (n, s[dim] // n) + s[dim + 1:])
    return x.movedim(dim, 0).reshape(n, -1)


def _blocks_to_leaf(blocks: torch.Tensor, loc_shape: Sequence[int], dim: int,
                    n: int) -> torch.Tensor:
    """Inverse of :func:`_leaf_to_blocks`: the (n, size / n) gathered rows
    back to the full leaf, the ranks' blocks concatenated along ``dim``."""
    loc_shape = tuple(loc_shape)
    x = blocks.reshape((n,) + loc_shape).movedim(0, dim)
    return x.reshape(loc_shape[:dim] + (n * loc_shape[dim],) + loc_shape[dim + 1:])


def _all_gather(flat: torch.Tensor, n: int, group, count: str) -> torch.Tensor:
    """(n, len) of every rank's ``flat``, one collective counted as ``count``."""
    out = flat.new_empty(n * flat.numel())
    counts[count] += 1
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, -1)


def _reduce_scatter(blocks: torch.Tensor, group) -> torch.Tensor:
    """This rank's row of the (n, len) ``blocks`` summed over the ranks."""
    out = blocks.new_empty(blocks.shape[1])
    counts["grad_reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, blocks.reshape(-1), group=group)
    return out


def _split(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    out, off = [], 0
    for shp in shapes:
        k = math.prod(shp)
        out.append(flat[off:off + k].view(shp))
        off += k
    return out


def _gather_bucket(bucket: GradBucket, plan: FsdpBucketPlan, group, parts, count: str):
    """The full leaves of one scatter bucket from this rank's shards."""
    n = plan.n_shards
    flat = torch.cat([p.reshape(-1) for p in parts])
    g = _all_gather(flat, n, group, count)
    full, off = [], 0
    for i, p in zip(bucket.indices, parts):
        k = p.numel()
        full.append(_blocks_to_leaf(g[:, off:off + k], p.shape, plan.shard_dims[i], n))
        off += k
    return full


def _scatter_bucket(bucket: GradBucket, plan: FsdpBucketPlan, group, grads,
                    shapes) -> List[torch.Tensor]:
    """This rank's summed shards of one bucket's full gradients."""
    n = plan.n_shards
    blocks = torch.cat([_leaf_to_blocks(g, plan.shard_dims[i], n)
                        for i, g in zip(bucket.indices, grads)], dim=1)
    return _split(_reduce_scatter(blocks, group), shapes)


class _GatherBucket(torch.autograd.Function):
    """One scatter bucket: forward, ONE all-gather of the shards into the
    full leaves; backward, its transpose, ONE reduce-scatter of the full
    leaves' gradients into summed shard gradients.  The backward runs once
    every used output's gradient is in; an output the loss does not reach
    reads as zeros, so that every rank issues every bucket's collective.
    The shards are saved for the backward (their shapes shape its
    result), so a checkpointed gather runs again there."""

    @staticmethod
    def forward(ctx, bucket, plan, group, *shards):
        ctx.set_materialize_grads(True)
        ctx.bucket, ctx.plan, ctx.group = bucket, plan, group
        ctx.save_for_backward(*shards)
        return tuple(_gather_bucket(bucket, plan, group, shards, "param_all_gather"))

    @staticmethod
    def backward(ctx, *grads):
        shapes = [s.shape for s in ctx.saved_tensors]
        parts = _scatter_bucket(ctx.bucket, ctx.plan, ctx.group, grads, shapes)
        return (None, None, None, *parts)


class _RouterStatMean(torch.autograd.Function):
    """(me, ce) -> their means over ``group``: one all-reduce of both.
    The backward is JAX's transpose of ``pmean``: the mean over the group
    of ``me``'s cotangent (one all-reduce); ``ce``, a count, has none.
    Every rank reaches it at the same point of the same graph, so the
    ranks issue these collectives in one order."""

    @staticmethod
    def forward(ctx, me, ce, group):
        ctx.group = group
        n = dist.get_world_size(group)
        both = torch.cat([me, ce])
        dist.all_reduce(both, group=group)
        counts["router_stat_all_reduce"] += 1
        me_g, ce_g = (both / n).split(me.shape[0])
        ctx.mark_non_differentiable(ce_g)
        return me_g, ce_g

    @staticmethod
    def backward(ctx, g_me, g_ce):
        g = g_me.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        counts["router_stat_all_reduce"] += 1
        return g / dist.get_world_size(ctx.group), None, None


def router_stat_mean(me: torch.Tensor, ce: torch.Tensor, group=None):
    """The MoE router's batch means ``me`` and ``ce`` averaged over the
    process group (``models.moe.route``'s ``stat_reduce``): with equal
    shards the mean of the shard means is the global mean."""
    return _RouterStatMean.apply(me, ce, group)


def gather_fsdp_params(leaves: Sequence[torch.Tensor], plan: FsdpBucketPlan, group=None, *,
                       free_after_use: bool = False) -> List[torch.Tensor]:
    """The full leaves (flat order) from this rank's ``leaves``: one
    all-gather per scatter bucket, the buckets in FORWARD layer order (the
    reverse of their backward-ordered construction); whole leaves pass
    through.  Differentiable: the gradient of each gathered leaf comes
    back to its shard through one reduce-scatter a bucket.

    ``free_after_use`` runs each bucket's gather under
    ``torch.utils.checkpoint``, so that the backward gathers it again
    (``2 x`` the gather wire a step), as the JAX ``jax.checkpoint`` of the
    gather.  The tensors that consume a gathered leaf save it themselves
    (a remat layer's checkpoint saves its inputs), so the gathered tree
    still lives through the backward, as in JAX's donate_gather step."""
    out = list(leaves)
    for b in reversed(plan.scatter):
        parts = [leaves[i] for i in b.indices]
        fn = functools.partial(_GatherBucket.apply, b, plan, group)
        full = checkpoint(fn, *parts, use_reentrant=False) if free_after_use else fn(*parts)
        for i, f in zip(b.indices, full):
            out[i] = f
    return out


def gather_grad_shards(grads: Sequence[torch.Tensor], plan: FsdpBucketPlan,
                       group=None) -> List[torch.Tensor]:
    """The full gradient leaves from summed shards (whole leaves pass
    through): one all-gather per scatter bucket, counted as
    ``grad_all_gather``, for comparing a sharded gradient leaf for leaf."""
    out = list(grads)
    with torch.no_grad():
        for b in reversed(plan.scatter):
            full = _gather_bucket(b, plan, group, [grads[i] for i in b.indices],
                                  "grad_all_gather")
            for i, f in zip(b.indices, full):
                out[i] = f
    return out


def bucketed_psum_scatter(grads: Sequence[torch.Tensor], plan: FsdpBucketPlan,
                          group=None) -> List[torch.Tensor]:
    """Full local gradients (flat order) to summed shards: one
    reduce-scatter per scatter bucket (the reduce-scatter phase of a ring
    all-reduce alone: half the ddp wire), one all-reduce per psum bucket
    (in place).  The result has shard-shaped leaves where the leaf is cut
    and the whole summed leaf where it is not: the layout the sharded
    AdamW update reads."""
    out = list(grads)
    n = plan.n_shards
    for b in plan.scatter:
        shapes = [local_shape(grads[i].shape, plan.shard_dims[i], n) for i in b.indices]
        for i, g in zip(b.indices, _scatter_bucket(b, plan, group,
                                                   [grads[i] for i in b.indices], shapes)):
            out[i] = g
    bucketed_all_reduce(out, plan.psum, group)
    return out


def fsdp_global_norm(grads: Sequence[torch.Tensor], plan: FsdpBucketPlan,
                     group=None) -> torch.Tensor:
    """The global L2 norm of gradients in the ``scatter_overlap`` layout:
    the shards' squared sums add across the ranks (one scalar
    all-reduce), the whole leaves, equal on every rank, count once."""
    sc = set(plan.scatter_indices)
    dev = grads[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sq = lambda g: torch.sum(torch.square(g.float()))
    sq_shard = sum((sq(g) for i, g in enumerate(grads) if i in sc), zero)
    sq_rep = sum((sq(g) for i, g in enumerate(grads) if i not in sc), zero.clone())
    dist.all_reduce(sq_shard, group=group)
    return torch.sqrt(sq_shard + sq_rep)


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


def reduce_scatter_bytes(total_bytes: int, n_devices: int) -> float:
    """Wire bytes per device for a ring reduce-scatter of ``total_bytes``:
    (n - 1) / n of the payload, HALF the all-reduce (the matching
    all-gather moved onto the parameters, in the forward)."""
    if n_devices <= 1:
        return 0.0
    return (n_devices - 1) / n_devices * total_bytes


def all_gather_bytes(total_bytes: int, n_devices: int) -> float:
    """Wire bytes per device for a ring all-gather assembling
    ``total_bytes``: (n - 1) / n of the payload."""
    if n_devices <= 1:
        return 0.0
    return (n_devices - 1) / n_devices * total_bytes


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
