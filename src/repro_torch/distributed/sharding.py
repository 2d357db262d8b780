"""Per-host batch slicing and the data-parallel plan.

The port's copy of the parts of the JAX package's
``distributed/sharding.py`` that ddp and fsdp need: the two
batch-slicing helpers the data pipeline uses, the gradient-sync strategy
names and the data-parallel subset of ``ParallelPlan``, with the fsdp
state layout (:meth:`ParallelPlan.shard_layout`, the port's
``scatter_param_specs``).  The logical axis rules and the tensor and
pipeline modes (tp, fsdp_tp, pp) come with ROADMAP A11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


def local_batch_size(global_batch: int, process_count: int) -> int:
    """Per-host batch size; the global batch must divide evenly so every
    host dispatches the same program shape."""
    if global_batch % max(1, process_count) != 0:
        raise ValueError(
            f"global_batch={global_batch} not divisible by "
            f"process_count={process_count}")
    return global_batch // max(1, process_count)


def process_batch_slice(global_batch: int, process_index: int,
                        process_count: int) -> slice:
    """Contiguous slice of a global batch owned by ``process_index``.
    Hosts own disjoint, covering slices: host p takes rows
    [p*b_loc, (p+1)*b_loc) of every global batch."""
    b_loc = local_batch_size(global_batch, process_count)
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index={process_index} out of range "
            f"[0, {process_count})")
    return slice(process_index * b_loc, (process_index + 1) * b_loc)


# ---------------------------------------------------------------------------
# The ddp subset of the JAX ParallelPlan
# ---------------------------------------------------------------------------

# gradient-sync strategies, with the JAX package's names:
#   bucketed_overlap — one all-reduce per reverse-layer bucket, issued from
#                      backward hooks (gradsync.BucketedAllReduce)
#   scatter_overlap  — fsdp (ZeRO-3): parameters and AdamW moments cut over
#                      the ranks; one all-gather per bucket rebuilds the
#                      full parameters in the forward, one reduce-scatter
#                      per bucket returns summed gradient shards in the
#                      backward (gradsync.gather_fsdp_params)
#   xla_fused        — the fallback: one all-reduce of the whole tree after
#                      the backward, the batch split into GLOBAL microbatches
#                      (the JAX partitioner's path: overlap off, or a
#                      microbatch count that does not divide the local batch)
#   none             — one data-parallel shard: nothing to synchronise
GRAD_SYNC_BUCKETED = "bucketed_overlap"
GRAD_SYNC_SCATTER = "scatter_overlap"
GRAD_SYNC_XLA = "xla_fused"
GRAD_SYNC_NONE = "none"

# the modes of the JAX plan the port does not run yet, with their ROADMAP item
UNPORTED_MODES = {"tp": "A11", "fsdp_tp": "A11", "pp": "A11", "pp_dp": "A11"}
PORTED_MODES = ("ddp", "fsdp")


@dataclass(frozen=True)
class LeafShard:
    """One rank's part of a leaf under ``scatter_overlap``: ``size`` rows
    from ``start`` along ``dim`` of ``global_shape``, or the whole leaf
    (``dim`` None)."""

    dim: Optional[int]
    start: int
    size: int
    global_shape: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.dim is None:
            return self.global_shape
        g = self.global_shape
        return g[:self.dim] + (self.size,) + g[self.dim + 1:]

    @property
    def offsets(self) -> Tuple[int, ...]:
        """The shard's first element, per dimension."""
        return tuple(self.start if d == self.dim else 0 for d in range(len(self.global_shape)))

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf (a view)."""
        return full if self.dim is None else full.narrow(self.dim, self.start, self.size)


@dataclass(frozen=True)
class ParallelPlan:
    """The data-parallel half of the JAX package's ``ParallelPlan``: which
    gradient-sync strategy keeps the data-parallel replicas equal, over
    how many shards and at what bucket size.  Under ``scatter_overlap``
    ``free_after_use`` gathers each bucket again in the backward
    (``train_step._scatter_accum``).

    Where the JAX plan reads a mesh, this one reads the size of the
    default process group (``world``; ``None`` = no process group, the
    JAX ``mesh=None``).  As in JAX the batch is sharded over the group
    only when the global batch divides by it; otherwise ``dp_size`` is 1
    and nothing is synchronised.

    An MoE model (``has_moe``, ``n_experts``) rides ``bucketed_overlap``
    and ``scatter_overlap`` as in JAX: the per-shard step averages the
    router's batch statistics over the group (``models/moe.py``
    ``route(stat_reduce=...)``).  Its expert-parallel dispatch
    (``ep_overlap``, an ``expert`` mesh axis) comes with ROADMAP A11, so
    :attr:`ep_engaged` is False.  Under the ``xla_fused`` fallback the
    step sums each global microbatch's router statistics over its pieces
    and ranks before the aux (``train_step._fused_accum``)."""

    mode: str
    world: Optional[int] = None
    global_batch: int = 0
    grad_bucket_mb: float = 25.0
    overlap: bool = True
    microbatch: int = 1
    free_after_use: bool = False
    has_moe: bool = False
    n_experts: int = 0

    @classmethod
    def make(cls, world: Optional[int], mode: str, global_batch: int, *,
             grad_bucket_mb: float = 25.0, overlap: bool = True,
             microbatch: int = 1, free_after_use: bool = False,
             has_moe: bool = False, n_experts: int = 0) -> "ParallelPlan":
        """Plan for one (process group size, mode, global batch).
        ``overlap=False`` pins the fused baseline.  Over more than one
        process a mode other than ddp or fsdp raises, naming its ROADMAP
        item; on one process every mode trains the same (nothing to
        shard)."""
        if mode in UNPORTED_MODES and world and world > 1:
            raise NotImplementedError(
                f"sharding mode {mode!r} is not ported yet (ROADMAP "
                f"{UNPORTED_MODES[mode]}); the port runs {' and '.join(PORTED_MODES)}")
        if mode not in PORTED_MODES and mode not in UNPORTED_MODES:
            raise KeyError(f"unknown sharding mode {mode!r}; known: "
                           f"{sorted([*PORTED_MODES, *UNPORTED_MODES])}")
        return cls(mode=mode, world=world, global_batch=global_batch,
                   grad_bucket_mb=grad_bucket_mb, overlap=overlap,
                   microbatch=max(1, microbatch), free_after_use=free_after_use,
                   has_moe=has_moe, n_experts=n_experts)

    @classmethod
    def for_run(cls, run, world: Optional[int] = None, *, grad_bucket_mb: float = 25.0,
                overlap: bool = True, **kw) -> "ParallelPlan":
        """Plan of a ``RunConfig`` (mode, global batch, microbatch count
        and the model's experts read off ``run``); ``kw``:
        ``free_after_use``."""
        moe = run.model.moe
        return cls.make(world, run.sharding, run.shape.global_batch,
                        grad_bucket_mb=grad_bucket_mb, overlap=overlap,
                        microbatch=run.microbatch or 1, has_moe=moe is not None,
                        n_experts=moe.n_experts if moe is not None else 0, **kw)

    @property
    def dp_size(self) -> int:
        if not self.world or self.global_batch % self.world:
            return 1
        return self.world

    @property
    def local_batch(self) -> int:
        """Batch rows of one data-parallel shard (one rank)."""
        return self.global_batch // self.dp_size

    @property
    def ep_engaged(self) -> bool:
        """The JAX plan's expert-parallel predicate: it needs an ``expert``
        mesh axis, which the port's plan (one data axis) has not (A11)."""
        return False

    @property
    def grad_sync(self) -> str:
        """``bucketed_overlap`` (ddp) or ``scatter_overlap`` (fsdp) when the
        local batch splits into the microbatches and overlap is on;
        ``xla_fused`` otherwise; ``none`` with one shard."""
        if self.world is None or self.dp_size <= 1:
            return GRAD_SYNC_NONE
        divisible = self.local_batch % self.microbatch == 0 \
            and self.local_batch >= self.microbatch
        if self.overlap and divisible:
            return GRAD_SYNC_SCATTER if self.mode == "fsdp" else GRAD_SYNC_BUCKETED
        return GRAD_SYNC_XLA

    @property
    def fallback_reason(self) -> Optional[str]:
        """Why the plan declined the bucketed path (None when it did not)."""
        if self.grad_sync != GRAD_SYNC_XLA:
            return None
        if not self.overlap:
            return "overlap disabled"
        return "indivisible microbatch"

    def grad_leaves(self, params, param_dtype: Optional[torch.dtype] = None) -> list:
        """The gradient leaves of ``params`` at sync width, shapes only
        (meta tensors), in the JAX flatten order: f32 accumulators when
        ``microbatch > 1``, else ``param_dtype`` (default: each leaf's)."""
        from repro_torch.distributed.gradsync import flat_leaves

        def dtype(p):
            return torch.float32 if self.microbatch > 1 else (param_dtype or p.dtype)

        return [torch.empty(p.shape, device="meta", dtype=dtype(p))
                for _, p in flat_leaves(params)]

    def grad_buckets(self, params, param_dtype: Optional[torch.dtype] = None):
        """Reverse-layer buckets over ``params``' gradients, or None when
        the plan does not bucket."""
        if self.grad_sync != GRAD_SYNC_BUCKETED:
            return None
        from repro_torch.distributed.gradsync import partition_buckets

        return partition_buckets(self.grad_leaves(params, param_dtype),
                                 bucket_mb=self.grad_bucket_mb)

    def scatter_plan(self, params, param_dtype: Optional[torch.dtype] = None):
        """The ``gradsync.FsdpBucketPlan`` of a ``scatter_overlap`` plan
        (its buckets and each leaf's cut dimension), sized at gradient
        width like :meth:`grad_buckets`; None for every other strategy."""
        if self.grad_sync != GRAD_SYNC_SCATTER:
            return None
        from repro_torch.distributed.gradsync import partition_fsdp_buckets

        return partition_fsdp_buckets(self.grad_leaves(params, param_dtype), self.dp_size,
                                      bucket_mb=self.grad_bucket_mb)

    def shard_layout(self, params, rank: int) -> Dict[str, LeafShard]:
        """``{leaf name: LeafShard}`` (flat order) of rank ``rank`` under
        ``scatter_overlap``: each leaf cut on its :meth:`scatter_plan`
        dimension into ``dp_size`` equal parts, whole where it has none.
        The step, the state placement and the checkpoints share it, as the
        JAX ``scatter_param_specs``."""
        from repro_torch.distributed.gradsync import flat_leaves

        sp = self.scatter_plan(params)
        if sp is None:
            raise ValueError(f"no shard layout: the plan runs {self.grad_sync}, "
                             f"not {GRAD_SYNC_SCATTER}")
        out = {}
        for (name, p), d in zip(flat_leaves(params), sp.shard_dims):
            shape = tuple(p.shape)
            size = shape[d] // sp.n_shards if d is not None else 0
            out[name] = LeafShard(d, rank * size, size, shape)
        return out

    def describe(self) -> Dict[str, Any]:
        """Flat summary for logs and telemetry (the JAX keys that apply)."""
        out = {"mode": self.mode, "dp_axes": ["data"] if self.dp_size > 1 else [],
               "dp_size": self.dp_size, "local_batch": self.local_batch,
               "microbatch": self.microbatch, "grad_sync": self.grad_sync,
               "grad_bucket_mb": self.grad_bucket_mb}
        if self.has_moe:
            out.update(ep_engaged=self.ep_engaged, ep_size=1, n_experts=self.n_experts)
        out["fallback_reason"] = self.fallback_reason
        return out
