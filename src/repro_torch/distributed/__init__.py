"""Data-parallel execution: batch slicing, the ddp plan, bucketed gradient
synchronisation, and the process-group wiring.

:func:`maybe_initialize_distributed` is the twin of the JAX package's:
it joins the default process group when the environment names a
coordinator, and is a no-op otherwise.  Two spellings are read:
``torchrun``'s (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and the JAX package's
(``REPRO_COORDINATOR`` as ``host:port`` or a ``file://`` store,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``).

The backend is a fixed rule, not a fallback chosen on failure: ``nccl``
when every local rank has a card of its own (``LOCAL_WORLD_SIZE <=
torch.cuda.device_count()``), ``gloo`` when ranks share a card (NCCL
refuses two ranks on one device; gloo reduces CUDA tensors through host
memory, and the gradients stay on the card) and on the CPU.  A rank's
card is ``cuda:LOCAL_RANK % device_count``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import ParallelPlan  # noqa: F401

__all__ = ["ParallelPlan", "DistInfo", "maybe_initialize_distributed", "choose_backend"]

# a collective that waits longer than this fails the run instead of hanging it
TIMEOUT = timedelta(seconds=float(os.environ.get("REPRO_DIST_TIMEOUT_S", "600")))


@dataclass(frozen=True)
class DistInfo:
    rank: int
    world: int
    local_rank: int
    local_world: int
    backend: Optional[str]     # None: no process group
    device: torch.device


_info: Optional[DistInfo] = None


def choose_backend(device_type: str, local_world: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _coordinator():
    """(init_method, world, rank, local_rank, local_world) from the
    environment, or None when it names no coordinator."""
    env = os.environ
    if env.get("REPRO_COORDINATOR"):
        coord = env["REPRO_COORDINATOR"]
        world = int(env.get("REPRO_NUM_PROCESSES", "1"))
        rank = int(env.get("REPRO_PROCESS_ID", "0"))
        method = coord if "://" in coord else f"tcp://{coord}"
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        method = "env://"
    else:
        return None
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    return method, world, rank, local_rank, local_world


def maybe_initialize_distributed(device=None) -> DistInfo:
    """Join the default process group when the environment names a
    coordinator; returns this process's :class:`DistInfo` either way.

    ``device`` is the launcher's ``--device`` (``None`` = the card): on
    the card this rank takes ``cuda:LOCAL_RANK % device_count`` and makes
    it current.  Idempotent: once a group is joined, later calls return
    the first answer."""
    global _info
    if _info is not None:
        return _info
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    coord = _coordinator()
    if coord is None:
        return DistInfo(0, 1, 0, 1, None, dev)
    method, world, rank, local_rank, local_world = coord
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev.type, local_world)
    if not dist.is_initialized():
        # NCCL binds the rank to its card now, not by guessing from the rank
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                                timeout=TIMEOUT, **kw)
    _info = DistInfo(rank, world, local_rank, local_world, backend, dev)
    return _info
