"""Paged KV cache: fixed-size pages in a preallocated pool.

One POOL of ``n_pages`` fixed-size pages per cache leaf, and a
per-sequence BLOCK TABLE mapping logical page ``j`` of a sequence to a
physical page id: admission allocates just the pages a request needs
(``ceil((prompt + max_new) / page)``), completion frees them at once.

Layout (built by :func:`build_pools` through ``serve/cache.py``'s leaf
walk): sequence leaves are ``(layers, n_pages, page, *feature)``, and ONE
block table serves every layer, because the same physical page id
indexes every layer's pool.  Fixed-size leaves (the SSM conv tails and
state, and the sliding-window rings with their clock ``pos``) are dense
per-slot rows ``(layers, max_slots, *feature)``, written at admission
into the request's batch row; the SSM state row stays f32 whatever the
pools' dtype, and a ring's clock is int32, -1 where the ring is empty.

Physical page 0 is RESERVED as the trash page: it is never allocated,
inactive batch slots' table rows point at it, and their (ignored) decode
writes land there, so the decode step needs no active mask and runs at
one batch shape.

The pools are torch tensors updated IN PLACE (prefill commit and decode
writes); the JAX version rebuilds them functionally with the old buffers
donated.  The allocator is plain host-side Python (a free list).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import cache_shapes
from repro_torch.serve.cache import walk_cache


def pages_for(total_len: int, page: int) -> int:
    """Pages needed to hold positions ``0 .. total_len - 1``."""
    return -(-int(total_len) // int(page))


class PageAllocator:
    """Free-list page allocator over ``n_pages`` physical pages.

    Page 0 is reserved (the trash page) and never handed out."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "need at least one allocatable page"
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise MemoryError(f"KV pool exhausted: want {n} pages, "
                              f"{len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        assert 0 not in out
        return out

    def free(self, pages: List[int]) -> None:
        for p in pages:
            assert 0 < p < self.n_pages and p not in self._free, p
            self._free.append(p)

    def utilization(self) -> float:
        return self.n_used / max(1, self.capacity)


def build_pools(cfg: ModelConfig, *, page: int, n_pages: int, max_slots: int,
                dtype=torch.float32, device=None):
    """Zero-initialized pool tree for ``cfg`` on ``device`` (``None`` =
    the card; structure mirrors the prefill cache, see the module
    docstring for the leaf layouts)."""
    device = resolve_device(device)
    # template shapes at a seq length >= every sliding window, so ring
    # leaves come out at their full W
    max_win = max([s.window for g in cfg.schedule for s in g.pattern
                   if s.window is not None] or [0])
    sds = cache_shapes(cfg, 1, max(page, max_win), dtype)

    def seq_pool(name, v, spec):
        shape, dt = v                            # (layers, 1, S0, *tail)
        return torch.zeros((shape[0], n_pages, page, *shape[3:]), dtype=dt,
                           device=device)

    def fixed_pool(name, v, spec):
        shape, dt = v                            # (layers, 1, *feature)
        if name == "pos":                        # ring clock: (layers, W)
            return torch.full((shape[0], max_slots, shape[1]), -1, dtype=dt,
                              device=device)
        return torch.zeros((shape[0], max_slots, *shape[2:]), dtype=dt,
                           device=device)

    return walk_cache(sds, cfg, seq_pool, fixed_pool)


def _flat_leaves(tree, cfg: ModelConfig):
    seq, fixed = [], []
    walk_cache(tree, cfg, lambda n, v, s: seq.append(v),
               lambda n, v, s: fixed.append(v))
    return seq, fixed


def commit_prefill(pools, prefill_cache, cfg: ModelConfig, *, page: int,
                   slot: int, pages):
    """Write one request's prefill cache into the pools, in place.

    Sequence leaves are cut into ``page``-sized chunks (right-padded to a
    page multiple) and written at physical pages ``pages`` (a
    ``(ceil(S/page),)`` int64 tensor on the pools' device); fixed leaves
    are written to batch row ``slot`` and no other.  Returns ``pools``.
    """
    pool_seq, pool_fixed = _flat_leaves(pools, cfg)
    new_seq, new_fixed = _flat_leaves(prefill_cache, cfg)
    for pool, leaf in zip(pool_fixed, new_fixed, strict=True):
        # a ring's clock "pos" has no batch axis in the prefill cache
        row = leaf if leaf.dim() == pool.dim() - 1 else leaf[:, 0]
        pool[:, slot] = row.to(pool.dtype)
    n_chunks = pages.shape[0]
    for pool, leaf in zip(pool_seq, new_seq, strict=True):
        r, _, S = leaf.shape[:3]
        tail = leaf.shape[3:]
        x = leaf[:, 0]
        Sp = n_chunks * page
        if S < Sp:
            x = torch.cat([x, x.new_zeros((r, Sp - S, *tail))], dim=1)
        pool[:, pages] = x[:, :Sp].reshape(r, n_chunks, page, *tail).to(pool.dtype)
    return pools


@dataclass
class PagedKVCache:
    """Device pools + host-side page accounting for ``max_slots``
    concurrently decoding sequences."""

    cfg: ModelConfig
    page: int
    n_pages: int
    max_slots: int
    max_pages: int                       # block-table width (pages/seq cap)
    pools: Dict = field(repr=False)
    block_tables: np.ndarray = field(repr=False)   # (max_slots, max_pages)
    allocator: PageAllocator = field(repr=False)
    slot_pages: List[Optional[List[int]]] = field(repr=False)
    device: torch.device = field(repr=False)

    @classmethod
    def build(cls, cfg: ModelConfig, *, page: int = 16, n_pages: int = 256,
              max_slots: int = 8, max_pages: Optional[int] = None,
              dtype=torch.float32, device=None) -> "PagedKVCache":
        max_pages = max_pages or (n_pages - 1)
        device = resolve_device(device)
        return cls(
            cfg=cfg, page=page, n_pages=n_pages, max_slots=max_slots,
            max_pages=max_pages,
            pools=build_pools(cfg, page=page, n_pages=n_pages,
                              max_slots=max_slots, dtype=dtype, device=device),
            block_tables=np.zeros((max_slots, max_pages), np.int32),
            allocator=PageAllocator(n_pages),
            slot_pages=[None] * max_slots,
            device=device,
        )

    # ---- admission / release ----------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, p in enumerate(self.slot_pages) if p is None]

    def can_admit(self, total_len: int) -> bool:
        n = pages_for(total_len, self.page)
        return (n <= self.max_pages and self.allocator.can_alloc(n)
                and any(p is None for p in self.slot_pages))

    def admit(self, total_len: int) -> int:
        """Allocate pages for ``total_len`` tokens; returns the slot."""
        n = pages_for(total_len, self.page)
        assert n <= self.max_pages, (n, self.max_pages)
        slot = self.free_slots()[0]
        pages = self.allocator.alloc(n)
        self.slot_pages[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, :n] = pages
        return slot

    def release(self, slot: int) -> None:
        pages = self.slot_pages[slot]
        assert pages is not None, f"slot {slot} not active"
        self.allocator.free(pages)
        self.slot_pages[slot] = None
        self.block_tables[slot] = 0

    # ---- views -------------------------------------------------------
    def tables(self) -> torch.Tensor:
        return torch.from_numpy(self.block_tables).to(self.device)

    def utilization(self) -> float:
        return self.allocator.utilization()

    def pool_bytes(self) -> int:
        seq, fixed = _flat_leaves(self.pools, self.cfg)
        return sum(x.numel() * x.element_size() for x in seq + fixed)
