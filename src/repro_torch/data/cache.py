"""R2: node-local dataset staging.

On the paper's cluster every node copies the packed 25 GB dataset from
Lustre to local SSD before training.  ``StagedDataset`` models the same
two-tier layout: a *network* tier with a simulated shared-bandwidth budget
(contention grows with reader count) and a *local* tier at full speed.
``stage()`` performs the one-time copy and flips reads to the local tier —
the measured crossover is benchmark ``data_staging`` (EXPERIMENTS.md).
"""
from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.data.pack import PackedShard


@dataclass
class NetworkFS:
    """Simulated shared network storage: ``agg_bw`` bytes/s aggregate,
    divided across concurrent readers (Lustre/25GbE contention model)."""

    agg_bw: float = 2e9
    readers: int = 1

    def read_delay(self, nbytes: int) -> float:
        return nbytes / (self.agg_bw / max(1, self.readers))


@dataclass
class StagedDataset:
    shards: List[PackedShard]
    network: Optional[NetworkFS] = None     # None => already local
    local_dir: Optional[str] = None
    staged: bool = field(default=False, init=False)
    stage_seconds: float = field(default=0.0, init=False)

    def stage(self) -> float:
        """One-time copy network -> node-local (R2).  Returns seconds
        (simulated network time + real copy time)."""
        assert self.local_dir
        os.makedirs(self.local_dir, exist_ok=True)
        t0 = time.perf_counter()
        sim = 0.0
        new = []
        for s in self.shards:
            if self.network is not None:
                sim += self.network.read_delay(s.nbytes)
            tp = os.path.join(self.local_dir, os.path.basename(s.tokens_path))
            mp = os.path.join(self.local_dir, os.path.basename(s.mask_path))
            shutil.copyfile(s.tokens_path, tp)
            shutil.copyfile(s.mask_path, mp)
            new.append(PackedShard(tp, mp))
        self.shards = new
        self.network = None
        self.staged = True
        for cached in ("_mmaps", "_shard_sizes", "_shard_offsets"):
            if hasattr(self, cached):   # shard paths changed: drop caches
                delattr(self, cached)
        self.stage_seconds = (time.perf_counter() - t0) + sim
        return self.stage_seconds

    def read_shard(self, i: int):
        """Reads shard i, applying the simulated network delay if unstaged."""
        s = self.shards[i]
        if self.network is not None:
            time.sleep(min(0.05, self.network.read_delay(s.nbytes)))
            # (sleep capped for test speed; benchmarks use read_delay directly)
        toks, mask = s.load()
        return np.asarray(toks), np.asarray(mask)

    # -- flat global index ------------------------------------------------
    # The deterministic pipeline addresses examples by a single global
    # index; rows stay mmapped, so a gather touches only the rows it needs.

    def _mmap(self, i: int):
        """Long-lived read-only mmap of shard ``i`` (reopening the .npy
        per batch dominated gather cost; concurrent reads are safe)."""
        if not hasattr(self, "_mmaps"):
            self._mmaps: dict = {}
        m = self._mmaps.get(i)
        if m is None:
            m = self._mmaps[i] = self.shards[i].load()
        return m

    @property
    def shard_sizes(self) -> List[int]:
        if not hasattr(self, "_shard_sizes"):
            self._shard_sizes = [self._mmap(i)[0].shape[0]
                                 for i in range(len(self.shards))]
        return self._shard_sizes

    @property
    def shard_offsets(self) -> np.ndarray:
        """offsets[i] = global index of shard i's first row (+ total at end)."""
        if not hasattr(self, "_shard_offsets"):
            self._shard_offsets = np.concatenate(
                [[0], np.cumsum(self.shard_sizes)])
        return self._shard_offsets

    def gather(self, indices: np.ndarray):
        """Rows at the given *global* example indices, in the given order.
        Returns (tokens, mask); applies the simulated network delay once
        per shard touched when unstaged."""
        idx = np.asarray(indices, np.int64)
        off = self.shard_offsets
        sid = np.searchsorted(off, idx, side="right") - 1
        toks_out = None
        mask_out = None
        for si in np.unique(sid):
            s = self.shards[int(si)]
            if self.network is not None:
                time.sleep(min(0.05, self.network.read_delay(s.nbytes)))
            toks, mask = self._mmap(int(si))
            sel = sid == si
            rows = idx[sel] - off[int(si)]
            if toks_out is None:
                toks_out = np.empty((len(idx),) + toks.shape[1:], toks.dtype)
                mask_out = np.empty((len(idx),) + mask.shape[1:], mask.dtype)
            toks_out[sel] = toks[rows]
            mask_out[sel] = mask[rows]
        return toks_out, mask_out

    @property
    def n_examples(self) -> int:
        return int(sum(self.shard_sizes))
