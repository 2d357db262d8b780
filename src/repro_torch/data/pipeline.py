"""Deterministic multi-host data pipeline with an explicit, serializable
position — the input side of resumable training.  The port's copy of the
JAX package's ``data/pipeline.py``: the host stages are the same numpy
code, so for the same data, seed, host layout and step both packages
emit the same batches; only the last stage, the device prefetch, is
PyTorch's own (``data/device_prefetch.py``).

``DataPipeline`` composes the whole data layer::

    corpus -> pack (R1) -> staged cache (R2) -> per-host shard assignment
           -> OrderedPrefetchLoader (R3) -> DevicePrefetch

and fixes the two properties the seed ``PrefetchLoader`` lacked:

* **Determinism / multi-host sharding.**  Each epoch draws a single
  *global* permutation of all packed examples, seeded by
  ``(seed, epoch)``.  Global batch ``b`` is the contiguous permutation
  slice ``perm[b*G:(b+1)*G]`` (``G = batch_size * process_count``) and
  host ``p`` owns rows ``[p*batch_size, (p+1)*batch_size)`` of it — so
  hosts read disjoint, covering slices of one deterministic global order,
  and the per-batch augmentation RNG is keyed by ``(seed, epoch, b)``,
  never by worker id.  The emitted stream is a pure function of the
  integer cursor: any worker count, any prefetch depth, any host produces
  the same batches.

* **Resumability.**  ``state_at(global_step)`` returns the serializable
  :class:`PipelineState` describing the input position *after* that many
  consumed batches; ``restore(state)`` re-aims the pipeline there.
  Because the stream is a pure function of the cursor, a checkpoint needs
  no queue contents, thread state, or in-flight device buffers — the
  sharded checkpointer (``train/checkpoint.py``) stores the state as a
  small JSON blob next to each process's array shard.

``autotune()`` folds the two R3 knobs (loader workers, device-prefetch
depth) into one loop driven by a measured stall fraction: grow
``n_workers`` while the consumer stalls above target, then grow the
device-prefetch depth, stop as soon as the target is met ("until
utilization stabilizes — and no more").
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data.cache import NetworkFS, StagedDataset
from repro_torch.data.device_prefetch import DevicePrefetch
from repro_torch.data.loader import OrderedPrefetchLoader
from repro_torch.observability import get_tracer
from repro_torch.distributed.sharding import (local_batch_size,
                                        process_batch_slice)


# ---------------------------------------------------------------------------
# PipelineState
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineState:
    """Serializable input position.  ``global_step`` is the number of
    batches consumed since step 0 (absolute, across epochs and resumes);
    epoch/cursor are derived but stored explicitly so a manifest is
    self-describing.  ``worker_seed`` is the base of every derived RNG:
    the batch-``b`` augmentation stream is ``default_rng([worker_seed,
    epoch, b])``, which makes worker RNG state a pure function of the
    cursor (no per-thread state to snapshot)."""

    seed: int
    global_step: int
    epoch: int
    cursor: int               # next global batch index within the epoch
    process_index: int
    process_count: int
    batch_size: int           # per-host
    n_examples: int
    worker_seed: int

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PipelineState":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# DataPipeline
# ---------------------------------------------------------------------------


class DataPipeline:
    """See module docstring.  ``batch_size`` is the *per-host* batch; the
    deterministic global order is over ``batch_size * process_count``
    examples per step.  ``work_fn(batch, rng)`` runs per batch in the
    loader workers (e.g. MLM masking) with an rng keyed by the global
    batch index."""

    def __init__(self, ds: StagedDataset, batch_size: int, *,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, n_workers: int = 1,
                 host_prefetch: int = 4, device_prefetch: int = 2,
                 work_fn: Optional[Callable] = None,
                 drop_remainder: bool = True):
        if not drop_remainder:
            raise NotImplementedError(
                "partial final batches would change program shapes")
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.n_workers = max(1, n_workers)
        self.host_prefetch = max(1, host_prefetch)
        self.device_prefetch = max(1, device_prefetch)
        self.work_fn = work_fn
        self.global_batch = batch_size * process_count
        # validates divisibility + index range
        self._slice = process_batch_slice(self.global_batch, process_index,
                                          process_count)
        assert local_batch_size(self.global_batch, process_count) \
            == batch_size
        n = ds.n_examples
        if n < self.global_batch:
            raise ValueError(
                f"dataset has {n} examples < global batch "
                f"{self.global_batch}")
        self.batches_per_epoch = n // self.global_batch
        self._start_step = 0      # absolute global step the next iter begins at
        self._perm_cache: Dict[int, np.ndarray] = {}
        self._loaders: List[OrderedPrefetchLoader] = []

    # -- deterministic order ---------------------------------------------

    def _perm(self, epoch: int) -> np.ndarray:
        """Epoch-seeded global permutation (cached; one epoch's int64
        permutation of the whole dataset is small next to the data)."""
        perm = self._perm_cache.get(epoch)
        if perm is None:
            rng = np.random.default_rng([self.seed, epoch])
            perm = rng.permutation(self.ds.n_examples)
            if len(self._perm_cache) > 2:   # keep current + neighbors
                self._perm_cache.clear()
            self._perm_cache[epoch] = perm
        return perm

    def batch_indices(self, global_step: int) -> np.ndarray:
        """Global example indices of THIS host's slice of batch
        ``global_step`` — the whole sharding scheme in four lines."""
        epoch = global_step // self.batches_per_epoch
        b = global_step % self.batches_per_epoch
        rows = self._perm(epoch)[b * self.global_batch:
                                 (b + 1) * self.global_batch]
        return rows[self._slice]

    def _batch(self, global_step: int) -> Dict[str, np.ndarray]:
        # lane=None: spans land on the calling loader worker's lane
        # (Tracer.thread_lane), nesting under its batch_fetch span
        tracer = get_tracer()
        with tracer.span("gather", None, step=global_step):
            toks, mask = self.ds.gather(self.batch_indices(global_step))
        batch = {"tokens": toks.astype(np.int32),
                 "attn_mask": mask.astype(np.float32)}
        if self.work_fn is not None:
            epoch = global_step // self.batches_per_epoch
            b = global_step % self.batches_per_epoch
            rng = np.random.default_rng([self.seed, epoch, b])
            with tracer.span("work_fn", None, step=global_step):
                batch = self.work_fn(batch, rng)
        return batch

    # -- state ------------------------------------------------------------

    def state_at(self, global_step: int) -> PipelineState:
        """Input position after ``global_step`` consumed batches.  Pure:
        does not depend on how far workers or device prefetch ran ahead."""
        return PipelineState(
            seed=self.seed, global_step=global_step,
            epoch=global_step // self.batches_per_epoch,
            cursor=global_step % self.batches_per_epoch,
            process_index=self.process_index,
            process_count=self.process_count,
            batch_size=self.batch_size, n_examples=self.ds.n_examples,
            worker_seed=self.seed)

    @property
    def start_step(self) -> int:
        return self._start_step

    def restore(self, state) -> "DataPipeline":
        """Re-aim the pipeline at a saved position.  Accepts a
        :class:`PipelineState` or its ``to_json`` dict.  The dataset,
        seed and per-host layout (batch x process count) must match;
        ``process_index`` may differ.  The elastic (global-batch)
        restore of the JAX package comes with resharding (ROADMAP A12)."""
        if isinstance(state, dict):
            state = PipelineState.from_json(state)
        if state.n_examples != self.ds.n_examples:
            raise ValueError(
                f"checkpoint was taken over {state.n_examples} examples, "
                f"dataset has {self.ds.n_examples}")
        if (state.batch_size, state.process_count) != \
                (self.batch_size, self.process_count):
            raise ValueError(
                "checkpoint batch/process layout "
                f"({state.batch_size} x {state.process_count}) != pipeline "
                f"({self.batch_size} x {self.process_count})")
        if state.seed != self.seed:
            raise ValueError(
                f"checkpoint seed {state.seed} != pipeline seed {self.seed}")
        self._start_step = state.global_step
        return self

    # -- iteration --------------------------------------------------------

    def _loader(self) -> OrderedPrefetchLoader:
        """A FRESH loader at the pipeline's current start position
        (measurement passes don't advance training), stopped by
        ``close()``."""
        # prune loaders that were already stopped so long-lived pipelines
        # (repeated runs / measurement passes) don't accumulate them
        self._loaders = [ld for ld in self._loaders
                         if not ld._stop.is_set()]
        loader = OrderedPrefetchLoader(
            self._batch, n_workers=self.n_workers,
            prefetch=self.host_prefetch, start=self._start_step)
        self._loaders.append(loader)
        return loader

    def host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite host-batch iterator starting at the pipeline's current
        start position, from a fresh loader."""
        return iter(self._loader())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.host_batches()

    def peek_batch(self, offset: int = 0) -> Dict[str, np.ndarray]:
        """Materialize the batch ``offset`` steps ahead of the current
        start position without advancing anything (compile warmup,
        step-time probes)."""
        return self._batch(self._start_step + offset)

    def device_batches(self, device=None) -> DevicePrefetch:
        """Host batches from a fresh loader through the pinned,
        side-stream host->device prefetch onto ``device`` (``None`` = the
        card), ``device_prefetch`` batches in flight.  The returned
        ``DevicePrefetch`` is iterable; its ``puts`` counts the batches
        placed and its ``close()`` stops the loader."""
        loader = self._loader()
        return DevicePrefetch(iter(loader), device=device, size=self.device_prefetch,
                              loader=loader)

    def close(self):
        for ld in self._loaders:
            ld.stop()
        self._loaders.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- autotune (R3 end-to-end) -----------------------------------------

    def autotune(self, *, step_time_s: Optional[float] = None,
                 probe: Optional[Callable[["DataPipeline"], float]] = None,
                 target_stall: float = 0.05, max_workers: int = 8,
                 max_depth: int = 4, n_batches: int = 30) -> Dict[str, Any]:
        """Fold the loader/prefetch knobs into one tuner driven by a
        measured stall fraction.

        ``probe(pipeline) -> stall_fraction`` measures end-to-end with the
        real runner (``TrainLoop`` telemetry); when absent, a simulated
        consumer with accelerator step time ``step_time_s`` is used.
        Strategy: grow ``n_workers`` while the stall exceeds the target
        and adding a worker still helps, then grow ``device_prefetch``
        depth, and stop at the target — R3's "until utilization
        stabilizes, and no more".  The depth phase only runs with a real
        ``probe``: the simulated consumer reads host batches directly, so
        a depth change is invisible to it and accept/reject would be pure
        timing noise."""
        tune_depth = probe is not None
        if probe is None:
            if step_time_s is None:
                raise ValueError("need step_time_s or probe")
            probe = lambda p: p._simulated_stall(step_time_s, n_batches)
        history: List[Dict[str, float]] = []

        def measure() -> float:
            s = probe(self)
            history.append({"n_workers": self.n_workers,
                            "device_prefetch": self.device_prefetch,
                            "stall_fraction": s})
            return s

        stall = measure()
        while stall > target_stall and self.n_workers < max_workers:
            self.n_workers += 1
            new = measure()
            if new > stall - 0.01:      # stopped helping: undo and move on
                self.n_workers -= 1
                history[-1]["rejected"] = 1.0
                break
            stall = new
        while tune_depth and stall > target_stall \
                and self.device_prefetch < max_depth:
            self.device_prefetch += 1
            new = measure()
            if new > stall - 0.01:
                self.device_prefetch -= 1
                history[-1]["rejected"] = 1.0
                break
            stall = new
        return {"n_workers": self.n_workers,
                "device_prefetch": self.device_prefetch,
                "stall_fraction": stall, "history": history}

    def _simulated_stall(self, step_time_s: float, n_batches: int) -> float:
        """Consume ``n_batches`` from a throwaway loader with a simulated
        accelerator step; returns the consumer stall fraction."""
        import time as _time

        loader = self._loader()
        self._loaders.pop()             # throwaway: don't keep for close()
        it = iter(loader)
        try:
            next(it)                    # warm the workers
            for _ in range(n_batches):
                next(it)
                if step_time_s:
                    _time.sleep(step_time_s)
            return loader.stall_fraction
        finally:
            loader.stop()

    # -- construction helpers ---------------------------------------------

    @classmethod
    def build(cls, data_dir: str, *, n_functions: int, seq_len: int,
              batch_size: int, vocab_size: int = 1024,
              max_merges: int = 300, corpus_seed: int = 0,
              network: Optional[NetworkFS] = None, stage: bool = True,
              **kw) -> "DataPipeline":
        """Corpus -> pack -> staged cache -> pipeline, end to end.  Reuses
        ``data_dir`` contents when already built (same layout as
        ``launch/train.py`` used inline); the tokenizer rides along as
        ``pipeline.tokenizer``."""
        from repro_torch.data.corpus import read_raw_corpus, write_raw_corpus
        from repro_torch.data.pack import PackedShard, pack_corpus
        from repro_torch.data.tokenizer import ByteBPETokenizer

        os.makedirs(data_dir, exist_ok=True)
        raw = os.path.join(data_dir, "raw.jsonl")
        meta_p = os.path.join(data_dir, "pipeline_build.json")
        tok_p = os.path.join(data_dir, "tokenizer.json")
        want = {"n_functions": n_functions, "seq_len": seq_len,
                "vocab_size": vocab_size, "max_merges": max_merges,
                "corpus_seed": corpus_seed}
        built = None
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                built = json.load(f)
        if built and built.get("params") == want:
            tok = ByteBPETokenizer.load(tok_p)
            shards = [PackedShard(t, m) for t, m in built["shards"]]
        else:
            write_raw_corpus(raw, n_functions, seed=corpus_seed)
            fns = list(read_raw_corpus(raw))
            tok = ByteBPETokenizer.train(fns[:64], vocab_size=vocab_size,
                                         max_merges=max_merges)
            tok.save(tok_p)
            shards = pack_corpus(iter(fns), tok,
                                 os.path.join(data_dir, "packed"),
                                 seq_len=seq_len)
            with open(meta_p, "w") as f:
                json.dump({"params": want,
                           "shards": [[s.tokens_path, s.mask_path]
                                      for s in shards]}, f)
        local = os.path.join(data_dir, "local")
        already_staged = built is not None and built.get("params") == want \
            and os.path.isdir(local)
        ds = StagedDataset(shards, network=network,
                           local_dir=local if stage else None)
        if stage and not already_staged:
            ds.stage()
        elif already_staged:
            ds.shards = [PackedShard(
                os.path.join(local, os.path.basename(s.tokens_path)),
                os.path.join(local, os.path.basename(s.mask_path)))
                for s in shards]
            ds.network = None
            ds.staged = True
        pipe = cls(ds, batch_size, **kw)
        pipe.tokenizer = tok
        return pipe
