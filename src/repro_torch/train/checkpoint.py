"""Checkpointing in the JAX package's on-disk format (``.npz`` of
flattened leaf paths; no extra dependency), so a checkpoint written by
either package restores in the other.

Two layouts, as there:

* Flat: one ``<path>.npz`` + ``<path>.meta.json`` holding the whole
  state — single-process convenience.

* Sharded (multi-host): one directory per step::

      <base>/ckpt-<step:08d>/
          shard-<pidx:05d>.npz            # process p's state arrays
          shard-<pidx:05d>.pipeline.json  # its DataPipeline position
          manifest.json                   # written LAST, by process 0

  Every process writes — and on restore reads — ONLY its own shard.  The
  manifest is the commit record: a step directory without one (a run
  killed mid-save) is ignored by ``latest_step``/``restore_sharded``.
  Shard files are written to a temp name and ``os.replace``-d, so a
  partially-written shard is never taken for a complete one.

A port state ``{"params": Model, "opt": {"mu", "nu", "step"}}``
flattens to the JAX keys (:func:`leaf_key`): parameter
``groups.0.0.mixer.wq`` is ``params/groups/0/0/mixer/wq``, its moments
``opt/mu/...`` and ``opt/nu/...``, the step ``opt/step`` (int32, 0-d);
bf16 leaves are stored upcast to f32, as the JAX ``_flatten`` does.

The port's train step updates parameters and moments IN PLACE (the JAX
step returns new buffers and leaves the old ones intact).  So every save
— sync or :class:`AsyncCheckpointer` — first copies each leaf to host
memory on the caller's thread (device leaves into pinned buffers, then a
synchronise of those copies) and only then returns; the background
thread only serialises that copy, never a tensor the next step changes.

Cross-process sub-shards (the JAX ``SubShardLeaf``) are not ported: one
process owns one card until FSDP (ROADMAP A8).
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.train.faults import fault_point


def leaf_key(path: Sequence) -> str:
    """The flattened key a tree path maps to in the npz layout — the ONE
    spelling shared by save and restore, and the JAX package's
    (``"/".join`` of the dict keys and list indices)."""
    return "/".join(str(q) for q in path)


def _leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a state tree: a module contributes its
    parameters, dicts their keys (a dotted parameter name, as the AdamW
    moments are keyed, is a path of its own), lists their indices;
    anything else is a leaf."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield (*path, *name.split(".")), p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, *str(k).split(".")))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


class HostState(dict):
    """``{leaf_key: numpy array}``: a state copied to host memory, ready to
    serialise (bf16 upcast to f32: npz has no bf16)."""


def snapshot(tree) -> HostState:
    """Copy every leaf of ``tree`` to host memory and return once the
    copies are done.  Device tensors go into pinned buffers by
    ``non_blocking`` copies on the current stream (so they follow the
    step that wrote them), then that stream is synchronised; CPU tensors
    and numpy leaves are cloned."""
    if isinstance(tree, HostState):
        return tree
    host: Dict[str, Any] = {}
    devices = set()
    for path, x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                devices.add(x.device)
            else:
                buf = x.clone()
            host[leaf_key(path)] = buf
        else:
            host[leaf_key(path)] = np.array(x)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()
    out = HostState()
    for k, v in host.items():
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = v
    return out


def _load_into(tree, data, path: Tuple = ()):
    """Fill ``tree`` from the flat mapping ``data``: tensors are written in
    place (cast to their dtype); numpy leaves and numbers come back as
    new arrays of their dtype.  Returns the tree."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                p.copy_(torch.from_numpy(_array(data, (*path, *name.split(".")), p.shape)))
        return tree
    if isinstance(tree, dict):
        for k in sorted(tree):
            tree[k] = _load_into(tree[k], data, (*path, *str(k).split(".")))
        return tree
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            tree[i] = _load_into(v, data, (*path, i))
        return tree
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(torch.from_numpy(_array(data, path, tree.shape)))
        return tree
    want = np.asarray(tree)
    return np.asarray(_array(data, path, want.shape), dtype=want.dtype)


def _array(data, path, shape) -> np.ndarray:
    key = leaf_key(path)
    if key not in data:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    arr = np.asarray(data[key])
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != state shape "
                         f"{tuple(shape)}")
    return arr


def save(path: str, tree, step: int | None = None) -> str:
    """The flat single-file layout: ``<path>.npz`` + ``<path>.meta.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = snapshot(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = {"n_arrays": len(flat), "step": step}
    with open(re.sub(r"\.npz$", "", path) + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


# ---------------------------------------------------------------------------
# Sharded per-process checkpoints
# ---------------------------------------------------------------------------


def step_dir(base_dir: str, step: int) -> str:
    return os.path.join(base_dir, f"ckpt-{step:08d}")


def _shard_name(process_index: int) -> str:
    return f"shard-{process_index:05d}.npz"


def save_sharded(base_dir: str, tree, *, step: int, process_index: int = 0,
                 process_count: int = 1,
                 pipeline_state: Optional[Dict[str, Any]] = None,
                 keep_last_k: int = 0,
                 pin_steps: Tuple[int, ...] = ()) -> str:
    """Write this process's shard of checkpoint ``step`` (module
    docstring).  ``pipeline_state`` is the serialized
    ``DataPipeline.state_at(step)`` — the input-side half of the resume.
    With ``keep_last_k`` > 0, process 0 prunes older committed
    checkpoints right after committing this one's manifest; steps in
    ``pin_steps`` are never pruned.  Returns the step directory."""
    d = step_dir(base_dir, step)
    os.makedirs(d, exist_ok=True)
    flat = snapshot(tree)
    shard = os.path.join(d, _shard_name(process_index))
    # sidecar FIRST, npz last: "shard npz present" must imply "its
    # sidecar is present", so a kill between the writes can only leave a
    # directory _complete_steps already rejects
    if pipeline_state is not None:
        if hasattr(pipeline_state, "to_json"):
            pipeline_state = pipeline_state.to_json()
        pj = re.sub(r"\.npz$", ".pipeline.json", shard)
        with open(pj + ".tmp", "w") as f:
            json.dump(pipeline_state, f)
        os.replace(pj + ".tmp", pj)
    tmp = shard + f".tmp.{os.getpid()}.npz"  # np.savez appends .npz otherwise
    np.savez(tmp, **flat)
    os.replace(tmp, shard)
    # the torn-checkpoint window: shard committed, manifest not
    fault_point("ckpt_commit", step)
    if process_index == 0:
        # commit record: written after process 0's own shard.  Other
        # processes' shards are validated at restore time
        manifest = {"step": step, "process_count": process_count,
                    "n_arrays": len(flat), "format": 1}
        mp = os.path.join(d, "manifest.json")
        with open(mp + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mp + ".tmp", mp)
        if keep_last_k > 0:
            gc_checkpoints(base_dir, keep_last_k, protect=pin_steps)
    return d


def gc_checkpoints(base_dir: str, keep_last_k: int,
                   protect: Tuple[int, ...] = ()) -> List[int]:
    """Prune committed ``ckpt-<step>/`` directories beyond the newest
    ``keep_last_k``.  Only COMMITTED checkpoints (manifest + every shard)
    are counted or deleted, so an in-flight save is never touched.  Steps
    in ``protect`` (a pinned ``--ckpt-step`` resume point) are exempt and
    do not count toward the budget.  Returns the pruned steps."""
    if keep_last_k <= 0:
        return []
    protected = set(protect)
    steps = sorted(s for s, _ in _complete_steps(base_dir)
                   if s not in protected)
    doomed = steps[:-keep_last_k]
    for s in doomed:
        d = step_dir(base_dir, s)
        # crash-consistent prune order: drop the commit record FIRST, so
        # a GC killed mid-rmtree leaves a directory latest_step ignores
        try:
            os.unlink(os.path.join(d, "manifest.json"))
        except OSError:
            pass
        fault_point("gc", s)
        shutil.rmtree(d, ignore_errors=True)
    return doomed


def _complete_steps(base_dir: str):
    """Yield ``(step, manifest)`` for every COMMITTED checkpoint: a
    parseable manifest plus every shard it names.  A torn directory (no
    manifest, a truncated or garbage one, a missing shard) is skipped,
    never raised on: the scan runs right after a crash."""
    if not os.path.isdir(base_dir):
        return
    for name in sorted(os.listdir(base_dir)):
        m = re.fullmatch(r"ckpt-(\d+)", name)
        if not m:
            continue
        d = os.path.join(base_dir, name)
        mp = os.path.join(d, "manifest.json")
        if not os.path.exists(mp):
            continue
        try:
            with open(mp) as f:
                manifest = json.load(f)
            n_procs = int(manifest["process_count"])
        except (ValueError, KeyError, TypeError, OSError):
            continue
        if all(os.path.exists(os.path.join(d, _shard_name(p)))
               for p in range(n_procs)):
            yield int(m.group(1)), manifest


def latest_step(base_dir: str) -> Optional[int]:
    """Newest step with a manifest AND every shard present, or None."""
    steps = [s for s, _ in _complete_steps(base_dir)]
    return max(steps) if steps else None


def restore_sharded(base_dir: str, like, *, step: Optional[int] = None,
                    process_index: int = 0
                    ) -> Tuple[Any, Optional[Dict[str, Any]], Dict[str, Any]]:
    """Restore this process's shard into ``like`` (a port state, filled in
    place, or a tree of numpy leaves).  ``step=None`` picks the newest
    complete checkpoint.  Returns ``(tree, pipeline_state_dict,
    manifest)``; the pipeline state is None when the checkpoint was
    taken without a pipeline."""
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(
                f"no complete sharded checkpoint under {base_dir}")
    d = step_dir(base_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if process_index >= manifest["process_count"]:
        raise ValueError(
            f"process_index {process_index} >= checkpoint process_count "
            f"{manifest['process_count']}")
    shard = os.path.join(d, _shard_name(process_index))
    tree = restore(shard, like)
    pstate = None
    pj = re.sub(r"\.npz$", ".pipeline.json", shard)
    if os.path.exists(pj):
        with open(pj) as f:
            pstate = json.load(f)
    return tree, pstate, manifest


def restore(path: str, like):
    """Restore one shard (or flat) file into ``like`` (see
    :func:`restore_sharded`)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if os.path.exists(re.sub(r"\.npz$", ".subshards.json", path)):
        raise NotImplementedError(
            f"{path} holds cross-process sub-shards (an FSDP checkpoint); "
            "restoring them comes with FSDP (ROADMAP A8)")
    with np.load(path) as data:
        return _load_into(like, data)


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save()`` copies the state to host memory on the caller's thread
    (:func:`snapshot`: the next step changes the state in place) and
    enqueues it; serialization and disk I/O run on a daemon worker.
    ``host_copy_s`` and ``write_s`` sum the two parts' seconds over the
    saves.  Use as a context manager, or call :meth:`close` to flush.
    Worker exceptions are re-raised on the next ``save``/``wait``/
    ``close``.

    With ``sharded=True``, ``path`` is the checkpoint base directory and
    each ``save(step=...)`` writes this process's shard through
    :func:`save_sharded`.
    """

    def __init__(self, path: str, max_pending: int = 2, *,
                 sharded: bool = False, process_index: int = 0,
                 process_count: int = 1, keep_last_k: int = 0,
                 pin_steps: Tuple[int, ...] = ()):
        self.path = path
        self.sharded = sharded
        self.process_index = process_index
        self.process_count = process_count
        self.keep_last_k = keep_last_k
        self.pin_steps = tuple(pin_steps)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self.n_saved = 0
        self.host_copy_s = 0.0
        self.write_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                host, step, pstate = item
                t0 = time.perf_counter()
                if self.sharded:
                    save_sharded(self.path, host, step=step,
                                 process_index=self.process_index,
                                 process_count=self.process_count,
                                 pipeline_state=pstate,
                                 keep_last_k=self.keep_last_k,
                                 pin_steps=self.pin_steps)
                else:
                    save(self.path, host, step=step)
                self.write_s += time.perf_counter() - t0
                self.n_saved += 1
            except BaseException as e:  # noqa: BLE001 — surfaced on the caller
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, tree, step: Optional[int] = None,
             pipeline_state: Optional[Dict[str, Any]] = None):
        """Copy ``tree`` to host memory, then enqueue the write."""
        self._check()
        if self.sharded and step is None:
            raise ValueError("sharded saves need an explicit step")
        if pipeline_state is not None and hasattr(pipeline_state, "to_json"):
            pipeline_state = pipeline_state.to_json()
        t0 = time.perf_counter()
        host = snapshot(tree)
        self.host_copy_s += time.perf_counter() - t0
        self._q.put((host, step, pipeline_state))

    def wait(self):
        """Block until every enqueued checkpoint is on disk."""
        self._q.join()
        self._check()

    def close(self):
        if self._thread.is_alive():
            self._q.join()
            self._q.put(None)
            self._thread.join(timeout=10.0)
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
