"""Host->device batch prefetch (R3 extended across the PCIe hop).

``OrderedPrefetchLoader`` keeps host batches ready; this adapter keeps
*device* batches ready: while the card runs step ``i`` the copies of the
next ``size`` batches are already in flight.  The JAX package gets that
from ``jax.device_put`` being asynchronous; PyTorch needs it spelled out:

* each host batch is staged in **pinned** CPU tensors (a pageable source
  makes ``non_blocking`` copies synchronous);
* the copies run on a dedicated ``torch.cuda.Stream`` with
  ``non_blocking=True``, and an event is recorded there after them;
* when the batch is handed out, the consumer's current stream waits on
  that event (on the device: the host does not block), and every tensor
  is ``record_stream``-ed on the consumer's stream, so the caching
  allocator does not give its memory to a later copy on the side stream
  while a step still reads it.

The pinned staging tensors come from PyTorch's caching host allocator,
which records the copy's stream on them and reuses a block only after
that copy has finished, so a staging buffer is never overwritten while
its copy is in flight.  A leaf that is already on the target device is
handed out as it is, and one already pinned is not staged again.  On the
CPU batches pass through as tensors.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device``; ``cuda`` without an index means
    the current card."""
    if t.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    index = torch.cuda.current_device() if device.index is None else device.index
    return t.device.index == index


def as_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A batch's leaves (numpy arrays or tensors) as tensors; numpy
    arrays are wrapped without a copy."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
            else torch.as_tensor(v) for k, v in batch.items()}


class DevicePrefetch:
    """Wrap a host-batch iterator; yield batches on ``device``.

    Parameters
    ----------
    it:     iterable of dict batches (numpy arrays or tensors).
    device: the target device (``None`` = the card).
    size:   number of device batches kept in flight (2 = classic
            double buffering).
    loader: what produces ``it`` (anything with ``stop()``), stopped by
            ``close()``.

    ``puts`` counts the batches dispatched to the device.
    """

    def __init__(self, it: Iterable[Dict[str, Any]], *,
                 device: Optional[Union[str, torch.device]] = None, size: int = 2,
                 loader=None):
        self._it = iter(it)
        self.loader = loader
        self.device = resolve_device(device)
        self.size = max(1, int(size))
        self.puts = 0
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        """One leaf's copy to the device, on the side stream; a leaf
        already there is kept as it is."""
        if on_device(t, self.device):
            return t
        if not (t.is_cuda or t.is_pinned()):
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _put(self, batch: Dict[str, Any]):
        host = as_tensors(batch)
        self.puts += 1
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            dev = {k: self._copy(t) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _hand_out(self, entry) -> Dict[str, torch.Tensor]:
        batch, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the loader that feeds this prefetch, if it has one."""
        if self.loader is not None:
            self.loader.stop()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        buf: "collections.deque" = collections.deque()
        try:
            while len(buf) < self.size:
                buf.append(self._put(next(self._it)))
        except StopIteration:
            pass
        while buf:
            # dispatch the next copy BEFORE handing out the current
            # batch: the copy overlaps the consumer's step on it
            try:
                buf.append(self._put(next(self._it)))
            except StopIteration:
                pass
            yield self._hand_out(buf.popleft())

