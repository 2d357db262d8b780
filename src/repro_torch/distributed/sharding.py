"""Per-host batch slicing for multi-host data parallelism.

The port's copy of the two helpers of the JAX package's
``distributed/sharding.py`` that the data pipeline uses; the rest of
that module (logical axis rules, shardings over a mesh) comes with the
data-parallel and sharded slices.
"""
from __future__ import annotations


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
