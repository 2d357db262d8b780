"""Gradient accumulation: recovers the paper's global batch when the
memory limit shrinks the per-device batch.

The JAX package scans the microbatches with ``lax.scan`` and sums their
gradient trees into f32 zeros; here each microbatch's backward writes
the parameters' ``.grad`` (PyTorch's own accumulation), so peak
activation memory is that of ONE microbatch.  An f32 parameter sums its
microbatches in its f32 ``.grad``.  Any other parameter (bf16) has a
``.grad`` of its own dtype, where every addition would round: its
microbatch gradients are added into an f32 accumulator instead, the sum
is scaled once, and that f32 gradient is what the optimizer and the
gradient sync receive, as in JAX.  With one microbatch, or f32
parameters, nothing extra is allocated.

Accumulation composes with data-parallel gradient sync through the
``sync_grads`` hook (``distributed.gradsync.BucketedAllReduce``):
microbatch gradients accumulate LOCALLY, with no cross-rank traffic, and
the hook is armed for the final microbatch's backward only, so that each
bucket's all-reduce starts as that backward completes the bucket and
runs once per step.  Syncing every microbatch, the classic ddp scaling
bug, would multiply the communication by ``n_micro`` for the same
result.  The hook scales each bucket by ``1 / n_micro`` before its
reduction, as the JAX hook receives the averaged tree, and reduces the
f32 accumulators (plus the final microbatch's gradient) where there are
any.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def f32_accumulators(named: Dict[str, torch.nn.Parameter],
                     n_micro: int) -> Dict[str, torch.Tensor]:
    """f32 zeros for each parameter whose microbatch gradients must not be
    summed in its own dtype: the non-f32 ones, when ``n_micro > 1``."""
    if n_micro <= 1:
        return {}
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items() if p.dtype != torch.float32}


def fold(p: torch.nn.Parameter, acc: torch.Tensor) -> torch.Tensor:
    """Move ``p.grad`` into its f32 accumulator ``acc`` (``.grad`` is left
    None for the next microbatch); returns ``acc``."""
    if p.grad is not None:
        acc.add_(p.grad)
        p.grad = None
    return acc


def add_into(acc: Dict[str, torch.Tensor], named: Dict[str, torch.nn.Parameter]) -> None:
    """:func:`fold` of every accumulated parameter."""
    for k, a in acc.items():
        fold(named[k], a)


def accumulate_grads(loss_fn: Callable, params, batch: Dict[str, torch.Tensor],
                     n_micro: int, sync_grads=None):
    """loss_fn(params, microbatch) -> (loss, metrics).

    Splits every leaf of ``batch`` along axis 0 into ``n_micro`` equal
    microbatches and averages (loss, grads, metrics) over them.  Returns
    (loss, grads, metrics): ``grads`` maps each parameter name of
    ``params`` (an ``nn.Module``) to its gradient; metrics are detached.
    An f32 parameter's gradient (and, with one microbatch, any
    parameter's) also sits in its ``.grad``; the f32 sum of a bf16
    parameter's microbatches is only in ``grads``, with ``.grad`` None.
    ``sync_grads`` (bound to ``params`` with ``bind``) is armed before the
    final microbatch's backward and finished after it; the gradients it
    leaves are the synchronised average."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    n_micro = max(1, n_micro)
    if n_micro > 1:
        for k, x in batch.items():
            if x.shape[0] % n_micro:
                raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does not "
                                 f"split into {n_micro} microbatches")
    micro = [{k: x.chunk(n_micro)[i] for k, x in batch.items()} for i in range(n_micro)]
    acc = f32_accumulators(named, n_micro)
    if sync_grads is not None:
        sync_grads.bind(params)
    loss_sum, met_sum = None, None
    for i, mb in enumerate(micro):
        loss, metrics = loss_fn(params, mb)
        last = i == n_micro - 1
        if sync_grads is not None and last:
            sync_grads.arm(1.0 / n_micro, acc={named[k]: a for k, a in acc.items()})
        loss.backward()
        if not (sync_grads is not None and last):
            add_into(acc, named)
        loss = loss.detach().float()
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        loss_sum = loss if loss_sum is None else loss_sum + loss
        met_sum = metrics if met_sum is None else {k: met_sum[k] + v for k, v in metrics.items()}
    if sync_grads is not None:
        sync_grads.finish()
    scale = 1.0 / n_micro
    grads = {}
    for name, p in named.items():
        if name in acc:
            if sync_grads is None:
                acc[name].mul_(scale)
            grads[name] = acc[name]
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif n_micro > 1 and sync_grads is None:
            p.grad.mul_(scale)
        grads[name] = p.grad
    if n_micro > 1:
        loss_sum = loss_sum * scale
        met_sum = {k: v * scale for k, v in met_sum.items()}
    return loss_sum, grads, met_sum
