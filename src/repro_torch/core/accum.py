"""Gradient accumulation: recovers the paper's global batch when the
memory limit shrinks the per-device batch.

The JAX package scans the microbatches with ``lax.scan`` and sums their
gradient trees; here each microbatch's backward adds into the
parameters' ``.grad`` (PyTorch's own accumulation), so peak activation
memory is that of ONE microbatch.  The data-parallel ``sync_grads`` hook
of the JAX version comes with the DDP slice.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def accumulate_grads(loss_fn: Callable, params, batch: Dict[str, torch.Tensor],
                     n_micro: int):
    """loss_fn(params, microbatch) -> (loss, metrics).

    Splits every leaf of ``batch`` along axis 0 into ``n_micro`` equal
    microbatches and averages (loss, grads, metrics) over them.  Returns
    (loss, grads, metrics): ``grads`` maps each parameter name of
    ``params`` (an ``nn.Module``) to its gradient, which also sits in the
    parameter's ``.grad``; metrics are detached."""
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
    loss_sum, met_sum = None, None
    for mb in micro:
        loss, metrics = loss_fn(params, mb)
        loss.backward()
        loss = loss.detach().float()
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        loss_sum = loss if loss_sum is None else loss_sum + loss
        met_sum = metrics if met_sum is None else {k: met_sum[k] + v for k, v in metrics.items()}
    scale = 1.0 / n_micro
    grads = {}
    for name, p in named.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif n_micro > 1:
            p.grad.mul_(scale)
        grads[name] = p.grad
    if n_micro > 1:
        loss_sum = loss_sum * scale
        met_sum = {k: v * scale for k, v in met_sum.items()}
    return loss_sum, grads, met_sum
