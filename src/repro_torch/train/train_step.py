"""Step builders.  So far only the two the paged serving engine runs;
the training steps come with the training slice."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import forward, head_apply


def _act_dtype(run: RunConfig) -> torch.dtype:
    return getattr(torch, run.activation_dtype)


def make_paged_prefill_step(model: Model, run: RunConfig) -> Callable:
    """Bucketed prefill for the paged engine: ``tokens`` is ONE prompt
    (1, S) right-padded to a bucket length, ``length`` its true length.
    Returns (last-real-position logits (1,1,V), prefill cache)."""

    def prefill(params, tokens, length: int):
        h, cache, _ = forward(
            params, model.cfg, {"tokens": tokens}, mode="prefill",
            act_dtype=_act_dtype(run), return_hidden=True,
            paged={"length": length})
        return head_apply(params, h[:, length - 1:length], model.cfg), cache

    return prefill


def make_paged_decode_step(model: Model, run: RunConfig, page: int) -> Callable:
    """One continuous-batching decode tick at a FIXED batch shape
    (``max_slots`` rows; inactive rows write the trash page): ``pools``
    are the paged KV pools, updated in place; ``positions`` is (B,)
    int32 per slot, ``tables`` the (B, max_pages) int32 block tables."""

    def decode(params, pools, tokens, positions, tables):
        logits, pools, _ = forward(
            params, model.cfg, {"tokens": tokens, "pos": positions},
            mode="decode", cache=pools, act_dtype=_act_dtype(run),
            paged={"tables": tables, "page": page})
        return logits, pools

    return decode
