"""Step builders: the single-device training step (loss, gradients,
AdamW) and the two steps the paged serving engine runs.

The training step follows the JAX package's single-device branch of
``make_train_step``: ``loss_for`` runs the model in train mode (each
layer rematerialised when ``run.remat``), then ``chunked_xent`` streams
the head and the per-token nll one sequence block at a time, each block
under ``torch.utils.checkpoint`` as under ``jax.checkpoint``, with the
nll from ``kernels/ops.xent`` on every device.  The state is
``{"params": Model, "opt": {...}}``; a step updates it in place and
returns it with its metrics (0-d tensors, not yet read on the host).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.accum import accumulate_grads
from repro_torch.kernels import ops as kops
from repro_torch.models.model import Model
from repro_torch.models.transformer import forward, head_apply
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def _act_dtype(run: RunConfig) -> torch.dtype:
    return getattr(torch, run.activation_dtype)


LOSS_TARGET_BYTES = 512e6  # per-device f32 logits per loss block


def loss_chunk_len(global_batch: int, seq: int, vocab: int,
                   n_batch_shards: int) -> int:
    """Seq positions per loss block so per-device f32 logits stay ~512MB.
    Chunking along SEQ preserves the batch sharding (chunking flattened
    global tokens would serialize the loss across devices)."""
    b_loc = max(1, global_batch // max(1, n_batch_shards))
    per_pos = b_loc * vocab * 4.0
    c = int(LOSS_TARGET_BYTES // per_pos)
    return max(8, min(seq, c))


def _xent_block(params, hb, lb, mb, cfg: ModelConfig):
    logits = head_apply(params, hb, cfg)
    V = logits.shape[-1]
    nll = kops.xent(logits.reshape(-1, V), lb.reshape(-1)).reshape(lb.shape)
    acc = (logits.argmax(-1) == lb) * mb
    return (nll * mb).sum(), acc.sum(), mb.sum()


def chunked_xent(params, h, labels, loss_mask, cfg: ModelConfig, *,
                 chunk: int = 512):
    """Streaming loss: unembed + nll one seq block at a time, never
    materializing the full (B, S, V) logits; each block is recomputed in
    the backward.  Returns (sum_nll, sum_correct, denom), f32."""
    B, S, d = h.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        loss_mask = F.pad(loss_mask, (0, pad))
    n = (S + pad) // c
    loss_mask = loss_mask.float()
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    s_nll, s_acc, s_den = zero, zero, zero
    for i in range(n):
        blk = slice(i * c, (i + 1) * c)
        a, b, m = checkpoint(_xent_block, params, h[:, blk], labels[:, blk],
                             loss_mask[:, blk], cfg, use_reentrant=False)
        s_nll, s_acc, s_den = s_nll + a, s_acc + b, s_den + m
    return s_nll, s_acc, s_den


def loss_for(model: Model, params, batch: Dict[str, torch.Tensor], *,
             run: RunConfig):
    """Loss + metrics (``xent``, ``acc``, ``tokens``, ``aux_loss``,
    ``loss``) of one device's batch, the JAX package's global branch
    without a mesh.  ``params`` is the parameter tree (a ``Model``)."""
    cfg = model.cfg
    h, _, aux = forward(params, cfg, batch, mode="train", act_dtype=_act_dtype(run),
                        return_hidden=True, remat=run.remat)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    c = loss_chunk_len(labels.shape[0], labels.shape[1], cfg.vocab_size, 1)
    s_nll, s_acc, s_den = chunked_xent(params, h, labels, mask, cfg, chunk=c)
    den = torch.clamp(s_den, min=1.0)
    loss = s_nll / den
    metrics = {"xent": loss.detach(), "acc": s_acc / den, "tokens": s_den}
    loss = loss + aux
    metrics["aux_loss"] = aux.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def make_train_step(model: Model, run: RunConfig, opt: AdamWConfig) -> Callable:
    """(state, batch) -> (state, metrics); state = {params, opt}, updated
    in place.  Single device: the data-parallel and sharded steps of the
    JAX package come with later slices."""

    def step(state, batch):
        def loss_fn(p, b):
            return loss_for(model, p, b, run=run)

        params = state["params"]
        loss, grads, metrics = accumulate_grads(loss_fn, params, batch,
                                                run.microbatch or 1)
        named = dict(params.named_parameters())
        _, new_opt, opt_metrics = adamw_update(opt, grads, state["opt"], named)
        for p in named.values():
            p.grad = None
        metrics = {**metrics, **opt_metrics}
        return {"params": params, "opt": new_opt}, metrics

    return step


def _param_device(model: Model) -> torch.device:
    return next(model.parameters()).device


def init_state(model: Model, run: RunConfig, seed: Optional[int] = 0):
    """``{"params", "opt"}`` for training ``model``'s config: parameters
    drawn from ``seed`` on the model's device in ``run.param_dtype``, as
    the JAX ``model.init(key)`` draws them (the draws differ between the
    packages); ``seed=None`` takes a copy of ``model``'s own parameters
    (for instance a JAX tree loaded with ``load_jax_params``).  The
    parameters require grad; the AdamW moments are f32 zeros."""
    dtype = getattr(torch, run.param_dtype)
    if seed is None:
        params = copy.deepcopy(model).to(dtype)
    else:
        params = Model(model.cfg, seed=seed, dtype=dtype, device=_param_device(model))
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(dict(params.named_parameters()))}


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
