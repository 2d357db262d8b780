"""Step builders: the training step (loss, gradients, AdamW), single
device or data-parallel, and the two steps the paged serving engine runs.

The training step follows the JAX package's ``make_train_step``:
``loss_for`` runs the model in train mode (each layer rematerialised
when ``run.remat``), then ``chunked_xent`` streams the head and the
per-token nll one sequence block at a time, each block under
``torch.utils.checkpoint`` as under ``jax.checkpoint``, with the nll from
``kernels/ops.xent`` on every device.  The state is ``{"params": Model,
"opt": {...}}``; a step updates it in place and returns it with its
metrics (0-d tensors, not yet read on the host).

Under a data-parallel plan (``distributed.sharding.ParallelPlan``, one
process a shard) every rank runs the per-shard loss on its rows and the
gradients are summed across the process group: ``bucketed_overlap`` by
one all-reduce per reverse-layer bucket from backward hooks, the
``xla_fused`` fallback by one all-reduce after the backward over global
microbatches.  AdamW then applies the same summed gradient on every rank,
so the replicas stay equal without a broadcast.  ``make_grad_fn`` is the
step minus the optimizer; both share one core.

Under ``scatter_overlap`` (fsdp, ZeRO-3) the state is each rank's slices
(:func:`shard_state`): the step gathers the full parameters (one
all-gather a bucket), runs the same per-shard loss on them, returns
summed gradient shards (one reduce-scatter a bucket) and whole leaves
(one all-reduce a bucket), and AdamW updates this rank's shards of
parameters and moments with the global clipping norm
(``gradsync.fsdp_global_norm``).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.accum import accumulate_grads, add_into, f32_accumulators
from repro_torch.distributed import gradsync
from repro_torch.distributed.sharding import (GRAD_SYNC_BUCKETED, GRAD_SYNC_NONE,
                                              GRAD_SYNC_SCATTER, LeafShard, ParallelPlan)
from repro_torch.kernels import ops as kops
from repro_torch.models.model import Model
from repro_torch.models.params import ParamTree, tree_of
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


def shard_sums(model: Model, params, batch: Dict[str, torch.Tensor], run: RunConfig,
               moe_ctx=None):
    """(sum nll, sum correct, loss-mask sum, aux) of the rows in ``batch``;
    the loss blocks' length follows these rows, as in the JAX per-shard
    call.  ``moe_ctx``: the MoE layers' keywords (``forward``)."""
    cfg = model.cfg
    h, _, aux = forward(params, cfg, batch, mode="train", act_dtype=_act_dtype(run),
                        return_hidden=True, remat=run.remat, moe_ctx=moe_ctx)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    c = loss_chunk_len(labels.shape[0], labels.shape[1], cfg.vocab_size, 1)
    s_nll, s_acc, s_den = chunked_xent(params, h, labels, mask, cfg, chunk=c)
    return s_nll, s_acc, s_den, aux


def loss_for(model: Model, params, batch: Dict[str, torch.Tensor], *,
             run: RunConfig, dp_size: int = 1):
    """Loss + metrics (``xent``, ``acc``, ``tokens``, ``aux_loss``,
    ``loss``).  ``params`` is the parameter tree (a ``Model``).

    * Global (``dp_size`` 1): the loss of this batch.
    * Per-shard (``dp_size`` > 1, the JAX ``axis_names`` call): ``batch``
      is this rank's shard (the default process group's) and the
      returned loss its contribution
      ``s_nll / global_den + aux / dp_size``, built so that a plain SUM of
      the ranks' gradients is the global-batch gradient.  Only the mask
      sum is reduced before the backward, on a detached tensor; the
      metrics are reduced with it (outside autograd) and are global.  An
      MoE model's router statistics are averaged over the group
      (``gradsync.router_stat_mean``, JAX's ``stat_axes``), so that each
      rank's aux is the global one and ``aux / dp_size`` summed over
      the ranks gives JAX's gradient."""
    moe_ctx = {"stat_reduce": gradsync.router_stat_mean} \
        if dp_size > 1 and model.cfg.moe is not None else None
    s_nll, s_acc, s_den, aux = shard_sums(model, params, batch, run, moe_ctx=moe_ctx)
    if dp_size > 1:
        red = torch.stack([s_den, s_nll, s_acc, aux]).detach().float()
        dist.all_reduce(red)
        g_den, g_nll, g_acc, g_aux = red.unbind()
        den = torch.clamp(g_den, min=1.0)
        loss = s_nll / den + aux / dp_size
        xent = g_nll / den
        metrics = {"xent": xent, "acc": g_acc / den, "tokens": g_den,
                   "aux_loss": g_aux / dp_size, "loss": xent + g_aux / dp_size}
        return loss, metrics
    den = torch.clamp(s_den, min=1.0)
    loss = s_nll / den
    metrics = {"xent": loss.detach(), "acc": s_acc / den, "tokens": s_den}
    loss = loss + aux
    metrics["aux_loss"] = aux.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def _bucketed_accum(model: Model, run: RunConfig, plan: ParallelPlan):
    """Shared core of the bucketed ddp step and grad function: per-shard
    loss, local microbatch accumulation, one all-reduce per reverse-layer
    bucket from the final microbatch's backward.  Returns ``accum(params,
    local_batch) -> (loss, grads, metrics)`` (the loss is this shard's
    contribution; grads and metrics are global) with the hooks' owner as
    ``accum.sync``."""
    buckets = plan.grad_buckets(model, getattr(torch, run.param_dtype))
    sync = gradsync.BucketedAllReduce(buckets)

    def accum(params, batch):
        def loss_fn(p, b):
            return loss_for(model, p, b, run=run, dp_size=plan.dp_size)

        return accumulate_grads(loss_fn, params, batch, run.microbatch or 1, sync_grads=sync)

    accum.sync = sync
    return accum


def _fused_accum(model: Model, run: RunConfig, plan: ParallelPlan):
    """The ``xla_fused`` fallback, as the JAX partitioner runs it: the
    GLOBAL batch splits into ``n_micro`` microbatches of ``global /
    n_micro`` rows, each averaged over its own global mask sum, and the
    gradients are summed by one all-reduce after the backward.  A rank
    runs the part of each microbatch that lies in its rows (possibly
    none); one all-reduce of the per-microbatch mask sums comes first.

    An MoE model's aux, ``E sum(me ce) coef``, is nonlinear in the router
    means of the whole global microbatch (JAX computes it there), so a
    piece's share of it is not its own aux.  Over several ranks the step
    therefore first runs a no-grad forward of its pieces that collects,
    for each microbatch and MoE layer, the sum of the router
    probabilities and the experts' token counts, and sums them over the
    ranks with one all-reduce of an (n_micro, n_moe_layers, E, 2) tensor;
    a microbatch's token count is its rows times S.  In the gradient pass
    each piece's router sees ``me = (global sum - piece's pre-pass sum +
    piece's sum) / T_m`` (its own probabilities carry the gradient, the
    rest is constant) and ``ce`` = the global counts / T_m, so it computes
    microbatch m's whole aux, adds ``aux_m / n`` to the loss it
    differentiates, and the all-reduce of the gradients sums the pieces'
    partials into the gradient of JAX's aux.  The routes of the pre-pass,
    the gradient pass and its remat recompute are the same (the dispatch
    repeats bit for bit).  The price is one more forward of the pieces,
    on this fallback path only."""
    n = run.microbatch or 1
    G, local = plan.global_batch, plan.local_batch
    if G % n:
        raise ValueError(f"global batch {G} does not split into {n} microbatches")
    c = G // n
    cfg = model.cfg
    moe = cfg.moe is not None and plan.dp_size > 1

    def router_sums(params, batch, pieces):
        """(own, total), each (n_micro, n_moe_layers, E, 2): this rank's
        pieces' router probability sums and expert counts (a rank holds
        at most one piece of a microbatch), and their sums over the ranks."""
        n_moe = sum(g.repeats * sum(int(s.moe) for s in g.pattern) for g in cfg.schedule)
        own = torch.zeros((n, n_moe, cfg.moe.n_experts, 2), dtype=torch.float32,
                          device=batch["labels"].device)
        for m, a, b in pieces:
            if b <= a:
                continue
            T = (b - a) * batch["labels"].shape[1]

            def ctx(li, m=m, T=T):
                def stat(me, ce):
                    own[m, li] = torch.stack([me, ce], -1).float() * T
                    return me, ce
                return {"stat_reduce": stat}

            with torch.no_grad():
                forward(params, cfg, {k: v[a:b] for k, v in batch.items()}, mode="train",
                        act_dtype=_act_dtype(run), return_hidden=True, moe_ctx=ctx)
        total = own.clone()
        dist.all_reduce(total)
        return own, total

    def piece_ctx(own, total, m, T, Tm):
        """The gradient pass's router statistics for this rank's piece of
        microbatch m (T of its Tm tokens): the whole microbatch's means,
        with this piece's probabilities carrying the gradient."""
        def ctx(li):
            rest = total[m, li, :, 0] - own[m, li, :, 0]
            ce = total[m, li, :, 1] / Tm

            def stat(me_piece, _):
                return (rest + me_piece * T) / Tm, ce
            return {"stat_reduce": stat}
        return ctx

    def accum(params, batch):
        lo = dist.get_rank() * local
        pieces = [(m, max(m * c, lo) - lo, min((m + 1) * c, lo + local) - lo) for m in range(n)]
        ref = batch["labels"]
        S = ref.shape[1]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(ref.shape, dtype=torch.float32, device=ref.device)
        den = torch.stack([mask[a:b].float().sum() if b > a else
                           torch.zeros((), device=ref.device) for _, a, b in pieces])
        dist.all_reduce(den)
        tokens, den = den, torch.clamp(den, min=1.0)
        if moe:
            own, total = router_sums(params, batch, pieces)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        # bf16 parameters sum their microbatches in f32 (core.accum)
        acc = f32_accumulators(named, n)
        sums = torch.zeros((n, 3), dtype=torch.float32, device=ref.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=ref.device)
        for m, a, b in pieces:
            if b <= a:
                continue
            ctx = piece_ctx(own, total, m, (b - a) * S, c * S) if moe else None
            s_nll, s_acc, _, aux = shard_sums(model, params,
                                               {k: v[a:b] for k, v in batch.items()}, run,
                                               moe_ctx=ctx)
            # the piece's part of the reported loss and aux: a row share
            # (an MoE piece's aux is its whole microbatch's, which its
            # gradient takes whole: the pieces' partials sum to JAX's)
            share = aux * ((b - a) / c)
            loss = (s_nll / den[m] + (aux if moe else share)) / n
            loss.backward()
            add_into(acc, named)
            loss_sum = loss_sum + ((s_nll / den[m] + share) / n).detach().float()
            sums[m] = torch.stack([s_nll, s_acc, share]).detach().float()
        for k, p in named.items():
            if p.grad is None and k not in acc:
                p.grad = torch.zeros_like(p)
        grads = {k: acc.get(k, p.grad) for k, p in named.items()}
        gradsync.fused_all_reduce([grads[k] for k, _ in gradsync.flat_leaves(params)])
        dist.all_reduce(sums)
        xent = (sums[:, 0] / den).mean()
        aux = sums[:, 2].mean()
        metrics = {"xent": xent, "acc": (sums[:, 1] / den).mean(), "tokens": tokens.mean(),
                   "aux_loss": aux, "loss": xent + aux}
        return loss_sum, grads, metrics

    accum.sync = None
    return accum


def _scatter_accum(model: Model, run: RunConfig, plan: ParallelPlan):
    """The ``scatter_overlap`` (fsdp) core, JAX's ``_scatter_accum`` with its
    three branches.  ``accum(shard params, local batch) -> (loss, grads,
    metrics)``: grads in the state's layout (summed shards where a leaf is
    cut, the whole summed leaf where not), the loss this shard's
    contribution, the metrics global.  ``accum.scatter`` is the bucket
    plan.

    * One microbatch (JAX's ``donate_gather``), and ``free_after_use``:
      differentiate FROM THE SHARDS, the gather inside autograd, so the
      gradient of each bucket comes back through its reduce-scatter as
      the backward completes it and the full gradient tree is never
      formed.  Under ``free_after_use`` each microbatch gathers under
      ``torch.utils.checkpoint`` and again in its backward (``2 x
      n_micro`` gathers and ``n_micro`` reduce-scatters a bucket a step).
    * Otherwise gather ONCE, outside autograd, accumulate the
      microbatches' full gradients locally (f32 accumulators for bf16
      parameters, ``core.accum``), then one reduce-scatter a bucket of
      their mean.

    The whole leaves' gradients are summed by one all-reduce a psum
    bucket after the backward."""
    sp = plan.scatter_plan(model, getattr(torch, run.param_dtype))
    n_micro = run.microbatch or 1
    names = [k for k, _ in gradsync.flat_leaves(model)]

    def loss_fn(p, b):
        return loss_for(model, p, b, run=run, dp_size=plan.dp_size)

    def gathered(params, **kw):
        full = gradsync.gather_fsdp_params([p for _, p in gradsync.flat_leaves(params)],
                                           sp, **kw)
        by_name = dict(zip(names, full))
        return tree_of(params, lambda k, _: by_name[k])

    if n_micro == 1 or plan.free_after_use:
        def shard_loss(params, b):
            return loss_fn(gathered(params, free_after_use=plan.free_after_use), b)

        def accum(params, batch):
            loss, grads, metrics = accumulate_grads(shard_loss, params, batch, n_micro)
            gradsync.bucketed_all_reduce([grads[k] for k in names], sp.psum)
            return loss, grads, metrics
    else:
        def accum(params, batch):
            with torch.no_grad():
                full = ParamTree(gathered(params))
            full.requires_grad_(True)
            loss, grads, metrics = accumulate_grads(loss_fn, full, batch, n_micro)
            del full
            shards = gradsync.bucketed_psum_scatter([grads[k] for k in names], sp)
            return loss, dict(zip(names, shards)), metrics

    accum.sync = None
    accum.scatter = sp
    return accum


def shard_state(state, layout: Dict[str, LeafShard]):
    """The fsdp state of one rank from a full state: this rank's slices of
    the parameters and AdamW moments (``layout``:
    ``ParallelPlan.shard_layout``), each a copy of its own, so the full
    leaves are freed with ``state``.  The parameters are a ``ParamTree`` of
    the model's shape whose ``shard_layout`` attribute is ``layout`` (the
    checkpoints read it)."""
    def part(k, x):
        return layout[k].take(x.detach()).clone()

    full = state["params"]
    params = ParamTree(tree_of(full, part))
    params.requires_grad_(True)
    params.shard_layout = dict(layout)
    opt = state["opt"]
    return {"params": params,
            "opt": {"mu": {k: part(k, v) for k, v in opt["mu"].items()},
                    "nu": {k: part(k, v) for k, v in opt["nu"].items()},
                    "step": opt["step"].clone()}}


def _accum(model: Model, run: RunConfig, plan: Optional[ParallelPlan]):
    """The gradient core of ``plan``'s strategy: (params, batch) -> (loss,
    grads, metrics), with ``.sync`` the bucket hooks' owner or None.  An
    fsdp plan runs as ``scatter_overlap`` or raises: the port has no
    sharded fallback."""
    if plan is not None and plan.mode == "fsdp" and plan.grad_sync not in (
            GRAD_SYNC_SCATTER, GRAD_SYNC_NONE):
        raise ValueError(f"an fsdp plan that reads {plan.grad_sync} "
                         f"({plan.fallback_reason}) does not run: the port trains fsdp as "
                         f"{GRAD_SYNC_SCATTER} only")
    if plan is not None and plan.grad_sync == GRAD_SYNC_SCATTER:
        return _scatter_accum(model, run, plan)
    if plan is None or plan.grad_sync == GRAD_SYNC_NONE:
        def accum(params, batch):
            return accumulate_grads(lambda p, b: loss_for(model, p, b, run=run),
                                    params, batch, run.microbatch or 1)

        accum.sync = None
        return accum
    if plan.grad_sync == GRAD_SYNC_BUCKETED:
        return _bucketed_accum(model, run, plan)
    return _fused_accum(model, run, plan)


def make_train_step(model: Model, run: RunConfig, opt: AdamWConfig,
                    plan: Optional[ParallelPlan] = None) -> Callable:
    """(state, batch) -> (state, metrics); state = {params, opt}, updated
    in place.  ``plan`` picks the gradient sync (module docstring); under
    a data-parallel plan ``batch`` is this rank's shard.  The step's
    ``sync`` attribute is the bucket hooks' owner (or None), its
    ``scatter`` the fsdp bucket plan (or None).  Under ``scatter_overlap``
    ``state`` is this rank's shards (:func:`shard_state`)."""
    accum = _accum(model, run, plan)
    sp = getattr(accum, "scatter", None)

    def step(state, batch):
        params = state["params"]
        _, grads, metrics = accum(params, batch)
        named = dict(params.named_parameters())
        kw = {}
        if sp is not None:      # the shards' norm: one scalar all-reduce
            kw["grad_norm"] = gradsync.fsdp_global_norm(
                [grads[k] for k, _ in gradsync.flat_leaves(params)], sp)
        _, new_opt, opt_metrics = adamw_update(opt, grads, state["opt"], named, **kw)
        for p in named.values():
            p.grad = None
        metrics = {**metrics, **opt_metrics}
        return {"params": params, "opt": new_opt}, metrics

    step.sync = accum.sync
    step.scatter = sp
    return step


def make_grad_fn(model: Model, run: RunConfig,
                 plan: Optional[ParallelPlan] = None) -> Callable:
    """(params, batch) -> (loss, grads, metrics) under ``plan``'s gradient
    sync: the train step minus the optimizer update.  Under a
    data-parallel plan the loss is the global one (the shards'
    contributions summed) and the gradients are the summed ones, as the
    JAX ``make_grad_fn`` returns them.  As there, with ``microbatch > 1``
    AND a ragged mask the bucketed path (per-shard microbatches) and the
    fused one (global microbatches) weigh tokens differently.  Under
    ``scatter_overlap`` ``params`` are this rank's shards and the
    gradients come back whole: the summed shards gathered (one
    ``grad_all_gather`` a bucket), for comparison leaf for leaf."""
    accum = _accum(model, run, plan)
    sharded = plan is not None and plan.grad_sync != GRAD_SYNC_NONE
    sp = getattr(accum, "scatter", None)

    def grad_fn(params, batch):
        loss, grads, metrics = accum(params, batch)
        if sharded:
            loss = loss.clone()
            dist.all_reduce(loss)
        if sp is not None:
            names = [k for k, _ in gradsync.flat_leaves(params)]
            full = gradsync.gather_grad_shards([grads[k] for k in names], sp)
            grads = dict(zip(names, full))
        return loss, grads, metrics

    grad_fn.sync = accum.sync
    return grad_fn


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
