"""Residual blocks and the schedule-group loop.

A ``ScheduleGroup`` is (pattern x repeats); parameters and KV caches of a
group are stacked along a leading ``layers`` axis of size ``repeats``,
as in the JAX package.  Where that package scans the group with
``lax.scan``, the port loops over the rows of the stacked axis in Python
(eager PyTorch has nothing to gain from a scan).  The port has the ATTN
block with a dense MLP (and gemma's post-norms) or a mixture of experts
(``models/moe.py``, whose load-balance aux each block returns), the MAMBA
(Mamba2) block without one, and zamba2's SHARED_ATTN block, whose
attention and MLP take their parameters from one of the model's
``shared`` banks (its stacked position owns none), so that every
invocation of a bank reads, and adds its gradient into, the same leaves;
and DeepSeek's MLA block (``attention.apply_mla``) with a dense MLP or a
mixture of experts.  Cross attention raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MAMBA, MLA, SHARED_ATTN, LayerSpec,
                                      ModelConfig, ScheduleGroup)
from repro_torch.models.attention import apply_attn, apply_mla, attn_specs, mla_specs
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_specs, norm_specs
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import ParamTree, stack_specs
from repro_torch.models.ssm import apply_mamba, ssm_specs


def block_specs(cfg: ModelConfig, spec: LayerSpec):
    if spec.kind == SHARED_ATTN:
        return {}  # params come from the shared bank
    if (spec.kind, spec.has_mlp) not in ((ATTN, True), (MLA, True), (MAMBA, False)):
        raise NotImplementedError(
            f"the port has ATTN and MLA blocks with a dense MLP or MoE, MAMBA "
            f"blocks without one and SHARED_ATTN blocks, not {spec}")
    mixer = {ATTN: attn_specs, MLA: mla_specs, MAMBA: ssm_specs}[spec.kind]
    out = {"ln1": norm_specs(cfg), "mixer": mixer(cfg)}
    if cfg.post_norms and spec.kind != MAMBA:
        out["post1"] = norm_specs(cfg)
    if spec.has_mlp:
        out["ln2"] = norm_specs(cfg)
        if spec.moe:
            out["moe"] = moe_specs(cfg)
        else:
            out["mlp"] = mlp_specs(cfg)
        if cfg.post_norms:
            out["post2"] = norm_specs(cfg)
    return out


def shared_block_specs(cfg: ModelConfig):
    """zamba2's shared transformer block (attention + MLP): no post-norms."""
    return {
        "ln1": norm_specs(cfg),
        "mixer": attn_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def group_specs(cfg: ModelConfig, group: ScheduleGroup):
    per_layer = [block_specs(cfg, s) for s in group.pattern]
    return stack_specs(per_layer, group.repeats)


def layer_row(tree, r):
    """Row ``r`` of every leaf of a stacked tree (parameters or cache), as
    nested dicts of views: writes into a cache row land in the stack.
    ``r`` None: the leaves themselves (a shared bank, which has no stack
    axis, as the inputs of a checkpointed block)."""
    if isinstance(tree, ParamTree):
        return {name: layer_row(child, r)
                for name, child in list(tree.named_parameters(recurse=False))
                + list(tree.named_children())}
    if isinstance(tree, dict):
        return {k: layer_row(v, r) for k, v in tree.items()}
    return tree if r is None else tree[r]


def apply_block(bp, shared, h, cfg: ModelConfig, spec: LayerSpec, *,
                positions, mode: str, cache=None, pos=None,
                causal: bool = True, paged=None, moe_ctx=None):
    """Returns (h, new_cache, aux): aux the MoE block's load-balance loss
    (an f32 tensor; the number 0.0 for every other block, which launches
    nothing).  A SHARED_ATTN block reads its parameters from
    ``shared[spec.shared_bank]`` (``bp`` is its empty stacked position),
    has no post-norms and always its MLP.  ``moe_ctx``: ``apply_moe``'s
    keywords (``stat_reduce``)."""
    aux = 0.0
    new_cache = {}
    cache = cache or {}
    p = shared[spec.shared_bank] if spec.kind == SHARED_ATTN else bp
    x = apply_norm(p["ln1"], h, cfg)
    if spec.kind == MAMBA:
        mx, mc = apply_mamba(p["mixer"], x, cfg, mode=mode,
                             cache=cache.get("mixer"))
    elif spec.kind == MLA:
        mx, mc = apply_mla(p["mixer"], x, cfg, spec, positions=positions, mode=mode,
                           cache=cache.get("mixer"), pos=pos, paged=paged)
    else:  # ATTN / SHARED_ATTN
        mx, mc = apply_attn(p["mixer"], x, cfg, spec, positions=positions,
                            mode=mode, cache=cache.get("mixer"), pos=pos,
                            causal=causal, paged=paged)
    if mc is not None:
        new_cache["mixer"] = mc
    if cfg.post_norms and spec.kind not in (MAMBA, SHARED_ATTN):
        mx = apply_norm(bp["post1"], mx, cfg)
    h = h + mx
    if spec.has_mlp or spec.kind == SHARED_ATTN:
        x = apply_norm(p["ln2"], h, cfg)
        if spec.moe:
            mx, aux = apply_moe(p["moe"], x, cfg, **(moe_ctx or {}))
        else:
            mx = apply_mlp(p["mlp"], x, cfg)
        if cfg.post_norms and spec.kind != SHARED_ATTN:
            mx = apply_norm(bp["post2"], mx, cfg)
        h = h + mx
    return h, new_cache, aux


def _train_block(h, bp, shared, cfg: ModelConfig, spec: LayerSpec, positions,
                 causal: bool, moe_ctx):
    h, _, aux = apply_block(bp, shared, h, cfg, spec, positions=positions,
                            mode="train", causal=causal, moe_ctx=moe_ctx)
    return h, aux


def apply_group(pg, shared, h, cfg: ModelConfig, group: ScheduleGroup, *,
                positions, mode: str, cache_g=None, pos=None,
                causal: bool = True, paged=None, remat: bool = False,
                moe_ctx=None, moe_base: int = 0):
    """Run the group's rows in order.  Returns (h, new_cache_g, aux): in
    prefill the per-layer caches stacked over the ``layers`` axis; in
    decode ``cache_g`` itself, whose pools the layers updated in place;
    aux the layers' MoE losses summed.  ``shared``: the model's shared
    banks (None without any).

    ``remat`` in train mode checkpoints each LAYER (not the whole
    pattern), as the JAX package's ``jax.checkpoint`` of ``one_block``
    does: the backward recomputes one layer at a time, so a layer's
    activations live only while its own backward runs.  A shared block's
    bank goes into the checkpoint as an input, so that each invocation's
    gradient adds into the bank's one leaf.  The checkpoint returns the
    layer's aux beside h, so that remat keeps the aux's gradient.

    ``moe_ctx`` may also be a function of the model's MoE layer index
    (counted from ``moe_base``, the MoE layers of the groups before) that
    returns that layer's keywords: the ``xla_fused`` fallback's router
    statistics are per layer, and the remat recompute must find its own."""
    new_caches = [[] for _ in group.pattern]
    aux = 0.0
    mi = moe_base
    for r in range(group.repeats):
        for pi, spec in enumerate(group.pattern):
            ctx = moe_ctx(mi) if spec.moe and callable(moe_ctx) else moe_ctx
            mi += int(spec.moe)
            if remat and mode == "train":
                bank = {spec.shared_bank: layer_row(shared[spec.shared_bank], None)} \
                    if spec.kind == SHARED_ATTN else None
                h, a = checkpoint(_train_block, h, layer_row(pg[pi], r), bank, cfg,
                                  spec, positions, causal, ctx, use_reentrant=False)
                aux = aux + a
                continue
            cl = layer_row(cache_g[pi], r) if cache_g is not None else None
            h, nc, a = apply_block(layer_row(pg[pi], r), shared, h, cfg, spec,
                                   positions=positions, mode=mode, cache=cl,
                                   pos=pos, causal=causal, paged=paged, moe_ctx=ctx)
            aux = aux + a
            new_caches[pi].append(nc)
    if mode == "decode":
        return h, cache_g, aux
    if mode != "prefill":
        return h, None, aux
    stacked = []
    for per_row in new_caches:
        stacked.append({part: {k: torch.stack([c[part][k] for c in per_row])
                               for k in per_row[0][part]}
                        for part in per_row[0]})
    return h, stacked, aux
