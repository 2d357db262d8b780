"""Residual blocks and the schedule-group loop.

A ``ScheduleGroup`` is (pattern x repeats); parameters and KV caches of a
group are stacked along a leading ``layers`` axis of size ``repeats``,
as in the JAX package.  Where that package scans the group with
``lax.scan``, the port loops over the rows of the stacked axis in Python
(eager PyTorch has nothing to gain from a scan).  The port has the ATTN
block with a dense MLP; MoE, Mamba, MLA, shared banks and cross
attention raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, ScheduleGroup
from repro_torch.models.attention import apply_attn, attn_specs
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_specs, norm_specs
from repro_torch.models.params import ParamTree, stack_specs


def block_specs(cfg: ModelConfig, spec: LayerSpec):
    if spec.kind != ATTN or spec.moe or not spec.has_mlp or cfg.post_norms:
        raise NotImplementedError(
            f"the port has ATTN blocks with a dense MLP only, not {spec} "
            f"(post_norms={cfg.post_norms})")
    return {
        "ln1": norm_specs(cfg),
        "mixer": attn_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def group_specs(cfg: ModelConfig, group: ScheduleGroup):
    per_layer = [block_specs(cfg, s) for s in group.pattern]
    return stack_specs(per_layer, group.repeats)


def layer_row(tree, r: int):
    """Row ``r`` of every leaf of a stacked tree (parameters or cache), as
    nested dicts of views: writes into a cache row land in the stack."""
    if isinstance(tree, ParamTree):
        return {name: layer_row(child, r)
                for name, child in list(tree.named_parameters(recurse=False))
                + list(tree.named_children())}
    if isinstance(tree, dict):
        return {k: layer_row(v, r) for k, v in tree.items()}
    return tree[r]


def apply_block(bp, h, cfg: ModelConfig, spec: LayerSpec, *, positions,
                mode: str, cache=None, pos=None, causal: bool = True,
                paged=None):
    """Returns (h, new_cache)."""
    new_cache = {}
    cache = cache or {}
    x = apply_norm(bp["ln1"], h, cfg)
    mx, mc = apply_attn(bp["mixer"], x, cfg, spec, positions=positions,
                        mode=mode, cache=cache.get("mixer"), pos=pos,
                        causal=causal, paged=paged)
    if mc is not None:
        new_cache["mixer"] = mc
    h = h + mx
    x = apply_norm(bp["ln2"], h, cfg)
    h = h + apply_mlp(bp["mlp"], x, cfg)
    return h, new_cache


def _train_block(h, bp, cfg: ModelConfig, spec: LayerSpec, positions,
                 causal: bool):
    return apply_block(bp, h, cfg, spec, positions=positions, mode="train",
                       causal=causal)[0]


def apply_group(pg, h, cfg: ModelConfig, group: ScheduleGroup, *,
                positions, mode: str, cache_g=None, pos=None,
                causal: bool = True, paged=None, remat: bool = False):
    """Run the group's rows in order.  Returns (h, new_cache_g): in
    prefill the per-layer caches stacked over the ``layers`` axis; in
    decode ``cache_g`` itself, whose pools the layers updated in place.

    ``remat`` in train mode checkpoints each LAYER (not the whole
    pattern), as the JAX package's ``jax.checkpoint`` of ``one_block``
    does: the backward recomputes one layer at a time, so a layer's
    activations live only while its own backward runs."""
    new_caches = [[] for _ in group.pattern]
    for r in range(group.repeats):
        for pi, spec in enumerate(group.pattern):
            if remat and mode == "train":
                h = checkpoint(_train_block, h, layer_row(pg[pi], r), cfg, spec,
                               positions, causal, use_reentrant=False)
                continue
            cl = layer_row(cache_g[pi], r) if cache_g is not None else None
            h, nc = apply_block(layer_row(pg[pi], r), h, cfg, spec,
                                positions=positions, mode=mode, cache=cl,
                                pos=pos, causal=causal, paged=paged)
            new_caches[pi].append(nc)
    if mode == "decode":
        return h, cache_g
    if mode != "prefill":
        return h, None
    stacked = []
    for per_row in new_caches:
        stacked.append({part: {k: torch.stack([c[part][k] for c in per_row])
                               for k in per_row[0][part]}
                        for part in per_row[0]})
    return h, stacked
