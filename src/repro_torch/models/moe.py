"""Mixture-of-experts: the top-k router, shared experts and the dispatch.

The port's copy of the JAX package's ``models/moe.py``.  ``route`` is
JAX's router (f32 logits, softmax, top-k of the probabilities, the gate
renormalised, the Switch load-balance aux from the batch means ``me``
and ``ce`` over every token passed in).  ``apply_moe`` computes the JAX
dense dispatch (``apply_moe_dense``: every expert on every token,
combined by a gate that is exactly zero off the token's top k), but
sparsely: each expert runs only on the tokens routed to it, and each
token's k outputs are combined with its gate weights.  The expert-
parallel capacity dispatch (``ep``, ``ep_shard``) comes with ROADMAP A11.

The dispatch repeats bit for bit: the (token, slot) pairs are grouped by
expert through a stable sort and put back through its inverse
permutation, both as row gathers whose backward is the gather by the
other permutation, so that no forward or backward adds into a repeated
index (CUDA's ``index_add_`` and the backward of indexing with repeated
indices add atomically, in no fixed order).  The expert products are
``torch.matmul``, as JAX's are plain einsums outside any Pallas kernel.

Data parallel: ``route``'s ``stat_reduce`` (``distributed.gradsync.
router_stat_mean``) turns ``me`` and ``ce`` into their means over the
process group before the aux, as JAX's ``route(stat_axes=...)`` pmeans
them: the aux is nonlinear in those means, so every rank must see the
global ones for the per-shard losses' gradients to sum to the global
gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ModelConfig):
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_ff, m.n_experts
    out = {
        "router": ParamSpec((d, E), ("embed", None), scale=0.02),
        "wi": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "wo": ParamSpec((E, f, d), ("experts", "ff", "embed")),
    }
    if m.n_shared:
        fs = m.expert_ff * m.n_shared
        out["shared_wi"] = ParamSpec((d, fs), ("embed", "ff"))
        out["shared_wg"] = ParamSpec((d, fs), ("embed", "ff"))
        out["shared_wo"] = ParamSpec((fs, d), ("ff", "embed"))
    return out


def route(p, x, cfg: ModelConfig, stat_reduce=None):
    """x: (T, d) -> (weights (T, k) in x's dtype, idx (T, k), aux f32).

    ``stat_reduce(me, ce) -> (me, ce)``: the router's batch statistics
    reduced over the data-parallel ranks (JAX's ``stat_axes``), or None."""
    m = cfg.moe
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    w, idx = torch.topk(probs, m.top_k, dim=-1)                    # (T, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(0)                                             # (E,)
    ce = torch.bincount(idx.reshape(-1), minlength=m.n_experts).float() / x.shape[0]
    if stat_reduce is not None:
        me, ce = stat_reduce(me, ce)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_coef
    return w.to(x.dtype), idx, aux


class _Rows(torch.autograd.Function):
    """``x[perm]`` for a permutation ``perm`` of x's rows, whose backward is
    the gather by the inverse permutation ``inv`` (no accumulation)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g[inv], None, None


def _expert_ffn(wi, wg, wo, x):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def _shared_ffn(p, x):
    def w(name):
        return p[name].to(x.dtype)

    return _expert_ffn(w("shared_wi"), w("shared_wg"), w("shared_wo"), x)


def apply_moe(p, x, cfg: ModelConfig, *, impl: str = "dense", stat_reduce=None):
    """x: (B, S, d) -> (out (B, S, d), aux).  The JAX dense dispatch's
    function, computed on each expert's own tokens (module docstring).
    One host sync a call reads the experts' token counts."""
    if impl != "dense":
        raise NotImplementedError(
            f"MoE dispatch {impl!r} (expert parallel) is not ported yet (ROADMAP A11); "
            f"the port runs the dense dispatch")
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    T, k = xt.shape[0], m.top_k
    w, idx, aux = route(p, xt, cfg, stat_reduce=stat_reduce)
    flat_e = idx.reshape(-1)                                       # (T k,)
    # the (token, slot) pairs grouped by expert, in token order within one
    perm = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    counts = torch.bincount(flat_e, minlength=m.n_experts).tolist()
    # each token once a slot (expand's backward sums the k slots in order)
    xs = _Rows.apply(xt.unsqueeze(1).expand(T, k, d).reshape(T * k, d), perm, inv)
    wi, wg, wo = (p[n].to(x.dtype).unbind(0) for n in ("wi", "wg", "wo"))
    ys, lo = [], 0
    for e, n in enumerate(counts):
        if n:
            ys.append(_expert_ffn(wi[e], wg[e], wo[e], xs[lo:lo + n]))
            lo += n
    yk = _Rows.apply(torch.cat(ys), inv, perm).reshape(T, k, d)
    out = (yk * w.unsqueeze(-1)).sum(1)
    if m.n_shared:
        out = out + _shared_ffn(p, xt)
    return out.reshape(B, S, d), aux
