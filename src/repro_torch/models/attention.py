"""Attention: MHA/GQA with qkv bias.

Modes:
  train   — full sequence, causal (or bidirectional for the encoder family)
  prefill — like train, additionally returns the layer's K/V cache
  decode  — one query token per slot against the paged KV pools

Self-attention over a whole sequence always goes through
``kernels/ops.flash_attention`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors), causal or not and at any S; in train
mode its backward is the flash backward kernel.  The JAX package routes
only causal attention to its Pallas kernel in ``gqa_attend`` and the
non-causal encoder through ``sharding.flash_attn_ctx`` under ddp.  Paged
decode goes through ``kernels/ops.paged_attention``.  Sliding windows,
qk-norm, MLA, the contiguous (non-paged) decode cache and
sequence-sharded decode are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.params import ParamSpec

NEG_INF = -2.0e38


def attn_specs(cfg: ModelConfig):
    H, Hkv, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out = {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamSpec((H, D), ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamSpec((Hkv, D), ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = ParamSpec((Hkv, D), ("kv_heads", "head_dim"), init="zeros")
    return out


def _scale(cfg: ModelConfig, qk_dim: int) -> float:
    return cfg.query_scale if cfg.query_scale else qk_dim**-0.5


def _attend_block(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,D) k,v: (B,Sk,Hkv,D) mask: (B or 1,1,Sq,Sk) additive."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qr = q.reshape(B, Sq, Hkv, rep, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k).float()
    s = s * _scale(cfg, D)
    s = softcap(s, cfg.attn_logit_softcap)
    s = s + mask[:, :, None] if mask.dim() == 4 else s + mask
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return o.reshape(B, Sq, H, v.shape[-1])


def gqa_attend(q, k, v, mask, cfg: ModelConfig, *, causal: bool = True,
               window=None):
    """q: (B,Sq,H,D) k,v: (B,Sk,Hkv,D) -> (B,Sq,H,D).

    With ``mask`` None this is self-attention over one sequence, which
    the flash kernel computes at any length (the JAX package's
    ``Sq >= 128`` guard is a TPU tiling limit); an explicit additive
    ``mask`` takes the dense block."""
    if mask is not None:
        return _attend_block(q, k, v, mask, cfg)
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError("maskless attention needs Sq == Sk")
    return kops.flash_attention(
        q, k, v, causal=causal, window=window,
        softcap=cfg.attn_logit_softcap, scale=_scale(cfg, q.shape[-1]))


def _project_qkv(p, h, cfg: ModelConfig):
    def proj(w):  # "bsd,dhe->bshe"
        return (h @ w.to(h.dtype).flatten(1)).unflatten(-1, w.shape[1:])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    return q, k, v


def _out_proj(o, p, h):  # "bshe,hed->bsd"
    return o.flatten(2) @ p["wo"].to(h.dtype).flatten(0, 1)


def apply_attn(p, h, cfg: ModelConfig, spec: LayerSpec, *, positions,
               mode: str, cache=None, pos=None, causal: bool = True,
               paged=None):
    """Returns (out, new_cache).

    ``paged`` carries the serving engine's paged-KV context
    (serve/paged_cache.py).  In decode it is ``{"tables": (B,maxp)
    int32, "page": P}`` with ``pos`` a per-slot (B,) tensor and the
    layer's cache leaves page POOLS (NP,P,Hkv,D), which this call updates
    in place.  In prefill it is ``{"length": L}``, the true prompt length
    of a right-padded bucket (only sliding-window rings read it)."""
    if spec.kind != ATTN or spec.window is not None or cfg.qk_norm:
        raise NotImplementedError(
            "the port has full-attention GQA layers only (no sliding "
            "window, qk-norm or MLA yet)")
    B = h.shape[0]
    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(p, h, cfg)
        if cfg.pos_type == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        o = gqa_attend(q, k, v, None, cfg, causal=causal, window=spec.window)
        new_cache = _fill_cache(k, v) if mode == "prefill" else None
        return _out_proj(o, p, h), new_cache

    # ------------------------------------------------------------- decode
    if paged is None or "tables" not in paged:
        raise NotImplementedError("the port decodes through paged KV only")
    q, k_new, v_new = _project_qkv(p, h, cfg)  # (B,1,H,D) / (B,1,Hkv,D)
    if cfg.pos_type == "rope":
        pos_arr = pos.reshape(B, 1)            # per-slot positions
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
    o, new_cache = _paged_attend(q, k_new, v_new, cache, pos, cfg, paged)
    return _out_proj(o, p, h), new_cache


def _paged_attend(q, k_new, v_new, cache, pos, cfg: ModelConfig, paged):
    """Write the new token's K/V into the page pool through the block
    table, then attend the (B,1,H,D) query over all live pages.

    ``cache`` = {"k": (NP,P,Hkv,D), "v": ...} — this layer's pools,
    written IN PLACE (the JAX version returns updated copies).  ``pos``
    (B,) per-slot positions.  Distinct active slots hold distinct pages
    (the allocator's invariant), so the writes never collide; inactive
    slots all write the reserved trash page 0, where the duplicate
    indices are harmless.
    """
    P = paged["page"]
    tables = paged["tables"]
    B = q.shape[0]
    b_idx = torch.arange(B, device=q.device)
    pos_l = pos.long()
    page = tables[b_idx, pos_l // P].long()        # (B,) physical pages
    off = pos_l % P
    kp, vp = cache["k"], cache["v"]
    kp[page, off] = k_new[:, 0].to(kp.dtype)
    vp[page, off] = v_new[:, 0].to(vp.dtype)
    o = kops.paged_attention(
        q[:, 0], kp, vp, tables, pos, window=None,
        softcap=cfg.attn_logit_softcap, scale=_scale(cfg, q.shape[-1]))
    return o[:, None], cache


def _fill_cache(k, v):
    return {"k": k, "v": v}
