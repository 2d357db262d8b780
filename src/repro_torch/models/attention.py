"""Attention: MHA/GQA with qkv bias, qk-norm and sliding windows.

Modes:
  train   — full sequence, causal (or bidirectional for the encoder family)
  prefill — like train, additionally returns the layer's K/V cache (for a
            sliding-window layer its ring of the last W positions)
  decode  — one query token per slot: a global layer against the paged KV
            pools, a sliding-window layer against its per-slot ring

Self-attention over a whole sequence always goes through
``kernels/ops.flash_attention`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors), causal or not, windowed or not, at any
S; in train mode its backward is the flash backward kernel.  The JAX
package routes only causal attention to its Pallas kernel in
``gqa_attend`` and the non-causal encoder through
``sharding.flash_attn_ctx`` under ddp.  Paged decode of a global layer
goes through ``kernels/ops.paged_attention``; a windowed layer decodes
by the plain masked attention over its ring, as the JAX package does
(no kernel there either).  MLA (DeepSeek's multi-head latent attention,
``apply_mla``) trains and prefills through the same flash kernel at q/k
head dim 192 and v head dim 128 (the JAX package runs it as q-chunked
einsums; the port's rule sends every whole-sequence self-attention to the
kernel), and decodes in the absorbed form over its latent pages in plain
PyTorch, as the JAX package does.  The contiguous (non-paged) decode
cache and sequence-sharded decode are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, SHARED_ATTN, LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_normalize, softcap
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
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((D,), ("head_dim",), init="ones")
        out["k_norm"] = ParamSpec((D,), ("head_dim",), init="ones")
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
    if cfg.qk_norm:
        q = rms_normalize(q) * p["q_norm"].to(h.dtype)
        k = rms_normalize(k) * p["k_norm"].to(h.dtype)
    return q, k, v


def _theta(cfg: ModelConfig, spec: LayerSpec) -> float:
    if spec.window is not None and cfg.rope_local_theta:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _out_proj(o, p, h):  # "bshe,hed->bsd"
    return o.flatten(2) @ p["wo"].to(h.dtype).flatten(0, 1)


def apply_attn(p, h, cfg: ModelConfig, spec: LayerSpec, *, positions,
               mode: str, cache=None, pos=None, causal: bool = True,
               paged=None):
    """Returns (out, new_cache).

    ``paged`` carries the serving engine's paged-KV context
    (serve/paged_cache.py).  In decode it is ``{"tables": (B,maxp)
    int32, "page": P}`` with ``pos`` a per-slot (B,) tensor; a global
    layer's cache leaves are page POOLS (NP,P,Hkv,D), a windowed layer's
    its per-slot rings (B,W,Hkv,D) with their clock ``pos`` (B,W), and
    this call updates either in place.  In prefill it is ``{"length":
    L}``, the true prompt length of a right-padded bucket (only
    sliding-window rings read it)."""
    if spec.kind not in (ATTN, SHARED_ATTN):  # a shared bank attends as ATTN
        raise NotImplementedError(
            f"apply_attn takes GQA attention layers, not {spec.kind} (apply_mla)")
    B = h.shape[0]
    theta = _theta(cfg, spec)
    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(p, h, cfg)
        if cfg.pos_type == "rope":
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
        o = gqa_attend(q, k, v, None, cfg, causal=causal, window=spec.window)
        new_cache = None
        if mode == "prefill":
            length = paged.get("length") if paged else None
            new_cache = _fill_cache(k, v, spec, length=length)
        return _out_proj(o, p, h), new_cache

    # ------------------------------------------------------------- decode
    if paged is None or "tables" not in paged:
        raise NotImplementedError("the port decodes through paged KV only")
    q, k_new, v_new = _project_qkv(p, h, cfg)  # (B,1,H,D) / (B,1,Hkv,D)
    if cfg.pos_type == "rope":
        pos_arr = pos.reshape(B, 1)            # per-slot positions
        q = apply_rope(q, pos_arr, theta)
        k_new = apply_rope(k_new, pos_arr, theta)
    if spec.window is not None:
        # per-slot dense ring: a fixed-size pool row per slot
        mask = _sliding_update_paged(cache, k_new, v_new, pos, spec.window)
        o = gqa_attend(q, cache["k"], cache["v"], mask, cfg)
        return _out_proj(o, p, h), cache
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


def _sliding_update_paged(cache, k_new, v_new, pos, window: int):
    """Write each slot's new K/V and position into its ring, IN PLACE (the
    JAX version returns updated copies), at slot ``pos % window``; returns
    the additive (B,1,1,W) mask of the ring entries the query sees (written,
    not ahead of ``pos``, inside the window)."""
    B = k_new.shape[0]
    b_idx = torch.arange(B, device=k_new.device)
    pos_l = pos.long()
    slot = pos_l % window
    cache["k"][b_idx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][b_idx, slot] = pos.to(cache["pos"].dtype)
    pos_ids = cache["pos"]
    p = pos_l[:, None]
    valid = (pos_ids >= 0) & (pos_ids <= p) & (pos_ids > p - window)
    return torch.where(valid, 0.0, NEG_INF)[:, None, None].float()


def _fill_cache(k, v, spec: LayerSpec, length=None):
    """A global layer's cache is its K and V; a windowed layer's is the
    ring of its last W positions (slot = position % W) with their clock
    ``pos`` (-1 where empty), which has no batch axis."""
    if spec.window is None:
        return {"k": k, "v": v}
    W = spec.window
    S = k.shape[1]
    if length is not None:
        # ragged fill: the prompt really ends at ``length``, the buffer is
        # right-padded to S.  Ring slot s gets the largest position
        # p <= length-1 with p % W == s (and >= length-W); pad positions
        # never enter the ring.
        s_ids = torch.arange(W, device=k.device)
        p_ids = (length - 1) - ((length - 1 - s_ids) % W)
        ok = p_ids >= 0
        idx = p_ids.clamp(0, S - 1)
        keep = ok[None, :, None, None]
        kc = torch.where(keep, k[:, idx], k.new_zeros(()))
        vc = torch.where(keep, v[:, idx], v.new_zeros(()))
        return {"k": kc, "v": vc,
                "pos": torch.where(ok, p_ids, -1).to(torch.int32)}
    if S >= W:
        pos_ids = torch.arange(S - W, S, device=k.device)
        inv = torch.argsort(pos_ids % W)        # ring layout: slot = pos % W
        return {"k": k[:, S - W:][:, inv], "v": v[:, S - W:][:, inv],
                "pos": pos_ids[inv].to(torch.int32)}
    pad = W - S
    pos_ids = torch.cat([torch.arange(S, device=k.device),
                         torch.full((pad,), -1, device=k.device)])
    return {"k": torch.cat([k, k.new_zeros((k.shape[0], pad, *k.shape[2:]))], 1),
            "v": torch.cat([v, v.new_zeros((v.shape[0], pad, *v.shape[2:]))], 1),
            "pos": pos_ids.to(torch.int32)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek V2)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig):
    m = cfg.mla
    H, d = cfg.n_heads, cfg.d_model
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((d, H, qk), ("embed", "heads", "head_dim")),
        "wdkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_ln": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "wuk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim), (None, "heads", "head_dim")),
        "wuv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim), (None, "heads", "head_dim")),
        "wo": ParamSpec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def _heads(x, w):  # "b...r,rhe->b...he"
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _mla_q(p, h, cfg: ModelConfig, positions):
    m = cfg.mla
    q = _heads(h, p["wq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p, h, cfg: ModelConfig, positions):
    """The rms-normalised latent (B, S, r) and the one rope key head (B, S, rope)."""
    m = cfg.mla
    ckv_full = h @ p["wdkv"].to(h.dtype)
    ckv = rms_normalize(ckv_full[..., :m.kv_lora_rank]) * p["kv_ln"].to(h.dtype)
    k_rope = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None], positions,
                        cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def apply_mla(p, h, cfg: ModelConfig, spec: LayerSpec, *, positions, mode: str,
              cache=None, pos=None, paged=None):
    """DeepSeek's multi-head latent attention.  Returns (out, new_cache).

    Train and prefill expand the latent into per-head k_nope and v and run
    the flash kernel on q = [q_nope, q_rope] and k = [k_nope, k_rope]
    (the one rope head broadcast to every head) at head dim
    qk_nope + qk_rope, v at v_head_dim, with the scale (qk_nope +
    qk_rope)^-0.5; prefill returns the cache ``{"ckv": (B, S, r), "kr":
    (B, S, rope)}``.  Decode (``paged`` = ``{"tables", "page"}``, ``pos``
    the per-slot (B,) positions) writes the new latent and rope key into
    this layer's pools (NP, P, r) and (NP, P, rope) IN PLACE and scores
    the absorbed query q_nope Wuk against each slot's gathered latent
    pages plus q_rope against its rope keys, under a per-slot causal
    mask; o = softmax . ckv . Wuv, as the JAX package computes it."""
    m = cfg.mla
    B = h.shape[0]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if mode in ("train", "prefill"):
        q_nope, q_rope = _mla_q(p, h, cfg, positions)
        ckv, k_rope = _mla_ckv(p, h, cfg, positions)
        k_nope = _heads(ckv, p["wuk"])
        v = _heads(ckv, p["wuv"])
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(*k_rope.shape[:2], cfg.n_heads,
                                                          m.qk_rope_head_dim)], -1)
        o = kops.flash_attention(q, k, v, causal=True, window=spec.window, scale=scale)
        new_cache = {"ckv": ckv, "kr": k_rope} if mode == "prefill" else None
        return _out_proj(o, p, h), new_cache

    # ------------------------------------------------------------- decode
    if paged is None or "tables" not in paged:
        raise NotImplementedError("the port decodes through paged KV only")
    pos_arr = pos.reshape(B, 1)
    q_nope, q_rope = _mla_q(p, h, cfg, pos_arr)          # (B,1,H,.)
    ckv_new, kr_new = _mla_ckv(p, h, cfg, pos_arr)       # (B,1,r) (B,1,rope)
    P, tables = paged["page"], paged["tables"]
    maxp = tables.shape[1]
    pos_l = pos.long()
    page = tables[torch.arange(B, device=h.device), pos_l // P].long()
    off = pos_l % P
    ckv_p, kr_p = cache["ckv"], cache["kr"]
    ckv_p[page, off] = ckv_new[:, 0].to(ckv_p.dtype)
    kr_p[page, off] = kr_new[:, 0].to(kr_p.dtype)
    ckv = ckv_p[tables.long()].reshape(B, maxp * P, -1)
    kr = kr_p[tables.long()].reshape(B, maxp * P, -1)
    q_eff = torch.einsum("bqhe,rhe->bqhr", q_nope, p["wuk"].to(h.dtype))
    s = (torch.einsum("bqhr,bkr->bhqk", q_eff, ckv)
         + torch.einsum("bqhe,bke->bhqk", q_rope, kr)).float() * scale
    kpos = torch.arange(maxp * P, device=h.device)
    s = s + torch.where(kpos[None] <= pos_l[:, None], 0.0, NEG_INF)[:, None, None]
    w = torch.softmax(s, dim=-1).to(h.dtype)
    o_lat = torch.einsum("bhqk,bkr->bqhr", w, ckv)
    o = torch.einsum("bqhr,rhe->bqhe", o_lat, p["wuv"].to(h.dtype))
    return _out_proj(o, p, h), cache
