"""Top-level model assembly: the decoder-only LM (zamba2's hybrid with its
weight-shared attention banks among them) and the encoder-only model with
its MLM head (BERT).

Encoder-decoder and VLM models raise ``NotImplementedError`` until their
slices are ported."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, MAMBA, MLA, SHARED_ATTN, ModelConfig
from repro_torch.models.blocks import apply_group, group_specs, shared_block_specs
from repro_torch.models.layers import (add_positions, apply_norm, embed_specs,
                                       embed_tokens, norm_specs, unembed)
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import ssm_dims


def _check_supported(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.n_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the port has decoder-only LMs and encoders only")


def _n_shared_banks(cfg: ModelConfig) -> int:
    banks = [s.shared_bank for g in cfg.schedule for s in g.pattern
             if s.kind == SHARED_ATTN]
    return (max(banks) + 1) if banks else 0


def model_specs(cfg: ModelConfig):
    _check_supported(cfg)
    specs = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg),
        "groups": [group_specs(cfg, g) for g in cfg.schedule],
    }
    nb = _n_shared_banks(cfg)
    if nb:
        specs["shared"] = [shared_block_specs(cfg) for _ in range(nb)]
    if cfg.family == "encoder":
        d = cfg.d_model
        specs["mlm"] = {
            "dense": ParamSpec((d, d), ("embed", "embed2")),
            "bias": ParamSpec((d,), ("embed",), init="zeros"),
            "ln": norm_specs(cfg),
            "out_bias": ParamSpec((cfg.vocab_size,), ("vocab",), init="zeros"),
        }
    return specs


def head_apply(params, h, cfg: ModelConfig):
    """Unembedding head on a (B, S_chunk, d) slice (the chunked loss's);
    for the encoder the MLM head: dense, tanh-GELU, LayerNorm, then the
    tied unembedding plus its bias, in f32."""
    if cfg.family == "encoder":
        m = params["mlm"]
        x = F.gelu(h @ m["dense"].to(h.dtype) + m["bias"].to(h.dtype),
                   approximate="tanh")
        x = apply_norm(m["ln"], x, cfg)
        logits = x @ params["embed"]["tokens"].to(h.dtype).T
        return logits.float() + m["out_bias"].float()
    return unembed(params["embed"], h, cfg)


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *, mode: str,
            cache=None, act_dtype=torch.float32, return_hidden: bool = False,
            paged=None, remat: bool = False, moe_ctx=None):
    """Returns (logits | hidden, new_cache, aux).

    batch keys: tokens (B,S) [decode: (B,1)] and, in decode, pos: the
    per-slot (B,) positions of the paged engine.  ``paged`` is the
    paged-KV context threaded down to the attention layers (see
    ``serve/paged_cache.py``): in decode the cache leaves are page pools
    addressed through ``paged["tables"]`` and updated in place.  ``aux``
    is the MoE layers' load-balance loss summed (f32; 0 without MoE);
    ``moe_ctx``: the MoE layers' ``apply_moe`` keywords (the per-shard
    loss passes ``stat_reduce``; ``blocks.apply_group`` also takes a
    function of the MoE layer index).  ``remat`` (train mode) recomputes each
    layer in the backward, as the JAX package's ``jax.checkpoint`` per
    layer does.
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = batch.get("pos")
    causal = cfg.family != "encoder"

    h = embed_tokens(params["embed"], tokens, cfg, act_dtype)
    if mode == "decode":
        positions = pos.reshape(B, 1)            # per-slot positions
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
    h = add_positions(params["embed"], h, positions, cfg)

    shared = params["shared"] if _n_shared_banks(cfg) else None
    aux = 0.0
    new_cache_groups = []
    moe_base = 0
    for gi, group in enumerate(cfg.schedule):
        cache_g = cache["groups"][gi] if cache is not None else None
        h, ncg, a = apply_group(params["groups"][gi], shared, h, cfg, group,
                                positions=positions, mode=mode, cache_g=cache_g,
                                pos=pos, causal=causal, paged=paged,
                                remat=remat, moe_ctx=moe_ctx, moe_base=moe_base)
        moe_base += group.repeats * sum(int(s.moe) for s in group.pattern)
        aux = aux + a
        new_cache_groups.append(ncg)

    h = apply_norm(params["final_norm"], h, cfg)
    if not torch.is_tensor(aux):                # no MoE layer
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache = {"groups": new_cache_groups} \
        if mode in ("prefill", "decode") else None
    if return_hidden:
        return h, new_cache, aux
    if mode == "prefill":
        h = h[:, -1:]  # only the last position's logits are needed
    return head_apply(params, h, cfg), new_cache, aux


def cache_shapes(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16):
    """``(shape, dtype)`` cache tree matching what prefill returns, with
    the stacked ``layers`` axis.  An SSM layer's leaves are its conv
    tails in ``dtype`` and its state, always f32; a sliding-window
    layer's its ring of W = min(window, S) positions and the ring's clock
    ``pos`` (int32, no batch axis); an MLA layer's its latent ``ckv`` (B,
    S, kv_lora_rank) and rope key ``kr`` (B, S, qk_rope_head_dim).  A SHARED_ATTN position caches as a
    global attention layer: each invocation of a bank its own k and v."""
    _check_supported(cfg)
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    groups = []
    for g in cfg.schedule:
        layers = []
        for spec in g.pattern:
            r = g.repeats
            if spec.kind == MAMBA:
                _, H, Pd, G, N = ssm_dims(cfg)
                K = cfg.ssm.d_conv
                layers.append({"mixer": {
                    "conv_x": ((r, B, K - 1, H, Pd), dtype),
                    "conv_B": ((r, B, K - 1, G, N), dtype),
                    "conv_C": ((r, B, K - 1, G, N), dtype),
                    "state": ((r, B, H, N, Pd), torch.float32)}})
                continue
            if spec.kind == MLA:
                m = cfg.mla
                layers.append({"mixer": {
                    "ckv": ((r, B, S, m.kv_lora_rank), dtype),
                    "kr": ((r, B, S, m.qk_rope_head_dim), dtype)}})
                continue
            if spec.kind not in (ATTN, SHARED_ATTN):
                raise NotImplementedError(f"no cache layout for {spec}")
            if spec.window is not None:
                W = min(spec.window, S)
                shp = ((r, B, W, Hkv, D), dtype)
                layers.append({"mixer": {"k": shp, "v": shp,
                                         "pos": ((r, W), torch.int32)}})
                continue
            shp = ((r, B, S, Hkv, D), dtype)
            layers.append({"mixer": {"k": shp, "v": shp}})
        groups.append(layers)
    return {"groups": groups}
