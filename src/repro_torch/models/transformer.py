"""Top-level model assembly: the decoder-only LM and the encoder-only
model with its MLM head (BERT).

Encoder-decoder, VLM and shared-bank models raise
``NotImplementedError`` until their slices are ported."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.blocks import apply_group, group_specs
from repro_torch.models.layers import (add_positions, apply_norm, embed_specs,
                                       embed_tokens, norm_specs, unembed)
from repro_torch.models.params import ParamSpec


def _check_supported(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.n_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the port has decoder-only LMs and encoders only")


def model_specs(cfg: ModelConfig):
    _check_supported(cfg)
    specs = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg),
        "groups": [group_specs(cfg, g) for g in cfg.schedule],
    }
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
            paged=None, remat: bool = False):
    """Returns (logits | hidden, new_cache, aux).

    batch keys: tokens (B,S) [decode: (B,1)] and, in decode, pos: the
    per-slot (B,) positions of the paged engine.  ``paged`` is the
    paged-KV context threaded down to the attention layers (see
    ``serve/paged_cache.py``): in decode the cache leaves are page pools
    addressed through ``paged["tables"]`` and updated in place.  ``aux``
    (the MoE loss in the JAX package) is always 0 here.  ``remat`` (train
    mode) recomputes each layer in the backward, as the JAX package's
    ``jax.checkpoint`` per layer does.
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

    new_cache_groups = []
    for gi, group in enumerate(cfg.schedule):
        cache_g = cache["groups"][gi] if cache is not None else None
        h, ncg = apply_group(params["groups"][gi], h, cfg, group,
                             positions=positions, mode=mode, cache_g=cache_g,
                             pos=pos, causal=causal, paged=paged,
                             remat=remat)
        new_cache_groups.append(ncg)

    h = apply_norm(params["final_norm"], h, cfg)
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
    the stacked ``layers`` axis."""
    _check_supported(cfg)
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    groups = []
    for g in cfg.schedule:
        layers = []
        for spec in g.pattern:
            if spec.kind != ATTN or spec.window is not None:
                raise NotImplementedError(f"no cache layout for {spec}")
            shp = ((g.repeats, B, S, Hkv, D), dtype)
            layers.append({"mixer": {"k": shp, "v": shp}})
        groups.append(layers)
    return {"groups": groups}
