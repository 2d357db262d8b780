"""Shared primitive layers: norms, RoPE, MLPs, embeddings, softcap.

Functions on tensors, in the JAX package's layouts; norms and RoPE
compute in f32 and cast back, as there.  Weights are cast to the
activations' dtype where they are used, so f32 parameters train with
bf16 activations (mixed precision; the gradients reach the f32 leaves).
The JAX package instead promotes a bf16 activation times an f32 weight
to f32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig, dim: int | None = None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros"),
        }
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def apply_norm(p, x, cfg: ModelConfig):
    dtype = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return y.to(dtype)


def rms_normalize(x, eps=1e-6):
    """Weightless RMS norm over the last axis, in f32 (the core of the
    Mamba2 gated norm)."""
    dtype = x.dtype
    x = x.float()
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)).to(dtype)


# ---------------------------------------------------------------------------
# Logit softcap (gemma2)
# ---------------------------------------------------------------------------


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int.  Split-half rotation."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs   # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]           # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None, ff_axis: str = "ff"):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out = {"wo": ParamSpec((f, d), (ff_axis, "embed"))}
    if cfg.gated_mlp:
        out["wi"] = ParamSpec((d, f), ("embed", ff_axis))
        out["wg"] = ParamSpec((d, f), ("embed", ff_axis))
    else:
        out["wi"] = ParamSpec((d, f), ("embed", ff_axis))
        out["bi"] = ParamSpec((f,), (ff_axis,), init="zeros")
        out["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return out


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def apply_mlp(p, x, cfg: ModelConfig):
    def w(name):
        return p[name].to(x.dtype)

    if cfg.gated_mlp:
        h = _act(x @ w("wg"), cfg.mlp_act) * (x @ w("wi"))
        return h @ w("wo")
    h = _act(x @ w("wi") + w("bi"), cfg.mlp_act)
    return h @ w("wo") + w("bo")


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig):
    out = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if cfg.pos_type == "learned":
        out["positions"] = ParamSpec(
            (cfg.max_position, cfg.d_model), (None, "embed"), scale=0.02
        )
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return out


def embed_tokens(p, tokens, cfg: ModelConfig, dtype):
    h = p["tokens"][tokens].to(dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=dtype)
    return h


def add_positions(p, h, positions, cfg: ModelConfig):
    if cfg.pos_type == "learned":
        h = h + p["positions"][positions].to(h.dtype)
    return h


def unembed(p, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = h @ p["tokens"].to(h.dtype).T
    else:
        logits = h @ p["lm_head"].to(h.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)
