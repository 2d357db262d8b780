"""Mamba2 (SSD, state-space duality) blocks [arXiv:2405.21060].

Prefill runs the chunked dual form (quadratic within a chunk, linear
recurrence across chunks) through ``kernels/ops.ssd``, the hand-written
``ssd_scan`` kernel on the card; decode runs the O(1) recurrent step,
``kernels/ref.ssd_step``, as plain code (it has no kernel in the JAX
package either).  Layouts and arithmetic are the JAX package's
``models/ssm.py``: the gated norm normalises over P per head, not over
all of d_inner as upstream Mamba2 does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ssd_step
from repro_torch.models.layers import rms_normalize
from repro_torch.models.params import ParamSpec


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.n_groups, s.d_state


def ssm_specs(cfg: ModelConfig):
    d = cfg.d_model
    _, H, Pd, G, N = ssm_dims(cfg)
    K = cfg.ssm.d_conv
    return {
        "w_x": ParamSpec((d, H, Pd), ("embed", "ssm_heads", "ssm_hd")),
        "w_z": ParamSpec((d, H, Pd), ("embed", "ssm_heads", "ssm_hd")),
        "w_B": ParamSpec((d, G, N), ("embed", None, None)),
        "w_C": ParamSpec((d, G, N), ("embed", None, None)),
        "w_dt": ParamSpec((d, H), ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="ssm_dt"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ssm_a"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "conv_x": ParamSpec((K, H, Pd), (None, "ssm_heads", "ssm_hd"), scale=0.2),
        "conv_B": ParamSpec((K, G, N), (None, None, None), scale=0.2),
        "conv_C": ParamSpec((K, G, N), (None, None, None), scale=0.2),
        "gate_norm": ParamSpec((H, Pd), ("ssm_heads", "ssm_hd"), init="ones"),
        "w_o": ParamSpec((H, Pd, d), ("ssm_heads", "ssm_hd", "embed")),
    }


def _causal_conv(u, w):
    """u:(B,S,*chan), w:(K,*chan): causal depthwise conv as K shifted adds."""
    K, S = w.shape[0], u.shape[1]
    up = torch.cat([u.new_zeros((u.shape[0], K - 1, *u.shape[2:])), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + up[:, i:i + S] * w[i]
    return out


def _conv_step(state, u_new, w):
    """state:(B,K-1,*chan) past inputs, u_new:(B,*chan) -> (conv output,
    the new K-1 past inputs)."""
    full = torch.cat([state.to(u_new.dtype), u_new[:, None]], dim=1)   # (B,K,...)
    return (full * w.to(u_new.dtype)).sum(1), full[:, 1:]


def _project(p, h):
    def w(name):
        return p[name].to(h.dtype)

    x = torch.einsum("bsd,dhp->bshp", h, w("w_x"))
    z = torch.einsum("bsd,dhp->bshp", h, w("w_z"))
    B = torch.einsum("bsd,dgn->bsgn", h, w("w_B"))
    C = torch.einsum("bsd,dgn->bsgn", h, w("w_C"))
    dt = h @ w("w_dt") + w("dt_bias")
    return x, z, B, C, dt


def _gate_out(p, y, x, z, h_dtype):
    """D skip, the gated per-head RMS norm and the output projection."""
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = rms_normalize(y * F.silu(z.float()).to(y.dtype))
    y = y * p["gate_norm"].to(y.dtype)
    return torch.einsum("...hp,hpd->...d", y, p["w_o"].to(h_dtype))


def _tail(u, n):
    """The last ``n`` steps of u:(B,S,*chan), zeros in front when S < n
    (the causal conv's own padding)."""
    if u.shape[1] >= n:
        return u[:, u.shape[1] - n:]
    return torch.cat([u.new_zeros((u.shape[0], n - u.shape[1], *u.shape[2:])), u], 1)


def apply_mamba(p, h, cfg: ModelConfig, *, mode: str, cache=None):
    """Returns (out, cache).  cache = {conv_x, conv_B, conv_C, state}.

    Prefill returns a new cache: the conv tails are the PRE-conv
    projections of the last K-1 positions, the state the scan's final
    state in f32.  Decode writes the new tails and state into the given
    cache's tensors IN PLACE (rows of the engine's pools) and returns it."""
    s = cfg.ssm
    A = -torch.exp(p["A_log"].float())

    if mode in ("train", "prefill"):
        x, z, B, C, dt = _project(p, h)
        tails = {"conv_x": x, "conv_B": B, "conv_C": C}
        x = F.silu(_causal_conv(x, p["conv_x"].to(h.dtype)))
        B = F.silu(_causal_conv(B, p["conv_B"].to(h.dtype)))
        C = F.silu(_causal_conv(C, p["conv_C"].to(h.dtype)))
        dt = F.softplus(dt.float())
        y, state = kops.ssd(x, dt, A, B, C, s.chunk)
        out = _gate_out(p, y, x, z, h.dtype)
        if mode == "train":
            return out, None
        new_cache = {k: _tail(v, s.d_conv - 1) for k, v in tails.items()}
        new_cache["state"] = state.float()
        return out, new_cache

    x, z, B, C, dt = (t[:, 0] for t in _project(p, h))     # h: (B,1,d)
    xc, cx = _conv_step(cache["conv_x"], x, p["conv_x"])
    Bc, cB = _conv_step(cache["conv_B"], B, p["conv_B"])
    Cc, cC = _conv_step(cache["conv_C"], C, p["conv_C"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    y, state = ssd_step(cache["state"], xc, F.softplus(dt.float()), A, Bc, Cc)
    out = _gate_out(p, y, xc, z, h.dtype)[:, None]
    for k, v in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC), ("state", state)):
        cache[k].copy_(v)
    return out, cache
