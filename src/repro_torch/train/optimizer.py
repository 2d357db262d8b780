"""AdamW with a warmup + cosine schedule, as the JAX package's
``train/optimizer.py``.

Moments are f32 whatever the parameter dtype.  The state mirrors the
parameters by name: ``{"mu": {name: t}, "nu": {name: t}, "step": int32
0-d tensor}``.  Where the JAX update returns new trees, this one writes
the parameters and moments in place (no second copy of either).

Decay applies to leaves with ``ndim >= 2``, the JAX rule exactly: on the
stacked ``layers`` axis that also decays the (layers, d) LayerNorm
scales and biases and the (layers, H, D) qkv biases.  The update is
elementwise, so the fsdp step runs it on each rank's shards of
parameters, gradients and moments (a shard keeps its leaf's ndim, so the
decay rule reads the same); the one quantity across leaves, the clipping
norm, then comes in as ``grad_norm`` (``gradsync.fsdp_global_norm``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def lr_at(c: AdamWConfig, step):
    """The learning rate at ``step`` (a number or a tensor; f32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, c.warmup_steps), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) / max(1, c.total_steps - c.warmup_steps),
                       0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * cos


def init_opt_state(params: Dict[str, torch.Tensor]):
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


@torch.no_grad()
def adamw_update(c: AdamWConfig, grads: Dict[str, torch.Tensor], opt_state,
                 params: Dict[str, torch.Tensor], *, grad_norm=None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; returns (params, opt_state, metrics)
    with metrics ``grad_norm`` and ``lr`` (0-d tensors).  ``grad_norm``:
    the clipping norm when ``grads`` do not span the whole gradient (fsdp
    shards); None computes it from ``grads``."""
    step = opt_state["step"]
    gnorm = grad_norm if grad_norm is not None else _global_norm(grads)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if c.grad_clip else 1.0
    lr = lr_at(c, step).to(gnorm.device)
    t = (step + 1).float()
    bc1 = 1 - c.b1 ** t
    bc2 = 1 - c.b2 ** t
    for k, p in params.items():
        g = grads[k].float() * scale
        mu, nu = opt_state["mu"][k], opt_state["nu"][k]
        mu.mul_(c.b1).add_((1 - c.b1) * g)
        nu.mul_(c.b2).add_((1 - c.b2) * torch.square(g))
        step_vec = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
        pf = p.float()
        if p.ndim >= 2:  # decay matrices only (and the stacked 1-d leaves)
            step_vec = step_vec + c.weight_decay * pf
        p.copy_((pf - lr * step_vec).to(p.dtype))
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
