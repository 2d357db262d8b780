"""The parts of the JAX package's analytic scaling model that the
trainer's MFU needs: ``param_count`` (exact, from the spec tree) and
``model_flops`` (6·N·D).  The memory and data-parallel models, and the
hardware table, are not ported."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    from repro_torch.models.params import flatten_tree
    from repro_torch.models.transformer import model_specs

    total = 0
    for path, leaf in flatten_tree(model_specs(cfg)).items():
        n = int(np.prod(leaf.shape))
        keys = path.split(".")
        if active_only and cfg.moe is not None and "moe" in keys \
                and any(k in ("wi", "wg", "wo") for k in keys):
            n = int(n * (cfg.moe.top_k / cfg.moe.n_experts))
        total += n
    return total


def model_flops(cfg: ModelConfig, tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D with N = active params (fwd+bwd); for inference
    callers scale by 1/3 (2·N·D)."""
    return 6.0 * param_count(cfg, active_only=True) * tokens
