"""The JAX package's analytic scaling model, as far as the port uses it:

* ``param_count`` — exact parameter count from the spec tree;
* ``model_flops`` — 6·N·D, the trainer's MFU numerator;
* ``MemoryModel`` — HBM bytes of a training step, and the paper's R5
  "max per-device batch" it solves for, on the card description
  ``H100_NVL`` (the paper's H100 NVL, 94 GB) or any other ``Chip``
  (``chip_smoke.py``'s phase ``bert_max_batch`` measures R5 on the card).

The data-parallel scaling model (``DPScalingModel``, ``dp_scaling_curve``)
is not ported."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float          # bf16 FLOP/s
    hbm_bytes: float
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s per NVLink-class link
    net_bw: float              # bytes/s inter-node


H100_NVL = Chip("h100-nvl", 835e12, 94e9, 3.9e12, 300e9, 25e9 / 8)  # 25 GbE


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


@dataclass(frozen=True)
class MemoryModel:
    """HBM bytes for one training step.

    state: params(pb) + grads(pb) + adam mu,nu (2×4B), sharded over
    ``state_shards`` (1 = pure DDP, the paper's setting).
    activations: with remat-at-block-boundaries, ~``act_factor`` × d_model
    bytes per token per layer survive the forward pass.
    """

    cfg: ModelConfig
    param_bytes: int = 2           # bf16
    opt_bytes: int = 8             # two f32 moments
    act_factor: float = 14.0       # boundary + attention workspace, bf16
    state_shards: int = 1

    def state_bytes(self) -> float:
        n = param_count(self.cfg)
        return n * (2 * self.param_bytes + self.opt_bytes) / self.state_shards

    def act_bytes(self, batch: int, seq: int) -> float:
        return (self.act_factor * self.cfg.d_model * self.cfg.n_layers
                * batch * seq)

    def step_bytes(self, batch: int, seq: int) -> float:
        return self.state_bytes() + self.act_bytes(batch, seq)

    def max_batch(self, seq: int, hbm: float, reserve: float = 0.10) -> int:
        """R5: largest per-device batch that fits (0 => doesn't fit at all)."""
        budget = hbm * (1 - reserve) - self.state_bytes()
        if budget <= 0:
            return 0
        per_sample = self.act_factor * self.cfg.d_model * self.cfg.n_layers * seq
        return int(budget // per_sample)

