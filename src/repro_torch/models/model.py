"""Public model API: ``build_model(cfg)`` returns a :class:`Model`.

A ``Model`` is the parameter tree itself, as a module whose
``state_dict`` keys are the JAX leaf paths (``groups.0.0.mixer.wq``), so
``model.load_state_dict(from_jax_params(jax_tree, model.specs()))``
loads a JAX-initialised model leaf for leaf."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.params import ParamTree, from_jax_params, init_params


class Model(ParamTree):
    """Parameters of ``cfg``, drawn from ``torch.Generator(seed)`` on
    ``device`` (``None`` = the card)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        super().__init__(init_params(transformer.model_specs(cfg), gen,
                                     dtype, device))
        self.cfg = cfg

    # ---- params ----
    def specs(self):
        return transformer.model_specs(self.cfg)

    def load_jax_params(self, np_tree) -> None:
        """Copy a JAX parameter tree (numpy leaves) into this model."""
        self.load_state_dict(from_jax_params(np_tree, self.specs()))

    # ---- compute ----
    def apply(self, batch: Dict[str, Any], *, mode: str = "train",
              cache=None, **kw):
        return transformer.forward(self, self.cfg, batch, mode=mode,
                                   cache=cache, **kw)

    def prefill(self, batch, **kw):
        logits, cache, _ = self.apply(batch, mode="prefill", **kw)
        return logits[:, -1:], cache

    def decode_step(self, cache, token, pos, **kw):
        logits, cache, _ = self.apply({"tokens": token, "pos": pos},
                                      mode="decode", cache=cache, **kw)
        return logits, cache


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
