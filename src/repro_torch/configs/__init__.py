"""Architecture registry: ``get_config("<arch-id>")``.

Holds only the architectures the port runs so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, RunConfig,  # noqa: F401
                                      ShapeConfig, reduced)

ARCHS = {
    "bert-mlm-120m": "bert_mlm_120m",
    "starcoder2-3b": "starcoder2_3b",
}


def default_run_config(cfg: ModelConfig, shape: ShapeConfig, *,
                       sharding: str = "ddp", **kw) -> RunConfig:
    """f32 RunConfig shared by the launchers (dtypes overridable)."""
    kw.setdefault("param_dtype", "float32")
    kw.setdefault("activation_dtype", "float32")
    return RunConfig(model=cfg, shape=shape, sharding=sharding, **kw)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def list_archs():
    return sorted(ARCHS)
