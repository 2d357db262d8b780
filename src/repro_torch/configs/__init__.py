"""Architecture registry: ``get_config("<arch-id>")``.

Holds only the architectures the port runs so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, RunConfig,  # noqa: F401
                                      ShapeConfig, reduced)

ARCHS = {
    "bert-mlm-120m": "bert_mlm_120m",
    "bert-mlm-350m": "bert_mlm_350m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-4b": "gemma3_4b",
    "llama3-8b": "llama3_8b",
    "mamba2-130m": "mamba2_130m",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-3b": "starcoder2_3b",
    "zamba2-2.7b": "zamba2_2_7b",
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
