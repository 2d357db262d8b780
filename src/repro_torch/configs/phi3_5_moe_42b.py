"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) head_dim=128, expert d_ff=6400, 16 routed
experts top-2 (no shared experts), vocab=32064, LayerNorm, untied.
"""
from repro_torch.configs.base import (ATTN, LayerSpec, ModelConfig, MoEConfig,
                                uniform_schedule)

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    vocab_size=32_064,
    schedule=uniform_schedule(32, LayerSpec(kind=ATTN, moe=True)),
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, expert_ff=6400,
                  capacity_factor=1.25),
    rope_theta=10_000.0,
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    max_position=131_072,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
