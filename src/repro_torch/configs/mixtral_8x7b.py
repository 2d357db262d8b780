"""mixtral-8x7b [moe] — bonus (public pool, not in the assigned ten)
[arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) head_dim=128, 8 experts top-2 with
expert d_ff=14336, vocab=32000, rmsnorm, silu-gated experts, rope 1e6.
"""
from repro_torch.configs.base import (ATTN, LayerSpec, ModelConfig, MoEConfig,
                                uniform_schedule)

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    vocab_size=32_000,
    schedule=uniform_schedule(32, LayerSpec(kind=ATTN, moe=True)),
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, expert_ff=14_336,
                  capacity_factor=1.25),
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    tie_embeddings=False,
    max_position=32_768,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
