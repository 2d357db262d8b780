"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54 Mamba2 blocks, d_model=2560, ssm_state=64 (d_inner=5120, head_dim 64 =>
80 SSD heads); two weight-SHARED transformer blocks (32H MHA kv=32,
d_ff=10240) interleaved every 6 Mamba blocks, alternating bank A/B:
(6xmamba, A, 6xmamba, B) x 4 + (6xmamba, A).  vocab=32000.

Simplifications vs the released model, as in the JAX package's config:
the shared block attends over d_model (the release concatenates the
original embedding, 2*d_model) and per-invocation LoRA adapters are
omitted.
"""
from repro_torch.configs.base import (MAMBA, SHARED_ATTN, LayerSpec, ModelConfig,
                                      ScheduleGroup, SSMConfig)

_M = LayerSpec(kind=MAMBA, has_mlp=False)
_A = LayerSpec(kind=SHARED_ATTN, shared_bank=0)
_B = LayerSpec(kind=SHARED_ATTN, shared_bank=1)

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    vocab_size=32_000,
    schedule=(
        ScheduleGroup(pattern=(_M,) * 6 + (_A,) + (_M,) * 6 + (_B,), repeats=4),
        ScheduleGroup(pattern=(_M,) * 6 + (_A,), repeats=1),
    ),
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, d_conv=4, expand=2,
                  chunk=256),
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    max_position=4096,
    source="arXiv:2411.15242 (Zamba2)",
)
