"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (q uncompressed in Lite),
qk_nope=128 qk_rope=64 v=128; vocab=102400; MoE: 64 routed experts top-6 +
2 shared experts, expert d_ff=1408; layer 0 is a dense MLP (d_ff=10944,
first_k_dense_replace=1 per the model card).
"""
from repro_torch.configs.base import (MLA, LayerSpec, MLAConfig, ModelConfig,
                                      MoEConfig, ScheduleGroup)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    vocab_size=102_400,
    schedule=(
        ScheduleGroup(pattern=(LayerSpec(kind=MLA, moe=False),), repeats=1),
        ScheduleGroup(pattern=(LayerSpec(kind=MLA, moe=True),), repeats=26),
    ),
    n_heads=16,
    n_kv_heads=16,
    head_dim=0,  # MLA defines its own head dims
    d_ff=10_944,  # dense layer-0 MLP
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408,
                  capacity_factor=1.25),
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=False,
    max_position=32_768,
    source="arXiv:2405.04434 (DeepSeek-V2); V2-Lite card",
)
