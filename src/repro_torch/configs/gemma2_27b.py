"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) head_dim=128 d_ff=36864 vocab=256000.
Pattern: (local sliding-window 4096, global) x 23.  attn softcap 50,
final softcap 30, query scale (d_model/n_heads)^-0.5 = 144^-0.5,
gelu-gated MLP, post-norms, embedding scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, ScheduleGroup

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    d_model=4608,
    vocab_size=256_000,
    schedule=(
        ScheduleGroup(
            pattern=(LayerSpec(kind=ATTN, window=4096), LayerSpec(kind=ATTN)),
            repeats=23,
        ),
    ),
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    mlp_act="gelu",
    gated_mlp=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0**-0.5,
    post_norms=True,
    embed_scale=True,
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    max_position=8192,
    source="arXiv:2408.00118 (Gemma 2)",
)
