"""gemma3-4b [dense] — 5:1 local:global, 128k context
[arXiv:2503.19786; hf:google/gemma-3-4b-pt].

34L d_model=2560 8H (GQA kv=4) head_dim=256 d_ff=10240 vocab=262144.
Pattern: (5 x local sliding-window 1024, 1 x global) x 5 + 4 x local.
QK-norm (replaces gemma2's attn softcap), global rope theta 1e6 with
local-layer theta 1e4, post-norms, scaled embeddings.
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, ScheduleGroup

_L = LayerSpec(kind=ATTN, window=1024)
_G = LayerSpec(kind=ATTN)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    d_model=2560,
    vocab_size=262_144,
    schedule=(
        ScheduleGroup(pattern=(_L,) * 5 + (_G,), repeats=5),
        ScheduleGroup(pattern=(_L,) * 4, repeats=1),
    ),
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    mlp_act="gelu",
    gated_mlp=True,
    qk_norm=True,
    query_scale=256.0**-0.5,
    post_norms=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    max_position=131_072,
    source="arXiv:2503.19786 / hf:google/gemma-3-4b-pt",
)
