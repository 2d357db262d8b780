"""bert-mlm-350m — the paper's larger model (BERT-large-like encoder)
[paper §II; arXiv:1810.04805].

24L d_model=1024 16H d_ff=4096, learned positions, LayerNorm, MLM head.
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="bert-mlm-350m",
    family="encoder",
    d_model=1024,
    vocab_size=32_768,
    schedule=uniform_schedule(24, LayerSpec(kind=ATTN)),
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    norm="layernorm",
    norm_eps=1e-12,
    tie_embeddings=True,
    pos_type="learned",
    max_position=512,
    source="paper §II + arXiv:1810.04805 (BERT-large)",
)
