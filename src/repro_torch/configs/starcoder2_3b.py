"""starcoder2-3b [dense] — GQA + RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) head_dim=128 d_ff=12288 vocab=49152,
LayerNorm (with bias), non-gated gelu MLP, biases on QKV, rope theta ~1e5,
tied embeddings.
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    vocab_size=49_152,
    schedule=uniform_schedule(30, LayerSpec(kind=ATTN)),
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    mlp_act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    rope_theta=100_000.0,
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    max_position=16_384,
    source="arXiv:2402.19173 (StarCoder2)",
)
