"""qwen2-72b [dense] — GQA + QKV bias [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=29568 vocab=152064,
rope theta 1e6, untied embeddings, silu-gated MLP, rmsnorm.
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    d_model=8192,
    vocab_size=152_064,
    schedule=uniform_schedule(80, LayerSpec(kind=ATTN)),
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    tie_embeddings=False,
    max_position=131_072,
    source="arXiv:2407.10671 (Qwen2)",
)
