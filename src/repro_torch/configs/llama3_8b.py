"""llama3-8b [dense] — bonus (public pool, not in the assigned ten)
[arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=128256,
rope theta 500k, silu-gated MLP, rmsnorm, untied embeddings.
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    d_model=4096,
    vocab_size=128_256,
    schedule=uniform_schedule(32, LayerSpec(kind=ATTN)),
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    rope_theta=500_000.0,
    norm="rmsnorm",
    tie_embeddings=False,
    max_position=8192,
    source="arXiv:2407.21783 (The Llama 3 Herd of Models)",
)
