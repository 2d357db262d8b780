"""bert-mlm-120m — the paper's own small model (BERT-base-like encoder
pretrained with MLM on binary-code functions) [paper §II; arXiv:1810.04805].

12L d_model=768 12H d_ff=3072, learned positions, LayerNorm, MLM head.
Vocab 32768 (the paper's custom tokenizer size is unreported; see
EXPERIMENTS.md §Paper-claims).
"""
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="bert-mlm-120m",
    family="encoder",
    d_model=768,
    vocab_size=32_768,
    schedule=uniform_schedule(12, LayerSpec(kind=ATTN)),
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    mlp_act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    norm="layernorm",
    norm_eps=1e-12,
    tie_embeddings=True,
    pos_type="learned",
    max_position=512,
    source="paper §II + arXiv:1810.04805 (BERT-base)",
)
