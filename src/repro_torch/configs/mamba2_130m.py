"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 => 24 SSD heads, 1 group, conv width 4.
"""
from repro_torch.configs.base import (MAMBA, LayerSpec, ModelConfig, SSMConfig,
                                      uniform_schedule)

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768,
    vocab_size=50280,
    schedule=uniform_schedule(24, LayerSpec(kind=MAMBA, has_mlp=False)),
    d_ff=0,
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, d_conv=4, expand=2,
                  chunk=256),
    norm="rmsnorm",
    tie_embeddings=True,
    pos_type="none",
    source="arXiv:2405.21060 (Mamba2 / SSD); 130m model card",
)
