"""Config system: model / layer-schedule / run configuration.

A trimmed copy of the JAX package's ``configs/base.py``: the port keeps
its own configs so that it imports nothing of the JAX package.  The
dataclasses and their field names are the same, so one config reads the
same in both packages.  ``ModelConfig.n_params`` (the analytic count of
the JAX package's scaling model) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs — the unit of the BlockSchedule
# ---------------------------------------------------------------------------

ATTN = "attn"            # softmax attention (GQA / MHA)
MLA = "mla"              # DeepSeek multi-head latent attention
MAMBA = "mamba"          # Mamba2 / SSD block
SHARED_ATTN = "shared_attn"  # zamba2-style weight-shared attention block


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern inside a schedule group."""

    kind: str = ATTN                 # ATTN | MLA | MAMBA | SHARED_ATTN
    window: Optional[int] = None     # sliding-window size; None = global
    moe: bool = False                # MoE MLP instead of dense MLP
    shared_bank: int = 0             # which shared-weight bank (SHARED_ATTN)
    has_mlp: bool = True             # mamba blocks in mamba2 have no MLP


@dataclass(frozen=True)
class ScheduleGroup:
    """``pattern`` repeated ``repeats`` times; parameters are stacked over
    ``repeats`` (the ``layers`` axis)."""

    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8               # routed experts
    top_k: int = 2
    n_shared: int = 0                # always-on shared experts
    expert_ff: int = 0               # per-expert intermediate size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = no q compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64               # mamba2 P
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256                 # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    schedule: Tuple[ScheduleGroup, ...]

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_local_theta: float = 0.0    # gemma3 uses a different theta locally
    query_scale: float = 0.0         # 0 => 1/sqrt(head_dim)
    qk_norm: bool = False            # gemma3 per-head-dim q/k rmsnorm

    # mlp
    d_ff: int = 0
    mlp_act: str = "silu"            # silu (gated) | gelu (plain)
    gated_mlp: bool = True

    # norms / embeddings
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    post_norms: bool = False         # gemma2/3 post-attn/post-mlp norms

    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500       # whisper frontend output length (stub)

    # vlm
    n_image_tokens: int = 0          # stub patch-embedding prefix length

    # positional
    pos_type: str = "rope"           # rope | learned | none(ssm)
    max_position: int = 131_072

    # citation
    source: str = ""

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.schedule)


def uniform_schedule(n_layers: int, spec: LayerSpec) -> Tuple[ScheduleGroup, ...]:
    return (ScheduleGroup(pattern=(spec,), repeats=n_layers),)


# ---------------------------------------------------------------------------
# Run-level config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode


@dataclass(frozen=True)
class RunConfig:
    """The fields the port reads: ``param_dtype`` and
    ``activation_dtype`` (torch dtype names).  The sharding and kernel
    fields are kept so that a config reads the same in both packages; on
    the port the device of the tensors picks the kernel, not
    ``use_pallas``."""

    model: ModelConfig
    shape: ShapeConfig
    sharding: str = "fsdp_tp"
    pp_schedule: str = "1f1b"
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    microbatch: int = 0
    use_pallas: bool = False
    seq_parallel_serve: bool = False
    replicate_kv: bool = False

    def with_(self, **kw) -> "RunConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, *, d_model: int = 256, seq_ok: bool = True) -> ModelConfig:
    """Smoke-test variant: <=2 layers-worth of schedule, small dims."""
    g0 = cfg.schedule[0]
    pattern = g0.pattern[: max(1, min(2, len(g0.pattern)))]
    sig = lambda s: (s.kind, s.moe)
    have = {sig(s) for s in pattern}
    extra = []
    for g in cfg.schedule:
        for s in g.pattern:
            if sig(s) not in have:
                extra.append(s)
                have.add(sig(s))
    pattern = tuple(list(pattern) + extra)[:4]
    schedule = (ScheduleGroup(pattern=pattern, repeats=1),)

    n_heads = max(2, min(4, cfg.n_heads or 4))
    n_kv = max(1, min(cfg.n_kv_heads or n_heads, 2))
    head_dim = max(16, d_model // n_heads)
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, 1024),
        schedule=schedule,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=2 * d_model,
        max_position=4096,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            expert_ff=d_model,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=64, q_lora_rank=0,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
        kw["head_dim"] = 0
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = 2
        kw["n_audio_frames"] = 32
    if cfg.n_image_tokens:
        kw["n_image_tokens"] = 16
    # shrink sliding windows below the smoke seq_len
    new_groups = []
    for g in schedule:
        new_pat = tuple(
            replace(s, window=(16 if s.window is not None else None))
            for s in g.pattern
        )
        new_groups.append(ScheduleGroup(pattern=new_pat, repeats=g.repeats))
    kw["schedule"] = tuple(new_groups)
    return replace(cfg, **kw)
