"""Architecture config schema for the assigned model pool (a copy of
``repro.configs.base``: data only).

Every architecture in ``repro_torch.configs`` instantiates
:class:`ArchConfig` with its exact published dimensions, plus a
``smoke()`` reduced variant of the same family for CPU tests.  The model
zoo (``repro_torch.models``) builds parameters and step functions purely
from this schema.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "XLSTMConfig",
           "EncDecConfig", "FrontendConfig", "ArchConfig", "SHAPES",
           "ShapeSpec"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0           # per shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 1    # leading dense layers (DeepSeek/Kimi style)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack: mLSTM blocks with sLSTM blocks interleaved."""
    slstm_every: int = 8           # every k-th block is sLSTM (rest mLSTM)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_kernel: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 24
    n_decoder_layers: int = 24


@dataclass(frozen=True)
class FrontendConfig:
    kind: str = "none"             # "audio" | "vision" | "none"
    feature_dim: int = 0           # precomputed frame/patch embedding dim
    n_positions: int = 0           # patches per image / frames per clip


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"            # swiglu|geglu|gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    subquadratic: bool = False     # eligible for long_500k
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # hybrid (zamba2-style): shared attention block applied every k ssm layers
    shared_attn_every: int = 0
    n_shared_attn_blocks: int = 0
    # distribution hints
    use_fsdp: bool = False         # shard weights over the data axis too
    optimizer: str = "adamw"       # adamw|adafactor|sgdm
    remat: str = "full"            # full|dots|none
    attn_chunk: int = 1024         # query-chunked attention block (train/prefill)
    unroll: bool = False           # unroll all scans (dry-run cost probes only)
    # -- perf-variant knobs (EXPERIMENTS.md §Perf A/B) ------------------- #
    moe_combine: str = "scatter"   # "scatter" (baseline) | "gather" (opt)
    shard_moe_dispatch: bool = False  # d-shard dispatch buf (avoids weight
    #                                   all-gather under FSDP at decode)
    accum_steps: int = 1           # microbatch accumulation for train_step
    kv_cache_dtype: str = "model"  # "model" | "int8" (quantized decode cache)
    dp_only: bool = False          # small models: FSDP over data, no TP

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- approximate parameter counts (roofline MODEL_FLOPS) --------------- #

    def param_count(self) -> int:
        """Total parameters (embedding included once)."""
        from repro_torch.models.model_zoo import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train|prefill|decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
