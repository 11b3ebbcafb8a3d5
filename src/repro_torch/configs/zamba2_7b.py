"""zamba2-7b — hybrid: Mamba-2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (GQA kv=32)
d_ff=14336 vocab=32000, ssm_state=64.  Two shared transformer blocks are
applied (alternating) every 6 Mamba layers — the Zamba2 weight-sharing
scheme.  Simplifications vs the released model (documented in DESIGN.md):
additive residual instead of the embedding-concat re-injection, no LoRA
adapters on the shared blocks.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,                   # Mamba-2 layers
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,                   # shared block FFN
    vocab_size=32_000,
    act="swiglu",
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=2, chunk_size=256),
    shared_attn_every=6,
    n_shared_attn_blocks=2,
    subquadratic=True,             # Mamba backbone -> long_500k runs
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="zamba2-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk_size=32),
        shared_attn_every=2, n_shared_attn_blocks=2,
        dtype="float32", remat="none", attn_chunk=64,
    )
