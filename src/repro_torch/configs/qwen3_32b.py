"""qwen3-32b — dense GQA decoder with qk-norm.

[hf:Qwen/Qwen3-8B (family); hf]  64L d_model=5120 64H (GQA kv=8)
d_ff=25600 vocab=151936, qk_norm, head_dim=128, RoPE theta 1e6, SwiGLU.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
    use_fsdp=True,
    optimizer="adamw",
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="qwen3-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, use_fsdp=False,
        dtype="float32", remat="none", attn_chunk=64,
    )
