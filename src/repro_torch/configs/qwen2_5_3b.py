"""qwen2.5-3b — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B (family); hf]  36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936, QKV bias, SwiGLU, head_dim=128.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="qwen2.5-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        dtype="float32", remat="none", attn_chunk=64,
    )
