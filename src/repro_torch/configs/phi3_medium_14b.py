"""phi3-medium-14b — dense GQA decoder.

[arXiv:2404.14219; unverified]  40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352, RoPE SwiGLU GQA, head_dim=128.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    act="swiglu",
    rope_theta=10_000.0,
    subquadratic=False,
    use_fsdp=True,
    optimizer="adamw",
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="phi3-medium-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, use_fsdp=False,
        dtype="float32", remat="none", attn_chunk=64,
    )
