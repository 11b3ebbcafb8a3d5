"""gemma-2b — dense MQA decoder with GeGLU and wide heads.

[arXiv:2403.08295; hf]  18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256, tied embeddings.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=False,
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="gemma-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=512,
        dtype="float32", remat="none", attn_chunk=64,
    )
