"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP patch stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(GQA kv=32) d_ff=8192 vocab=32064.  The CLIP-L/14 vision tower is a STUB
per the assignment: ``input_specs()`` provides precomputed patch
embeddings (576 patches x 1024 features); the backbone consumes them via
a learned projector.
"""

from .base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    act="swiglu",
    rope_theta=10_000.0,
    frontend=FrontendConfig(kind="vision", feature_dim=1024, n_positions=576),
    subquadratic=False,
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="phi3-vision-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        frontend=FrontendConfig(kind="vision", feature_dim=32, n_positions=16),
        dtype="float32", remat="none", attn_chunk=64,
    )
