"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone.

[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (80-dim fbank x2
stacked = 160 features/frame); the transformer backbone is what we build.
"""

from .base import ArchConfig, EncDecConfig, FrontendConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                   # per stack; see encdec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    act="gelu",                    # classic (non-gated) transformer FFN
    rope_theta=10_000.0,
    encdec=EncDecConfig(n_encoder_layers=24, n_decoder_layers=24),
    frontend=FrontendConfig(kind="audio", feature_dim=160, n_positions=0),
    subquadratic=False,            # full attention -> long_500k skipped
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="seamless-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=512,
        encdec=EncDecConfig(n_encoder_layers=2, n_decoder_layers=2),
        frontend=FrontendConfig(kind="audio", feature_dim=20, n_positions=0),
        dtype="float32", remat="none", attn_chunk=64,
    )
