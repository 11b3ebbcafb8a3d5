"""xlstm-1.3b — sLSTM + mLSTM block stack.

[arXiv:2405.04517; unverified]  48L d_model=2048 4H d_ff=0 (projection
factor lives inside the xLSTM blocks) vocab=50304.  Every 8th block is an
sLSTM (scalar memory, true recurrence); the rest are mLSTM (matrix
memory, parallelizable).  Fully recurrent -> long_500k runs.
"""

from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    act="gelu",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.333, conv_kernel=4),
    subquadratic=True,
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=512,
        xlstm=XLSTMConfig(slstm_every=2, proj_factor_mlstm=2.0,
                          proj_factor_slstm=1.333, conv_kernel=4),
        dtype="float32", remat="none", attn_chunk=64,
    )
