"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8).

[arXiv:2501.kimi2; unverified, paper-table]  61L d_model=7168 64H
(GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384e top-8, 1 shared
expert, first layer dense (d_ff=18432).  The assigned table specifies
GQA (not MLA); we follow the assignment.  FSDP over the data axis +
expert parallelism over the model axis; Adafactor keeps optimizer state
factored (a 1T-param AdamW would need ~8 TB of moments).
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18_432,                  # dense (first) layer FFN
    vocab_size=163_840,
    act="swiglu",
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        d_ff_shared=2048,
        capacity_factor=1.25,
        first_dense_layers=1,
    ),
    subquadratic=False,
    use_fsdp=True,
    optimizer="adafactor",
    remat="full",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="kimi-k2-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, d_ff_shared=32,
                      first_dense_layers=1),
        use_fsdp=False, optimizer="adamw",
        dtype="float32", remat="none", attn_chunk=64,
    )
