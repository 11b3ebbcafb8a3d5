"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff=1536 (expert)
vocab=102400, MLA kv_lora_rank=512 q_lora_rank=1536 (rope 64 / nope 128 /
v 128), MoE: 2 shared + 160 routed top-6, first layer dense (d_ff=12288).
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,               # MLA: per-head KV from the shared latent
    head_dim=128,
    d_ff=12_288,                  # dense (first) layer FFN
    vocab_size=102_400,
    act="swiglu",
    rope_theta=10_000.0,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared_experts=2,
        d_ff_shared=1536,
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
        name="deepseek-v2-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        mla=MLAConfig(kv_lora_rank=16, q_lora_rank=32,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=2, d_ff_shared=32,
                      first_dense_layers=1),
        use_fsdp=False, optimizer="adamw",
        dtype="float32", remat="none", attn_chunk=64,
    )
