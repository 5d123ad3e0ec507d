"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 [arXiv:2501.kimi2] (paper-table config)."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,                # per-expert ffn width
    vocab_size=163_840,
    num_experts=384,
    experts_per_token=8,
    capacity_factor=1.25,
    moe_impl="ep",
    rope_theta=500_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2501.kimi2",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        capacity_factor=2.0,
        moe_impl="dense",
        source=CONFIG.source,
    )
