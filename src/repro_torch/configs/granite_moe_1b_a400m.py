"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-moe-1b-a400m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    num_experts=32,
    experts_per_token=8,
    capacity_factor=1.5,
    moe_impl="ep",
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab_size=515,        # deliberately non-divisible, like the real vocab
        num_experts=4,
        experts_per_token=2,
        capacity_factor=2.0,
        moe_impl="dense",
        source=CONFIG.source,
    )
