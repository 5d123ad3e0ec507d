"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2.5-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        qkv_bias=True,
        source=CONFIG.source,
    )
