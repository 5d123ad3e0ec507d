"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-style GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-34b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2403.04652",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=448,
        num_heads=7,
        num_kv_heads=1,
        head_dim=64,
        d_ff=896,
        vocab_size=512,
        source=CONFIG.source,
    )
