"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no biases [hf:CohereForAI/c4ai-command-r-v01]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "command-r-plus-104b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    rope_theta=75_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=384,
        num_heads=6,
        num_kv_heads=2,
        head_dim=64,
        d_ff=768,
        vocab_size=512,
        source=CONFIG.source,
    )
