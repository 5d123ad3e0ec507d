"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""

import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3.2-1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

# Sliding-window variant used for the long_500k decode shape (documented
# deviation — the source model is full-attention; DESIGN.md §5).
LONG_CONTEXT_VARIANT = dataclasses.replace(CONFIG, sliding_window=4096)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        rope_theta=500_000.0,
        source=CONFIG.source,
    )
