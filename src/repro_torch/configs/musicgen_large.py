"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32, i.e. full MHA)
d_ff=8192 vocab=2048, decoder-only over EnCodec tokens (4 codebooks,
delay pattern) [arXiv:2306.05284].

EnCodec frontend is a STUB per the task carve-out: the data pipeline
supplies codebook token ids (B, K=4, T); this config implements the
transformer decoder with per-codebook embeddings/heads."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "musicgen-large"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2306.05284",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=256,
        num_codebooks=4,
        source=CONFIG.source,
    )
