"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE + dynamic resolution [arXiv:2409.12191].

Vision frontend is a STUB per the task carve-out: ``input_specs`` provides
precomputed patch embeddings (B, P, d_model); this config implements the
language decoder that consumes them, with the real M-RoPE."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,            # Qwen2 attention uses QKV bias
    mrope=True,
    mrope_sections=(16, 24, 24),
    num_patches=1024,         # stub image: 1024 patch embeddings per sample
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2409.12191",
)

LONG_CONTEXT_VARIANT = None  # full attention → long_500k skipped (DESIGN §5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        qkv_bias=True,
        mrope=True,
        mrope_sections=(4, 6, 6),
        num_patches=16,
        source=CONFIG.source,
    )
