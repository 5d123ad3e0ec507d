"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention 1:2 (pattern rec,rec,attn)
[arXiv:2402.19427]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "recurrentgemma-9b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    num_layers=38,                 # 12×(rec,rec,attn) + 2 trailing rec
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    local_attn_window=2048,
    lru_width=4096,
    conv_width=4,
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2402.19427",
)

LONG_CONTEXT_VARIANT = CONFIG  # native: RG-LRU state + bounded local window


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=5,              # exercises the non-divisible tail (5 % 3)
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        block_pattern=("rec", "rec", "attn"),
        local_attn_window=64,
        lru_width=256,
        source=CONFIG.source,
    )
