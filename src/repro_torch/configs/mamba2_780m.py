"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, ssm_state=128,
SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-780m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    num_layers=48,
    d_model=1536,
    d_ff=0,                    # attention-free, no separate FFN
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    conv_width=4,
    ssd_chunk=128,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat=True,
    source="arXiv:2405.21060",
)

LONG_CONTEXT_VARIANT = CONFIG  # native: constant-size recurrent state


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=256,
        d_ff=0,
        vocab_size=512,
        ssm_state=32,
        ssm_headdim=64,
        ssm_expand=2,
        ssd_chunk=16,
        source=CONFIG.source,
    )
