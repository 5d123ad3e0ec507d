"""Config registry: ``--arch <id>`` resolution for the port's launchers.

Every architecture of the reference is registered, in its order, with the
port's own copy of the reference's config module:

  CONFIG                — the exact assigned spec (full scale)
  LONG_CONTEXT_VARIANT  — config used for the long_500k decode shape
                          (None → that shape is skipped)
  smoke()               — reduced same-family variant for CPU tests
"""

from __future__ import annotations

from repro_torch.configs import (
    command_r_plus_104b,
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    llama3_2_1b,
    mamba2_780m,
    musicgen_large,
    qwen2_5_3b,
    qwen2_vl_72b,
    recurrentgemma_9b,
    yi_34b,
)
from repro_torch.configs.base import (
    FAMILIES,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    TrainConfig,
)

_MODULES = (
    llama3_2_1b,
    kimi_k2_1t_a32b,
    granite_moe_1b_a400m,
    qwen2_vl_72b,
    musicgen_large,
    recurrentgemma_9b,
    command_r_plus_104b,
    qwen2_5_3b,
    mamba2_780m,
    yi_34b,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    return ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_long_variant(arch_id: str) -> ModelConfig | None:
    return _module(arch_id).LONG_CONTEXT_VARIANT


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


def default_grad_sync(cfg: ModelConfig, *, multi_pod: bool) -> str:
    """The reference's choice of grad-sync mode: compression over ``data``
    on one pod when the params and the per-shard error-feedback state fit
    (≤ 5e9 params), over ``pod`` across pods, dense otherwise; the archs
    that need FSDP (> 40e9 params) sync densely across pods."""
    from repro_torch.dist.step import needs_fsdp

    if multi_pod:
        return "dense" if needs_fsdp(cfg) else "gmf_pod"
    return "dense" if cfg.param_count() > 5e9 else "gmf_data"


__all__ = ["ARCHS", "ARCH_IDS", "FAMILIES", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "TrainConfig", "default_grad_sync", "get_config", "get_long_variant", "get_smoke"]
