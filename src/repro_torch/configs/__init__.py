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
from repro_torch.configs.base import FAMILIES, ModelConfig

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


__all__ = ["ARCHS", "ARCH_IDS", "FAMILIES", "ModelConfig", "get_config", "get_long_variant",
           "get_smoke"]
