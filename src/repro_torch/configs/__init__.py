"""Config registry: ``--arch <id>`` resolution for the port's launchers.

``ARCH_IDS`` names every architecture of the reference, in its order. The
ones whose model family the port runs are registered here with their own
copy of the reference's config module (``CONFIG``,
``LONG_CONTEXT_VARIANT``, ``smoke()``); asking for any other raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from repro_torch.configs import llama3_2_1b
from repro_torch.configs.base import FAMILIES, ModelConfig

ARCH_IDS = (
    "llama3.2-1b",
    "kimi-k2-1t-a32b",
    "granite-moe-1b-a400m",
    "qwen2-vl-72b",
    "musicgen-large",
    "recurrentgemma-9b",
    "command-r-plus-104b",
    "qwen2.5-3b",
    "mamba2-780m",
    "yi-34b",
)

ARCHS = {m.ARCH_ID: m for m in (llama3_2_1b,)}

# Family of each architecture not registered yet. The dense ones run on
# the ported transformer; only their config modules wait to be copied.
_PENDING = {
    "kimi-k2-1t-a32b": "moe",
    "granite-moe-1b-a400m": "moe",
    "qwen2-vl-72b": "vlm",
    "musicgen-large": "audio",
    "recurrentgemma-9b": "hybrid",
    "command-r-plus-104b": "dense",
    "qwen2.5-3b": "dense",
    "mamba2-780m": "ssm",
    "yi-34b": "dense",
}


def _module(arch_id: str):
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in _PENDING:
        raise NotImplementedError(
            f"arch {arch_id!r} ({_PENDING[arch_id]} family) is not ported yet: "
            f"ROADMAP Queue 1 item 6")
    raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


__all__ = ["ARCHS", "ARCH_IDS", "FAMILIES", "ModelConfig", "get_config", "get_smoke"]
