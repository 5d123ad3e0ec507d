"""Hand-written CUDA kernels (the compression hot path, K1–K3, and flash
attention, K4), their plain PyTorch versions, and the wrappers that
dispatch between them by device."""

from repro_torch.kernels import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
