"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The entry points default to ``"cuda"`` and never carry on on the CPU
    when no card is present: the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-dim tensor on ``device``. A tensor passes through (cast to
    ``dtype``); a Python number is written by a fill kernel, so no
    host-to-device copy, and no stream synchronisation, is made."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def to_device(array, device) -> torch.Tensor:
    """A numpy array on ``device`` without waiting for the work queued on
    the stream (``torch.as_tensor(..., device=...)`` synchronises it)."""
    return torch.from_numpy(array).to(device, non_blocking=True)


def weak(value: float, dtype) -> float:
    """The Python number ``value`` rounded to ``dtype``, as JAX rounds a
    weakly typed scalar to the array it multiplies: ``0.9 * u`` is
    ``bfloat16(0.9) * u`` for a bfloat16 ``u``, where torch would multiply
    by 0.9 in float32 and round once. The result is exactly representable
    in ``dtype``, so torch's own cast of it changes nothing; for float32
    it is the value torch casts to anyway."""
    return float(torch.tensor(float(value), dtype=torch.float64).to(dtype))
