"""Symmetric per-block int8 quantisation (Konečný et al., arXiv:1610.05492),
a copy of the JAX package's ``utils/quant.py`` codec for the int8 wire.

``scale = max|x| / 127`` per block, ``q = round(x / scale)`` clipped to
[-127, 127], ``x̂ = q · scale``. All-zero blocks get scale 0 and decode
back to exact zeros, so sparse payloads stay sparse through the round
trip (an entry is nonzero after decode only if it was nonzero before —
the nnz accounting is unchanged). Rounding is half to even
(``torch.round``, as ``jnp.round``), and both divisions are true
divisions by device tensors: CUDA divides by a Python scalar as a product
with its reciprocal, one rounding off.

The JAX wire quantises each leaf of the payload tree on its own, in flat
256-entry blocks with the leaf's tail padded by zeros.
``roundtrip_q8_segments`` does the same on a flat ``[..., N]`` stack
(``utils/flat.py``): blocks start at each leaf's offset in each row, and
each block's max is one ``scatter_reduce("amax")``, which is
order-free and so deterministic.
"""

from __future__ import annotations

import torch

from repro_torch.utils.device import scalar

INT8_MAX = 127.0
WIRE_BLOCK = 256  # block length of the int8 wire stage


def quantize_q8(x: torch.Tensor, axis: int = -1):
    """Quantise ``x`` over ``axis`` -> (q int8, scale float32); ``scale`` has
    ``x``'s shape with ``axis`` removed. Blocks whose max magnitude is 0 get
    scale 0 (and decode to exact zeros)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=axis) / scalar(INT8_MAX, xf.device)
    return _quantize(xf, scale.unsqueeze(axis)), scale


def dequantize_q8(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_q8` (up to the rounding error)."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / safe) clipped to ±127 as int8, ``scale`` broadcast to x."""
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(xf / safe), -INT8_MAX, INT8_MAX).to(torch.int8)


def roundtrip_q8_blocks(x: torch.Tensor, block: int = WIRE_BLOCK) -> torch.Tensor:
    """One tensor through flat ``block``-entry int8 blocks and back (the
    reference's wire round trip of one leaf). Padding zeros never raise a
    block's max, so the tail needs no padding here."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = quantize_q8(flat.reshape(-1, block), axis=-1)
    return dequantize_q8(q, scale, axis=-1).reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def roundtrip_q8_segments(x: torch.Tensor, layout, block: int = WIRE_BLOCK) -> torch.Tensor:
    """``roundtrip_q8_blocks`` of every leaf segment of a flat ``[..., N]``
    stack of ``layout``, each row on its own: the JAX wire's round trip of a
    payload tree, in a fixed number of ops whatever the leaf count."""
    nblocks, idx = layout.blocks(block)
    xf = x.float().reshape(-1, layout.total)
    rows = xf.shape[0]
    amax = torch.zeros(rows, nblocks, dtype=torch.float32, device=xf.device).scatter_reduce_(
        1, idx.expand(rows, -1), torch.abs(xf), "amax")
    scale = amax / scalar(INT8_MAX, xf.device)
    per_elem = scale.index_select(1, idx)
    out = _quantize(xf, per_elem).float() * per_elem
    return out.reshape(x.shape).to(x.dtype)
