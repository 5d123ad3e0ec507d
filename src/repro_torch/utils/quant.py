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
order-free and so deterministic. Over a layout of pieces cut across a
mesh axis the blocks are the whole leaves' 256-entry blocks, their maxima
taken over the group.

``roundtrip_ternary_blocks`` / ``roundtrip_ternary_segments`` are the
probabilistic sibling (the ``probquant`` wire): the same blocks, each
entry sent as ``sign(x)·s`` (``s`` its block's max magnitude) with
probability ``|x|/s`` and as 0 otherwise, so the round trip is unbiased.
They take the uniforms as an argument (``u < |x|/s`` keeps an entry): the
stage draws them from its key chain (``utils/draws.py``), a parity test
passes JAX's.
"""

from __future__ import annotations

import torch
import torch.distributed

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


def _segment_block_amax(xf: torch.Tensor, layout, block: int) -> torch.Tensor:
    """Each element's block max magnitude, for ``[rows, N]`` rows of
    ``layout`` cut into ``block``-entry blocks from each leaf's start. On a
    layout of pieces cut over a group the blocks are the whole leaves'
    (``FlatLayout.blocks``): a cut leaf's block maxima are each rank's
    partial maxima, all-reduced with MAX over the group (idempotent, so a
    piece several ranks hold alike needs no once-counting)."""
    nblocks, idx = layout.blocks(block)
    rows = xf.shape[0]
    amax = torch.zeros(rows, nblocks, dtype=torch.float32, device=xf.device).scatter_reduce_(
        1, idx.expand(rows, -1), torch.abs(xf), "amax")
    if layout.cut:
        cols = layout.cut_blocks(block)
        part = amax[:, cols].contiguous()
        torch.distributed.all_reduce(part, op=torch.distributed.ReduceOp.MAX, group=layout.group)
        amax[:, cols] = part
    return amax.index_select(1, idx)


def roundtrip_q8_segments(x: torch.Tensor, layout, block: int = WIRE_BLOCK) -> torch.Tensor:
    """``roundtrip_q8_blocks`` of every leaf segment of a flat ``[..., N]``
    stack of ``layout``, each row on its own: the JAX wire's round trip of a
    payload tree, in a fixed number of ops whatever the leaf count."""
    xf = x.float().reshape(-1, layout.total)
    # the max's division by 127, per element: the same float32 value per block
    per_elem = _segment_block_amax(xf, layout, block) / scalar(INT8_MAX, xf.device)
    out = _quantize(xf, per_elem).float() * per_elem
    return out.reshape(x.shape).to(x.dtype)


def roundtrip_ternary_blocks(x: torch.Tensor, u: torch.Tensor,
                             block: int = WIRE_BLOCK) -> torch.Tensor:
    """Probabilistic ternary quantisation of one tensor over flat
    ``block``-entry blocks (the reference's ``roundtrip_ternary_blocks``);
    ``u`` holds one float32 uniform per element of ``x`` in flat order (its
    first ``x.numel()`` entries are read). All-zero blocks decode to exact
    zeros; an entry equal to its block's max is always kept."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    uf = u.float().reshape(-1)[:n]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
        uf = torch.cat([uf, uf.new_ones(pad)])
    blocks = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    out = _ternary(blocks, amax, uf.reshape(-1, block))
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def roundtrip_ternary_segments(x: torch.Tensor, layout, u: torch.Tensor,
                               block: int = WIRE_BLOCK) -> torch.Tensor:
    """``roundtrip_ternary_blocks`` of every leaf segment of a flat ``[..., N]``
    stack of ``layout``, each row on its own; ``u`` is ``[N]`` (shared by
    every row) or of ``x``'s shape."""
    xf = x.float().reshape(-1, layout.total)
    out = _ternary(xf, _segment_block_amax(xf, layout, block),
                   u.float().reshape(-1, layout.total))
    return out.reshape(x.shape).to(x.dtype)


def _ternary(xf: torch.Tensor, amax: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sign(x)·s where u < |x| / s (a true division by the block maxima,
    1 where a block is all zeros), else 0."""
    safe = torch.where(amax > 0.0, amax, torch.ones_like(amax))
    return torch.where(u < torch.abs(xf) / safe, torch.sign(xf) * amax, 0.0)
