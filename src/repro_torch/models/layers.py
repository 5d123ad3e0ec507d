"""Shared neural-net building blocks: the port of the reference's
``models/layers.py``.

Conventions, as in the reference:
  * every module is a pair ``init_<mod>(gen, ...) -> params`` and
    ``<mod>(params, x, ...) -> y``; params are plain dicts of tensors with
    the reference's keys and layouts (a dense kernel is ``(d_in, d_out)``);
  * compute happens in ``cfg.dtype``, params are stored in
    ``cfg.param_dtype``; RMSNorm and RoPE work in float32 and cast back.

Init draws from an explicit ``torch.Generator``, on the generator's device.
It cannot reproduce ``jax.random``'s draws, so the parity tests convert
JAX-initialised params (``utils.convert``) instead.

Tensor parallelism (``tp``, the model axis's process group, passed where a
leaf is cut over it by the reference's ``_TP_RULES``): the SwiGLU MLP's
``gate``/``up`` are column-parallel and ``down`` row-parallel; the
embedding table and the unembedding are cut over the vocabulary. The
operators are ``utils.collectives``' (``copy_to``, ``reduce_from``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils import collectives as col


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def truncated_normal_init(gen, shape, scale, dtype):
    """scale · N(0, 1) truncated to [-2, 2], drawn in float32 by the inverse
    CDF (as ``jax.random.truncated_normal`` draws), cast to ``dtype``."""
    if gen.device.type == "meta":  # a shape pass (transformer.abstract_params): no draw
        return torch.empty(shape, dtype=dtype, device="meta")
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    x.uniform_(lo, hi, generator=gen).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, *, scale=None):
    scale = scale if scale is not None else d_in**-0.5
    return truncated_normal_init(gen, (d_in, d_out), scale, dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, dtype):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype),
        "up": dense_init(gen, d_model, d_ff, dtype),
        "down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(params, x, tp=None):
    """SwiGLU; with ``tp`` the rank's columns of ``gate``/``up`` and rows of
    ``down``, the partial outputs summed over the group."""
    x = col.copy_to(x, tp)
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return col.reduce_from(h @ params["down"], tp)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab, d_model, dtype):
    return {"table": truncated_normal_init(gen, (vocab, d_model), 1.0, dtype)}


def embed(params, tokens, tp=None):
    """Rows of the table; with ``tp`` the table is the rank's range of the
    vocabulary: each rank looks up the ids in its range, zeros elsewhere,
    and the one nonzero term is summed over the group (exact)."""
    if tp is None:
        return params["table"][tokens]
    return col.reduce_from(embed_local(params["table"], tokens, tp), tp)


def embed_local(table, tokens, tp):
    """The rows of the ids in this rank's vocabulary range (``table`` its
    (V/m, d) piece), zeros for the others."""
    v_loc = table.shape[0]
    local = tokens - col.rank(tp) * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = table[torch.where(hit, local, 0)]
    return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


def init_unembed(gen, d_model, vocab, dtype):
    return {"kernel": dense_init(gen, d_model, vocab, dtype)}


def unembed(params, x, tp=None):
    """Logits; with ``tp`` the rank's vocabulary columns (left split)."""
    return col.copy_to(x, tp) @ params["kernel"]


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim, theta, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta):
    """x: (..., T, H, head_dim); positions: broadcastable to (..., T)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., :, None].float() * freqs  # (..., T, half)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions_thw, theta, sections):
    """Qwen2-VL multimodal RoPE.

    ``positions_thw``: (3, ..., T) temporal/height/width position ids (equal
    for text tokens). ``sections``: how many of the head_dim/2 frequency
    channels each of (t, h, w) claims, in that order.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to head_dim/2 = {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    # Per frequency channel, the positional axis that drives it.
    sec_ids = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                           device=x.device)
    pos_sel = torch.movedim(positions_thw[sec_ids], 0, -1)  # (..., T, half)
    angles = pos_sel.float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal 1-D convolution (Mamba-2 / RG-LRU input conv), cache-friendly
# ---------------------------------------------------------------------------


def init_conv1d(gen, channels, width, dtype):
    """Depthwise causal conv params in the reference's layout: the kernel is
    ``(W, C)`` (tap, channel), not ``F.conv1d``'s ``(C, 1, W)``."""
    return {
        "kernel": truncated_normal_init(gen, (width, channels), width**-0.5, dtype),
        "bias": torch.zeros((channels,), dtype=dtype, device=gen.device),
    }


def causal_conv1d(params, x):
    """x: (B, T, C) → depthwise causal conv, same length: the reference's sum
    of shifted products, tap 0 first."""
    w = params["kernel"]  # (W, C)
    width, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + t, :] * w[i] for i in range(width))
    return out + params["bias"]


def causal_conv1d_step(params, conv_state, x_t):
    """Single decode step. conv_state: (B, W-1, C) past inputs; x_t: (B, C).
    Returns (new_state (B, W-1, C), out (B, C))."""
    w = params["kernel"]
    width = w.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w) + params["bias"]
    return window[:, 1:width, :], out


def remat_active(x: torch.Tensor) -> bool:
    """Whether activation checkpointing can run where ``x`` is computed: a
    gradient is being taken by plain autograd, not inside a ``torch.func``
    transform (whose ``grad`` refuses the saved-tensor hooks that
    ``torch.utils.checkpoint`` installs)."""
    return (torch.is_grad_enabled() and x.requires_grad
            and torch._C._functorch.maybe_current_level() is None)
