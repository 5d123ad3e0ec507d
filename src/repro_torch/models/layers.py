"""Shared neural-net building blocks: the port of the reference's
``models/layers.py`` (the dense-transformer part).

Conventions, as in the reference:
  * every module is a pair ``init_<mod>(gen, ...) -> params`` and
    ``<mod>(params, x, ...) -> y``; params are plain dicts of tensors with
    the reference's keys and layouts (a dense kernel is ``(d_in, d_out)``);
  * compute happens in ``cfg.dtype``, params are stored in
    ``cfg.param_dtype``; RMSNorm and RoPE work in float32 and cast back.

Init draws from an explicit ``torch.Generator``, on the generator's device.
It cannot reproduce ``jax.random``'s draws, so the parity tests convert
JAX-initialised params (``utils.convert``) instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def truncated_normal_init(gen, shape, scale, dtype):
    """scale · N(0, 1) truncated to [-2, 2], drawn in float32 by the inverse
    CDF (as ``jax.random.truncated_normal`` draws), cast to ``dtype``."""
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


def mlp(params, x):
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab, d_model, dtype):
    return {"table": truncated_normal_init(gen, (vocab, d_model), 1.0, dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def init_unembed(gen, d_model, vocab, dtype):
    return {"kernel": dense_init(gen, d_model, vocab, dtype)}


def unembed(params, x):
    return x @ params["kernel"]


# ---------------------------------------------------------------------------
# Rotary position embeddings
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
