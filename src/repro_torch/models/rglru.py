"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]:
the port of the reference's ``models/rglru.py``.

Block:  x → { linear→GeLU  ∥  linear→causal-conv→RG-LRU } → ⊙ → out linear

RG-LRU recurrence (per channel):
    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(-c · softplus(Λ) · r_t) (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 − a_t²) · (i_t ⊙ x_t)

The GeLU is the tanh approximation, ``jax.nn.gelu``'s default.

Prefill runs the linear recurrence as a log-depth doubling scan
(``rglru_scan``: ⌈log2 T⌉ steps, each a few elementwise launches over the
whole (B, T, W) block) where the reference uses
``jax.lax.associative_scan``; the two associate the same products in other
orders, so they agree to float32 rounding, not bitwise. The scan is
in place when no gradient is asked and out of place when one is, with
the same bits either way. Decode is the exact single-step update on a
(B, width) state.

Under tensor parallelism (``tp``, the model group, whose size cuts the
lru width when it divides it) the gates and the scan are per channel:
``gate_proj``/``rec_proj`` are column-parallel, each rank takes its
channels' slice of the replicated ``conv``, ``w_a``, ``b_a``, ``w_x``,
``b_x`` and ``lam`` and scans its own channels, ``out_proj`` is
row-parallel, and the decode cache holds the rank's channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.utils import collectives as col

_C = 8.0


def init_rglru_block(gen, cfg, dtype=None):
    dtype = dtype or layers.dtype_of(cfg.param_dtype)
    w = cfg.lru_width or cfg.d_model
    dev = gen.device
    return {
        "gate_proj": layers.dense_init(gen, cfg.d_model, w, dtype),
        "rec_proj": layers.dense_init(gen, cfg.d_model, w, dtype),
        "conv": layers.init_conv1d(gen, w, cfg.conv_width, dtype),
        # Per-channel (diagonal) gate maps, as in the reference.
        "w_a": layers.truncated_normal_init(gen, (w,), 1.0, torch.float32),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_x": layers.truncated_normal_init(gen, (w,), 1.0, torch.float32),
        "b_x": torch.zeros((w,), dtype=torch.float32, device=dev),
        # Λ init so that a ∈ (0.9, 0.999) at r=1 (Griffin's init range).
        "lam": torch.linspace(0.7, 5.0, w, dtype=torch.float32, device=dev),
        "out_proj": layers.dense_init(gen, w, cfg.d_model, dtype),
    }


def _gates(params, u):
    """u: (..., w) conv output. Returns (a, gated_input), both fp32."""
    uf = u.float()
    r = torch.sigmoid(uf * params["w_a"] + params["b_a"])
    i = torch.sigmoid(uf * params["w_x"] + params["b_x"])
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * uf)
    return a, gated


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t along dim 1 by a doubling scan.

    a, b: (B, T, W) fp32. h0: optional (B, W) initial state. After the step
    of shift s, position t holds the composition of steps (t-2s, t], so
    ⌈log2 T⌉ steps leave the inclusive prefix at every t.

    Without a gradient to take, the steps update copies of a and b in
    place (serving). When any input needs a gradient (autograd or
    ``torch.func.grad``, under ``vmap`` too), each step builds new tensors
    from the same products and sums instead, so autograd keeps what it
    saved; both give the same bits.
    """
    if _needs_grad(a, b, h0):
        return _scan_out_of_place(a, b, h0)
    a, b = a.clone(), b.clone()  # updated in place below
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    t = a.shape[1]
    s = 1
    while s < t:
        # (a1, b1) then (a2, b2) composes to (a2 a1, a2 b1 + b2). Each right
        # side is materialised before the write, so reading the prefix that
        # the write overlaps is safe.
        b[:, s:] += a[:, s:] * b[:, :-s]
        if 2 * s < t:  # the last step needs no products of a
            a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return b


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def _scan_out_of_place(a, b, h0):
    """``rglru_scan``'s steps, each as new tensors."""
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    t = a.shape[1]
    s = 1
    while s < t:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        if 2 * s < t:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


_CHANNEL_LEAVES = ("w_a", "b_a", "w_x", "b_x", "lam")


def _local(params, tp):
    """``params`` with the per-channel leaves cut to this rank's channels
    (``tp`` None: as they are)."""
    if tp is None:
        return params
    cut = lambda a: col.slice_to(a, tp, -1)  # noqa: E731
    out = dict(params, conv={k: cut(a) for k, a in params["conv"].items()})
    out.update({k: cut(params[k]) for k in _CHANNEL_LEAVES})
    return out


def rglru_block_forward(params, cfg, x, h0=None, tp=None):
    """x: (B, T, d_model) → (y (B, T, d_model), (h_T, conv_tail))."""
    params = _local(params, tp)
    x = col.copy_to(x, tp)
    gate = F.gelu(x @ params["gate_proj"], approximate="tanh")
    rec_in = x @ params["rec_proj"]
    w = params["conv"]["kernel"].shape[0]
    t = x.shape[1]
    tail_src = F.pad(rec_in, (0, 0, max(0, w - 1 - t), 0))
    conv_tail = tail_src[:, tail_src.shape[1] - (w - 1):, :] if w > 1 else rec_in[:, :0]
    u = layers.causal_conv1d(params["conv"], rec_in)
    a, b = _gates(params, u)
    h = rglru_scan(a, b, h0)
    y = col.reduce_from((h.to(x.dtype) * gate) @ params["out_proj"], tp)
    return y, (h[:, -1], conv_tail)


def init_rglru_cache(cfg, batch, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_decode_step(params, cfg, cache, x_t, tp=None):
    """One-token step. x_t: (B, d_model). Returns (y (B, d_model), new cache)."""
    params = _local(params, tp)
    x_t = col.copy_to(x_t, tp)
    gate = F.gelu(x_t @ params["gate_proj"], approximate="tanh")
    new_conv, u = layers.causal_conv1d_step(params["conv"], cache["conv"],
                                            x_t @ params["rec_proj"])
    a, b = _gates(params, u)
    h = a * cache["state"] + b
    y = col.reduce_from((h.to(x_t.dtype) * gate) @ params["out_proj"], tp)
    return y, {"state": h, "conv": new_conv}
