"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060]: the port of
the reference's ``models/ssm.py``.

Prefill uses the chunked SSD algorithm (matrix products within chunks, a
recurrence over chunk states); decode is the exact recurrence on a
constant-size state (B, nh, p, n).

Layer layout follows the reference Mamba-2 block:
  in_proj → [z | x | B | C | dt]; causal conv over [x|B|C]; SSD; y·silu(z);
  out_proj; plus per-head A_log, D and dt_bias params.

Dtypes follow the reference's promotion: its einsums contract x-dtype
operands (C, B, x) with float32 ones (the decays), which JAX promotes to
float32, so the port casts those operands up before each product; the
chunk states entering the off-diagonal term are cast down to x's dtype
first, as the reference casts them.

Under tensor parallelism (``tp``, the model group) ``in_proj``'s columns
are cut wherever its width divides the group, which does not fall on the
[z | x | B | C | dt] parts: its output is gathered, every rank runs the
whole SSD, and ``out_proj`` is row-parallel (the rank's slice of y into
its rows, summed over the group). The decode cache is whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.utils import collectives as col


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_in + 2 * g * n
    return d_in, nh, g, n, conv_dim


def init_ssm(gen, cfg, dtype=None):
    dtype = dtype or layers.dtype_of(cfg.param_dtype)
    d_in, nh, g, n, conv_dim = dims(cfg)
    proj_out = 2 * d_in + 2 * g * n + nh
    dev = gen.device
    return {
        "in_proj": layers.dense_init(gen, cfg.d_model, proj_out, dtype),
        "conv": layers.init_conv1d(gen, conv_dim, cfg.conv_width, dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "out_proj": layers.dense_init(gen, d_in, cfg.d_model, dtype),
    }


def _in_proj(params, cfg, x, tp):
    """x @ in_proj, gathered whole where ``tp`` cuts its columns."""
    d_in, nh, g, n, _ = dims(cfg)
    if tp is None or params["in_proj"].shape[-1] == 2 * d_in + 2 * g * n + nh:
        return x @ params["in_proj"]
    return col.gather_from(col.copy_to(x, tp) @ params["in_proj"], tp, -1)


def _out_proj(params, cfg, y, tp):
    """y @ out_proj, row-parallel where ``tp`` cuts its rows."""
    if tp is None or params["out_proj"].shape[-2] == dims(cfg)[0]:
        return y @ params["out_proj"]
    return col.reduce_from(col.slice_to(y, tp, -1) @ params["out_proj"], tp)


def _split_proj(cfg, zxbcdt):
    d_in, nh, g, n, _ = dims(cfg)
    z, x, bc, dt = torch.split(zxbcdt, [d_in, d_in, 2 * g * n, nh], dim=-1)
    b, c = torch.split(bc, g * n, dim=-1)
    return z, x, b, c, dt


def _segsum(a):
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} a[..., k], -inf for j>i."""
    s = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, a, bmat, cmat, chunk, initial_state=None):
    """Chunked SSD scan.

    x: (B, T, H, P) inputs (already multiplied by dt)
    a: (B, T, H)     log-decay per step (dt * A, negative), float32
    bmat/cmat: (B, T, G, N) input/output projections (G groups broadcast to H)
    Returns y: (B, T, H, P) in x's dtype, final_state: (B, H, P, N) float32.
    """
    b, t, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if t % chunk:
        raise ValueError(f"T={t} not a multiple of ssd_chunk={chunk}")
    c = t // chunk
    reps = h // g
    br = torch.repeat_interleave(bmat, reps, dim=2)  # (B, T, H, N)
    cr = torch.repeat_interleave(cmat, reps, dim=2)

    xs = x.reshape(b, c, chunk, h, p).float()
    asx = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, S)
    bs = br.reshape(b, c, chunk, h, n).float()
    cs_ = cr.reshape(b, c, chunk, h, n).float()

    a_cumsum = torch.cumsum(asx, dim=-1)  # (B, H, C, S)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(asx))  # (B, H, C, S, S)
    scores = torch.einsum("bcshn,bczhn->bhcsz", cs_, bs) * L
    y_diag = torch.einsum("bhcsz,bczhp->bcshp", scores, xs)

    # 2. per-chunk end states
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)  # (B, H, C, S)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          bs * decay_states.permute(0, 2, 3, 1)[..., None], xs)

    # 3. inter-chunk recurrence over the chunks
    chunk_decay = torch.exp(a_cumsum[..., -1])  # (B, H, C)
    carry = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for i in range(c):
        prev.append(carry)  # the state *entering* chunk i
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (B, C, H, P, N)

    # 4. inter-chunk (off-diagonal) contribution
    state_decay = torch.exp(a_cumsum)  # (B, H, C, S)
    y_off = torch.einsum("bcshn,bchpn->bcshp", cs_, prev_states.to(x.dtype).float())
    y_off = y_off * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(b, t, h, p)
    return y.to(x.dtype), carry


def ssm_forward(params, cfg, x, initial_state=None, tp=None):
    """Full-sequence Mamba-2 mixer. x: (B, T, d_model) → (B, T, d_model).

    Returns (y, (final_state, conv_tail)) — the pieces a decode cache needs.
    Sequences that aren't a multiple of ``ssd_chunk`` are padded internally
    with dt=0 steps (identity recurrence), so the final state is exact.
    """
    d_in, nh, g, n, conv_dim = dims(cfg)
    bsz, t, _ = x.shape
    z, xb, bmat, cmat, dt = _split_proj(cfg, _in_proj(params, cfg, x, tp))
    conv_in = torch.cat([xb, bmat, cmat], dim=-1)
    # Exact conv tail for decode handoff: last (W-1) conv inputs, left-padded.
    w = cfg.conv_width
    tail_src = F.pad(conv_in, (0, 0, max(0, w - 1 - t), 0))
    conv_tail = (tail_src[:, tail_src.shape[1] - (w - 1):, :] if w > 1
                 else x.new_zeros((bsz, 0, conv_dim)))
    conv_out = F.silu(layers.causal_conv1d(params["conv"], conv_in))
    xb, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, T, nh)
    a_neg = -torch.exp(params["A_log"])  # (nh,)

    chunk = min(cfg.ssd_chunk, t)
    pad = (-t) % chunk
    if pad:
        # dt=0 ⇒ decay=1 and zero input: padded steps are identity updates.
        dt, xb, bmat, cmat = (F.pad(y, (0, 0, 0, pad)) for y in (dt, xb, bmat, cmat))
    t_pad = t + pad
    xh = xb.reshape(bsz, t_pad, nh, cfg.ssm_headdim)
    bm = bmat.reshape(bsz, t_pad, g, n)
    cm = cmat.reshape(bsz, t_pad, g, n)

    y, final_state = ssd_chunked(xh * dt[..., None].to(xh.dtype), dt * a_neg, bm, cm, chunk,
                                 initial_state)
    y = y + xh * params["D"][None, None, :, None].to(xh.dtype)
    y = y[:, :t].reshape(bsz, t, d_in) * F.silu(z)
    return _out_proj(params, cfg, y, tp), (final_state, conv_tail)


def init_ssm_cache(cfg, batch, dtype, device):
    d_in, nh, g, n, conv_dim = dims(cfg)
    return {
        "state": torch.zeros((batch, nh, cfg.ssm_headdim, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def ssm_decode_step(params, cfg, cache, x_t, tp=None):
    """One-token recurrence. x_t: (B, d_model) → (y (B, d_model), new cache)."""
    d_in, nh, g, n, conv_dim = dims(cfg)
    bsz = x_t.shape[0]
    z, xb, bmat, cmat, dt = _split_proj(cfg, _in_proj(params, cfg, x_t, tp))
    conv_in = torch.cat([xb, bmat, cmat], dim=-1)  # (B, conv_dim)
    new_conv, conv_out = layers.causal_conv1d_step(params["conv"], cache["conv"], conv_in)
    conv_out = F.silu(conv_out)
    xb, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, nh)
    a_neg = -torch.exp(params["A_log"])
    da = torch.exp(dt * a_neg)  # (B, nh)
    xh = xb.reshape(bsz, nh, cfg.ssm_headdim).float()
    bm = torch.repeat_interleave(bmat.reshape(bsz, g, n), nh // g, dim=1).float()
    cm = torch.repeat_interleave(cmat.reshape(bsz, g, n), nh // g, dim=1).float()

    # h <- h*exp(dt*A) + dt * x ⊗ B ;  y = <h, C> + D*x
    h = cache["state"] * da[..., None, None] + (dt[..., None] * xh)[..., None] * bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, cm) + xh * params["D"][None, :, None]
    y = y.reshape(bsz, d_in).to(x_t.dtype) * F.silu(z)
    return _out_proj(params, cfg, y, tp), {"state": h, "conv": new_conv}
