"""Plain PyTorch versions of the port's CUDA kernels.

The kernel wrappers take these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel to its plain version on the card.

The compression kernels (``csrc/gmf_compress.cu``) are the same functions
as the reference's ``kernels/ref.py`` oracles, in its dtypes: float32 or
bfloat16 operands, each op rounded to the dtype jnp gives it (a weakly
typed scalar rounds to the array's dtype first). Leaves are ``[k, ...]``
client stacks; per-client scalars are ``[k]`` tensors (or 0-dim for one
shared value). The state is flat (``utils/flat.py``): ``gmf_select`` and
``gmf_compress_segments`` take ``[k, N]`` stacks and their layout, with
per-segment scalars ``[k, L]``; they loop over the leaves on views, which
is what the CPU runs. The plain version of ``gmf_select``'s |z| mode is
``core.sparsify.segment_topk_mask`` (``segment_topk_mask_keep`` with a
per-row keep table).

K4, flash attention (``csrc/flash_attention.cu``): the Pallas kernel's
arithmetic over k/v tiles, in the same online softmax.
"""

from __future__ import annotations

import torch

from repro_torch.core import fusion, sparsify
from repro_torch.core.fusion import rows
from repro_torch.utils import tree_multimap, weak


def momentum_correction_leaf(u, v, g, alpha, out_dtype=None):
    """DGC momentum correction:  U <- alpha*U + g ;  V <- V + U, each op
    rounded as jnp rounds it: alpha to u's dtype (a weak scalar), alpha*U
    to u's dtype, the sums to the promotion of u's and g's. ``out_dtype``
    (u's dtype) casts both results at the end, as the Pallas kernel
    stores them."""
    u_new = weak(alpha, u.dtype) * u + g
    v_new = v + u_new
    if out_dtype is not None:
        u_new, v_new = u_new.to(out_dtype), v_new.to(out_dtype)
    return u_new, v_new


def apply_mask_update_leaf(u, v, mask):
    """G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask), in the promotion of
    the state's dtype and the mask's."""
    g_out = v * mask
    keep = 1.0 - mask
    return g_out, u * keep, v * keep


def gmf_fusion_score(v, m, *, inv_norm_v, inv_norm_m, tau):
    """Z = |((1-tau)*V)*inv_norm_v + (tau*M)*inv_norm_m|, in this association.

    The fused path computes its top-k threshold from this Z outside the
    kernel, so the kernel must reproduce it bitwise: same order, no fused
    multiply-add."""
    t = rows(tau, v)
    return (((1.0 - t) * v.float()) * rows(inv_norm_v, v)
            + (t * m.float()) * rows(inv_norm_m, v)).abs()


def gmf_compress_leaf(u, v, m, *, inv_norm_v, inv_norm_m, tau, threshold):
    """Fused GMF score + mask + memory update -> (G, U', V', mask)."""
    z = gmf_fusion_score(v, m, inv_norm_v=inv_norm_v, inv_norm_m=inv_norm_m, tau=tau)
    mask = (z >= rows(threshold, v)).to(v.dtype)
    g_out = v * mask
    keep = 1.0 - mask
    return g_out, u * keep, v * keep, mask


def gmf_select(v, m, layout, rate=None, *, keep=None, w, tau, eps):
    """The glue that feeds K1, per (client, leaf) segment of the flat
    ``[k, N]`` stacks v and m: inv_nv = w / (‖V‖ + eps), inv_nm =
    1 / (‖M‖ + eps), and the exact k_i-th largest fusion score as the
    threshold -> (inv_nv, inv_nm, thr), ``[k, L]`` each. ``w`` and ``tau``
    are ``[k]``; k_i comes from ``rate`` or from a per-row keep table
    ``keep`` (int64 ``[k, L]``)."""
    inv_nv = rows(w, v) / (fusion.segment_norms(v, layout) + eps)
    inv_nm = 1.0 / (fusion.segment_norms(m, layout) + eps)
    z = gmf_fusion_score(v, m, inv_norm_v=layout.expand(inv_nv),
                         inv_norm_m=layout.expand(inv_nm), tau=tau)
    if keep is None:
        return inv_nv, inv_nm, sparsify.segment_thresholds(z, layout, rate)
    return inv_nv, inv_nm, sparsify.segment_keep_thresholds(z, layout, keep)


def gmf_compress_segments(u, v, m, *, layout, inv_norm_v, inv_norm_m, tau, threshold):
    """``gmf_compress_leaf`` over flat ``[k, N]`` stacks with ``[k, L]``
    per-segment scalars and ``[k]`` τ -> (G, U', V', mask)."""
    ex = layout.expand
    return gmf_compress_leaf(u, v, m, inv_norm_v=ex(inv_norm_v), inv_norm_m=ex(inv_norm_m),
                             tau=tau, threshold=ex(threshold))


def momentum_correction(u_tree, v_tree, g_tree, alpha, state_dtype=False):
    return tree_multimap(
        lambda u, v, g: momentum_correction_leaf(u, v, g, alpha,
                                                 u.dtype if state_dtype else None),
        2, u_tree, v_tree, g_tree)


def apply_mask_update(u_tree, v_tree, mask_tree):
    return tree_multimap(apply_mask_update_leaf, 3, u_tree, v_tree, mask_tree)


NEG_INF = -1e30
# Keys per k/v tile: ``BK`` of csrc/flash_attention.cu, whose summation
# order the plain version follows.
BK = 64


def flash_attention_bhsd(q, k, v, *, causal=True):
    """q: (BH, T, D); k/v: (BKV, S, D), query head i reading kv head i // G.

    The Pallas ``_flash_kernel``'s arithmetic over ``BK``-key tiles:
    q and k in float32 with q scaled by D^-0.5 first; causal keys with
    kpos > qpos (both from 0) at -1e30; running max m and sum l in float32;
    p rounded to v's dtype before the PV product, which is accumulated in
    float32; out = acc / max(l, 1e-30) in q's dtype. Tiles wholly above the
    diagonal are skipped, as the kernels skip them."""
    bh, t, d = q.shape
    bkv, s, _ = k.shape
    g = bh // bkv
    qf = (q.float() * d**-0.5).reshape(bkv, g, t, d)
    m = torch.full((bkv, g, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bkv, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bkv, g, t, d), dtype=torch.float32, device=q.device)
    qpos = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, s, BK):
        if causal and k0 > t - 1:
            break
        kj, vj = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        sc = torch.einsum("bgtd,bcd->bgtc", qf, kj.float())
        if causal:
            kpos = torch.arange(k0, k0 + kj.shape[1], device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgtc,bcd->bgtd", p.to(v.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(bh, t, d)


def flash_attention(q, k, v, *, causal=True):
    """q: (B, T, H, D); k/v: (B, S, KV, D) -> (B, T, H, D)."""
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    qf = q.transpose(1, 2).reshape(b * h, t, d)
    kf = k.transpose(1, 2).reshape(b * kv, s, d)
    vf = v.transpose(1, 2).reshape(b * kv, s, d)
    out = flash_attention_bhsd(qf, kf, vf, causal=causal)
    return out.reshape(b, h, t, d).transpose(1, 2)
