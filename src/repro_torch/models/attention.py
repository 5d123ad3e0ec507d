"""GQA attention: the port of the reference's ``models/attention.py``
(RoPE and M-RoPE, full-sequence attention, the ring-cache decode step).

Shapes: q (B, T, H, D); k/v (B, S, KV, D); query head h reads kv head
h // (H/KV), and k/v are never repeated to H heads.

Full-sequence attention (training / prefill) has three implementations:

  * ``naive``: full scores with grouped-query einsums, as the reference;
  * ``chunked``: the reference's memory-bounded online-softmax loop;
  * ``flash``: K4, the hand-written CUDA kernel
    (``kernels/flash_attention.py``); it computes causal self-attention
    with S == T and no window. On a CPU tensor its wrapper runs the
    kernel's plain version.

``impl="auto"`` picks by what the call computes and where its tensors lie:
a CUDA tensor with S == T and no window that masks a key (window 0, or a
window of at least T, as the hybrid family's serving prefill has at a
prompt no longer than its local window), from which no gradient is asked,
goes to ``flash`` (the function K4 computes, on the device it runs on);
anything else follows the reference's rule, ``naive`` if
T <= max(2048, attn_chunk) else ``chunked``. That is dispatch by function,
not a fallback: windowed attention has no TPU kernel either and runs plain
in the reference too, and K4, like the Pallas kernel, has no backward, so
training takes ``naive``/``chunked`` (``flash`` raises if asked for a
gradient).

Numbers differ by design between ``naive`` and ``flash`` in bfloat16: the
naive path rounds the QK^T einsum to bfloat16 before its float32 cast (as
the reference does), K4 computes its scores in float32.

The decode step keeps the reference's ring cache and writes the new
token's K/V into it in place (``index_copy_`` at a device-side slot), so a
step moves no cache and reads no position back to the host. The serving
engine's paged decode (``paged_decode_attention``) writes each slot's token
into its page of the pool in place and gathers the slot's pages in logical
order: plain torch, as the reference's is plain ``jnp`` (no Pallas kernel).

Tensor parallelism (``tp``, the model group, whose size m cuts ``wq``,
``wk``, ``wv`` by columns and ``wo`` by rows where their dims divide it):
when the kv heads divide m (and so the q heads: H is a multiple of KV),
each rank projects, rotates and attends its own H/m q and KV/m kv heads
(K4 at those heads on the card; the group size H/KV is unchanged) and its
slice of the output enters ``wo``'s rows, summed over the group. Otherwise
a cut falls inside a head: the split projections are gathered, every rank
runs every head, and ``wo`` takes its row slice of the whole output. The
ring cache holds the heads the rank attends (``kv_entry_spec``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as k4
from repro_torch.models import layers
from repro_torch.utils import collectives as col
from repro_torch.utils import scalar

NEG_INF = -1e30


def init_attention(gen, cfg, d_model=None):
    d_model = d_model or cfg.d_model
    dtype = layers.dtype_of(cfg.param_dtype)
    p = {
        "wq": layers.dense_init(gen, d_model, cfg.q_dim, dtype),
        "wk": layers.dense_init(gen, d_model, cfg.kv_dim, dtype),
        "wv": layers.dense_init(gen, d_model, cfg.kv_dim, dtype),
        "wo": layers.dense_init(gen, cfg.q_dim, d_model, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def local_heads(params, cfg, tp) -> bool:
    """Whether each rank of the model group ``tp`` attends its own heads:
    the rank's ``wk`` is cut on kv-head boundaries (the kv heads divide the
    group, and then the q heads do too). A cut is read from the leaf's
    shape, as everywhere in the port."""
    n = params["wk"].shape[-1]
    return tp is not None and n != cfg.kv_dim and n % cfg.head_dim == 0


def _project_qkv(params, cfg, x, tp=None):
    """q (B, T, H', D), k and v (B, T, KV', D): every head, or under
    ``local_heads`` the rank's H/m and KV/m."""
    b, t, _ = x.shape
    if tp is None:
        q = x @ params["wq"]
        k = x @ params["wk"]
        v = x @ params["wv"]
        if cfg.qkv_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    else:
        local = local_heads(params, cfg, tp)
        xin = col.copy_to(x, tp)
        out = []
        for w, bias, full in (("wq", "bq", cfg.q_dim), ("wk", "bk", cfg.kv_dim),
                              ("wv", "bv", cfg.kv_dim)):
            split = params[w].shape[-1] != full
            y = (xin if split else x) @ params[w]
            if split and not local:
                y = col.gather_from(y, tp, -1)
            if cfg.qkv_bias:
                y = y + (col.slice_to(params[bias], tp, -1) if local else params[bias])
            out.append(y)
        q, k, v = out
    q = q.reshape(b, t, -1, cfg.head_dim)
    k = k.reshape(b, t, -1, cfg.head_dim)
    v = v.reshape(b, t, -1, cfg.head_dim)
    return q, k, v


def _out_proj(params, cfg, out, tp=None):
    """``out`` (..., heads · D) through ``wo``: whole, or under ``tp`` the
    rank's rows (its slice of a whole ``out``, or its own heads), summed
    over the group."""
    wo = params["wo"]
    if tp is None or wo.shape[-2] == cfg.q_dim:
        return out @ wo
    if out.shape[-1] == cfg.q_dim:
        out = col.slice_to(out, tp, -1)
    return col.reduce_from(out @ wo, tp)


def _positions(cfg, b, t, positions, device):
    if positions is None:
        positions = torch.arange(t, device=device).expand(b, t)
    return positions


def _rope_q_k(cfg, q, k, positions, mrope_positions=None):
    if cfg.mrope:
        if mrope_positions is None:
            raise ValueError("mrope requires (3, B, T) position ids")
        q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def naive_causal_attention(q, k, v, *, window: int = 0):
    """Reference full-scores attention with grouped-query einsums; queries
    are right-aligned against the keys (position s - t + i)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d**-0.5
    qg = q.reshape(b, t, kv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    qpos = torch.arange(t, device=q.device)[:, None] + (s - t)
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, d)


def chunked_causal_attention(q, k, v, *, chunk: int, window: int = 0,
                             inner_remat: bool = False):
    """Memory-bounded causal self-attention (S == T) with an online softmax
    over ``chunk``-sized kv blocks; query chunk i visits only the kv chunks
    in its causal (and window) footprint, as the reference's scan does.
    ``inner_remat`` checkpoints each kv block's body, as the reference's
    ``jax.checkpoint(kv_body)`` does (under plain autograd only,
    ``layers.remat_active``)."""
    b, t, h, d = q.shape
    if k.shape[1] != t:
        raise ValueError("chunked path assumes self-attention (S == T)")
    if t % chunk != 0:
        raise ValueError(f"seq_len {t} must be a multiple of attn_chunk {chunk}")
    n = t // chunk
    kv = k.shape[2]
    g = h // kv
    scale = d**-0.5
    qc = q.reshape(b, n, chunk, kv, g, d)
    kc = k.reshape(b, n, chunk, kv, d)
    vc = v.reshape(b, n, chunk, kv, d)
    win_chunks = -(-window // chunk) if window > 0 else n
    ar = torch.arange(chunk, device=q.device)

    outs = []
    for i in range(n):
        qi = qc[:, i] * scale  # (B, C, KV, G, D)
        j_lo = max(0, i - win_chunks) if window > 0 else 0
        qpos = i * chunk + ar[:, None]
        acc = torch.zeros((b, kv, g, chunk, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, kv, g, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, chunk), dtype=torch.float32, device=q.device)
        for j in range(j_lo, i + 1):
            args = (acc, m, l, qi, kc[:, j], vc[:, j], j * chunk + ar[None, :], qpos, window)
            if inner_remat:
                acc, m, l = checkpoint(_kv_body, *args, use_reentrant=False)
            else:
                acc, m, l = _kv_body(*args)
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        # (B, KV, G, C, D) -> (B, C, KV, G, D) -> (B, C, H, D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)


def _kv_body(acc, m, l, qi, kj, vj, kpos, qpos, window):
    """One kv block of the online softmax -> the new (acc, m, l)."""
    s_ij = torch.einsum("bqkgd,bckd->bkgqc", qi, kj).float()
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s_ij = s_ij.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s_ij.amax(dim=-1))
    p = torch.exp(s_ij - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgqc,bckd->bkgqd", p.to(vj.dtype), vj).float()
    return acc, m_new, l


def covers(window: int, t: int) -> bool:
    """True when a causal window of ``window`` keys masks nothing in a
    self-attention over ``t`` tokens (0 is no window): query i keeps keys
    (i - window, i], which holds every key 0..i once window >= t."""
    return window == 0 or window >= t


def resolve_impl(impl: str, cfg, q, k, v, window: int) -> str:
    """The implementation ``impl="auto"`` stands for (module docstring)."""
    if impl != "auto":
        return impl
    t = q.shape[1]
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if q.is_cuda and covers(window, t) and k.shape[1] == t and not grad:
        return "flash"
    return "naive" if t <= max(2048, cfg.attn_chunk) else "chunked"


def attention(params, cfg, x, *, positions=None, mrope_positions=None,
              window: int | None = None, impl: str = "auto", tp=None):
    """Full-sequence self-attention (training / prefill). Returns (out, (k, v));
    ``tp`` as in the module docstring."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, tp)
    positions = _positions(cfg, b, t, positions, x.device)
    q, k = _rope_q_k(cfg, q, k, positions, mrope_positions)
    window = cfg.sliding_window if window is None else window
    impl = resolve_impl(impl, cfg, q, k, v, window)
    if impl == "naive":
        out = naive_causal_attention(q, k, v, window=window)
    elif impl == "chunked":
        out = chunked_causal_attention(
            q, k, v, chunk=cfg.attn_chunk, window=window,
            inner_remat=cfg.attn_inner_remat and layers.remat_active(q))
    elif impl == "flash":
        if not covers(window, t):
            raise ValueError(f"impl='flash' computes unwindowed attention; window {window} "
                             f"below the {t} tokens needs 'naive' or 'chunked'")
        out = k4.flash_attention(q, k, v, causal=True)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return _out_proj(params, cfg, out.reshape(b, t, -1), tp), (k, v)


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch, cache_len, dtype, device):
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(params, cfg, entry, x_t, pos, *, tables, codec,
                           window: int | None = None, tp=None):
    """One-token decode against a block-allocated paged KV pool.

    ``entry`` is one layer's pool entry (``codec``-owned dict: ``k``/``v``
    pages shaped (num_pages, page_size, KV, D) plus scales for quantised
    codecs); ``pos`` is the per-slot write position (S,), an integer tensor
    on x_t's device: token ``pos[i]`` of slot ``i`` lands at page
    ``tables[i, pos[i] // page_size]``, offset ``pos[i] % page_size``.
    ``tables`` (S, P) maps each slot's logical pages to physical pool pages;
    pages beyond a slot's allocation point at the reserved scratch page 0,
    whose (finite) content is always masked out.

    The score, mask, softmax and weighted sum are ``decode_attention``'s
    operations in the same order: under the ``float32`` codec the gathered
    pages hold exactly the ring cache's bytes, masked positions are exact
    zeros of the softmax, and the step is bitwise the fixed-batch one at the
    same extent (P·page_size keys). The new token's K/V are written into
    ``entry`` in place. ``tp`` as in ``decode_attention``: the pool holds
    the kv heads the rank attends (its own where they divide the model
    group, ``sharding.pool_specs``; every one where the projections are
    gathered). Returns (out (S, d_model), entry).
    """
    b = x_t.shape[0]
    window = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(params, cfg, x_t[:, None, :], tp)
    pos = torch.as_tensor(pos, device=x_t.device)
    pos_b = pos[:, None]  # (S, 1): per-slot absolute positions
    q, k = _rope_q_k(cfg, q, k, pos_b)

    page_size = entry["k"].shape[1]
    page = pos // page_size
    offset = pos % page_size
    phys = torch.gather(tables, 1, page[:, None])[:, 0]
    entry = codec.write_token(entry, k[:, 0], v[:, 0], phys, offset)
    # (S, L, KV, D) with L = pages_per_slot · page_size, logical order
    k_all, v_all = codec.gather(entry, tables)

    kv = k.shape[2]
    g = q.shape[2] // kv
    qg = q.reshape(b, 1, kv, g, cfg.head_dim)
    scale = cfg.head_dim**-0.5
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_all).float() * scale

    # Paged slots are in logical order (no ring wrap): slot s of the
    # gathered view holds position s, valid iff s is in (pos - window, pos].
    logical = torch.arange(k_all.shape[1], device=x_t.device)[None, :]  # (1, L)
    valid = logical <= pos_b
    if window > 0:
        valid &= logical > pos_b - window
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_all)
    return _out_proj(params, cfg, out.reshape(b, -1), tp), entry


def decode_attention(params, cfg, cache, x_t, pos, *, window: int | None = None,
                     mrope_positions=None, tp=None):
    """One-token decode. x_t: (B, d_model); pos: the new token's absolute
    position, a Python int or a 0-dim integer tensor (on x_t's device, so
    no host sync). The cache is a ring buffer of length ``cache_len``; the
    new K/V are written into ``cache`` in place. M-RoPE (the vlm family)
    takes ``mrope_positions`` (3, B, 1), by default ``pos`` on all three
    axes; ``tp`` as in the module docstring (the cache holds the heads the
    rank attends). Returns (out (B, d_model), cache)."""
    b = x_t.shape[0]
    window = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(params, cfg, x_t[:, None, :], tp)
    pos = scalar(pos, x_t.device, torch.int64)
    if pos.dim() != 0:
        raise ValueError(f"decode position must be a scalar, got shape {tuple(pos.shape)}")
    pos_b = pos.expand(b)[:, None]  # (B, 1)
    if cfg.mrope and mrope_positions is None:
        mrope_positions = pos_b.expand(3, b, 1)
    q, k = _rope_q_k(cfg, q, k, pos_b, mrope_positions)

    k_cache, v_cache = cache["k"], cache["v"]
    cache_len = k_cache.shape[1]
    slot = pos % cache_len
    k_cache.index_copy_(1, slot.reshape(1), k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot.reshape(1), v.to(v_cache.dtype))

    kv = k.shape[2]
    g = q.shape[2] // kv
    qg = q.reshape(b, 1, kv, g, cfg.head_dim)
    scale = cfg.head_dim**-0.5
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache).float() * scale

    # Valid slots: the ring has wrapped pos // cache_len times, so slot s
    # holds logical position wrapped·L + s if s <= slot, else one lap less;
    # a slot is valid iff that position is in (pos - window, pos].
    slots = torch.arange(cache_len, device=x_t.device)
    wrapped = pos // cache_len
    logical = torch.where(slots <= slot, wrapped * cache_len + slots,
                          (wrapped - 1) * cache_len + slots)
    valid = (logical >= 0) & (logical <= pos)
    if window > 0:
        valid &= logical > pos - window
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_cache)
    return _out_proj(params, cfg, out.reshape(b, -1), tp), cache
