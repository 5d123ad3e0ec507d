"""Decoder-only backbone: the port of the reference's
``models/transformer.py`` for the dense family ("attn" blocks with the
SwiGLU FFN).

Params keep the reference's tree, so JAX weights carry across leaf for
leaf (``utils.convert``): per position in the layer pattern, a dict of
tensors stacked over ``n_groups`` repetitions (``"layers"``, a tuple),
plus a tuple of unstacked tail blocks (``"tail"``). The reference scans
the groups; the port walks them in a Python loop, indexing each stacked
leaf. The decode cache has the same structure.

Three entry points used by the runtime:
  forward(cfg, params, batch)            — training / prefill (optionally
                                           returning a decode cache)
  init_cache(cfg, batch, cache_len)      — empty decode cache
  decode_step(cfg, params, cache, ...)   — one token against the cache,
                                           written into it in place

The moe, vlm, audio, hybrid (RG-LRU) and ssm families raise
``NotImplementedError`` naming ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention, layers
from repro_torch.utils import tree_map

_UNPORTED = "ROADMAP Queue 1 item 6"


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.num_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet: {_UNPORTED}")


# ---------------------------------------------------------------------------
# Pattern bookkeeping
# ---------------------------------------------------------------------------


def pattern_info(cfg):
    """(pattern, n_groups, tail_types): stacked groups + unstacked remainder."""
    types = cfg.layer_types
    pattern = tuple(cfg.block_pattern) if cfg.family == "hybrid" else (types[0],)
    period = len(pattern)
    n_groups = cfg.num_layers // period
    tail = types[n_groups * period:]
    return pattern, n_groups, tail


def _attn_only(block_type) -> None:
    if block_type != "attn":
        raise NotImplementedError(f"{block_type!r} blocks are not ported yet: {_UNPORTED}")


def _group(stacked, i):
    """Layer ``i`` of a stacked param (or cache) dict: views, no copy."""
    return tree_map(lambda a: a[i], stacked)


def _stack(dicts):
    return tree_map(lambda *xs: torch.stack(xs), *dicts)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(gen, cfg, block_type):
    _attn_only(block_type)
    _check_family(cfg)
    dtype = layers.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "norm1": layers.init_rmsnorm(d, dtype, gen.device),
        "attn": attention.init_attention(gen, cfg),
        "norm2": layers.init_rmsnorm(d, dtype, gen.device),
        "mlp": layers.init_mlp(gen, d, cfg.d_ff, dtype),
    }


def block_forward(params, cfg, block_type, x, ctx):
    """Returns (x, aux_loss, cache_entry|{}) for one block."""
    _attn_only(block_type)
    eps = cfg.norm_eps
    window = ctx.get("window", cfg.sliding_window)
    h, (k, v) = attention.attention(
        params["attn"],
        cfg,
        layers.rmsnorm(params["norm1"], x, eps),
        positions=ctx.get("positions"),
        window=window,
        impl=ctx.get("attn_impl", "auto"),
    )
    x = x + h
    x = x + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x, eps))
    cache = _kv_to_cache(cfg, k, v, ctx, window) if ctx.get("want_cache", False) else {}
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def _kv_to_cache(cfg, k, v, ctx, window):
    """Pack the last ``cache_len`` keys/values into the ring-cache layout
    (token j lives at slot j % cache_len)."""
    cache_len = ctx["cache_len"]
    if window > 0:
        cache_len = min(cache_len, window)
    t = k.shape[1]
    if t >= cache_len:
        # The last cache_len tokens, rotated so token j sits at j % L.
        shift = t % cache_len
        k_c = torch.roll(k[:, t - cache_len:], shift, dims=1)
        v_c = torch.roll(v[:, t - cache_len:], shift, dims=1)
    else:
        # Right-padded: the next write lands at slot t, as the ring expects.
        pad = cache_len - t
        k_c = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_c = F.pad(v, (0, 0, 0, 0, 0, pad))
    dtype = layers.dtype_of(ctx.get("cache_dtype", cfg.dtype))
    return {"k": k_c.to(dtype), "v": v_c.to(dtype)}


def block_decode(params, cfg, block_type, cache, x_t, pos, ctx):
    """One-token decode through a block. x_t: (B, d). Returns (x, cache)."""
    _attn_only(block_type)
    if ctx.get("paged") is not None:
        attention.paged_decode_attention()
    eps = cfg.norm_eps
    h, cache = attention.decode_attention(
        params["attn"],
        cfg,
        cache,
        layers.rmsnorm(params["norm1"], x_t, eps),
        pos,
        window=ctx.get("window", cfg.sliding_window),
    )
    x_t = x_t + h
    x_t = x_t + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x_t, eps))
    return x_t, cache


def init_block_cache(cfg, block_type, batch, cache_len, dtype, device):
    _attn_only(block_type)
    window = cfg.sliding_window
    length = min(cache_len, window) if window > 0 else cache_len
    return attention.init_kv_cache(cfg, batch, length, dtype, device)


# ---------------------------------------------------------------------------
# Model init / embedding
# ---------------------------------------------------------------------------


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    _check_family(cfg)
    dtype = layers.dtype_of(cfg.param_dtype)
    pattern, n_groups, tail = pattern_info(cfg)
    embed_p = layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    unembed_p = ({} if cfg.tie_embeddings
                 else layers.init_unembed(gen, cfg.d_model, cfg.vocab_size, dtype))
    stacked = tuple(_stack([init_block(gen, cfg, bt) for _ in range(n_groups)])
                    for bt in pattern) if n_groups > 0 else ()
    return {
        "embed": embed_p,
        "unembed": unembed_p,
        "layers": stacked,
        "tail": tuple(init_block(gen, cfg, bt) for bt in tail),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, gen.device),
    }


def embed_inputs(cfg, params, batch):
    """Returns (x (B,T,d), ctx-extras dict)."""
    _check_family(cfg)
    x = layers.embed(params["embed"], batch["tokens"])
    return x.to(layers.dtype_of(cfg.dtype)), {}


def unembed_logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return layers.unembed(params["unembed"], x)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def forward(cfg, params, batch, *, ctx=None):
    """Full-sequence forward. Returns (logits, aux_loss, cache|None).

    ctx keys: attn_impl, want_cache, cache_len, cache_dtype, positions,
    window, last_only, last_index.
    """
    ctx = dict(ctx or {})
    x, extras = embed_inputs(cfg, params, batch)
    ctx.update(extras)
    pattern, n_groups, tail = pattern_info(cfg)
    want_cache = ctx.get("want_cache", False)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_pos = [[] for _ in pattern]
    for i in range(n_groups):
        for p_idx, bt in enumerate(pattern):
            x, a, c = block_forward(_group(params["layers"][p_idx], i), cfg, bt, x, ctx)
            aux = aux + a
            per_pos[p_idx].append(c)
    group_caches = tuple(_stack(cs) if want_cache else {} for cs in per_pos) \
        if n_groups > 0 else ()
    tail_caches = []
    for tp, bt in zip(params["tail"], tail, strict=True):
        x, a, c = block_forward(tp, cfg, bt, x, ctx)
        aux = aux + a
        tail_caches.append(c)

    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if ctx.get("last_only", False):
        # Serving prefill: only the final position's logits are needed, so
        # the hidden state is sliced before the unembedding and the
        # (B, T, V) logits are never built. ``last_index`` (B,) picks each
        # sequence's true last prompt token under right padding.
        last_index = ctx.get("last_index")
        if last_index is not None:
            idx = torch.as_tensor(last_index, device=x.device).reshape(-1, 1, 1)
            x = torch.take_along_dim(x, idx, dim=1)
        else:
            x = x[:, -1:, :]
    logits = unembed_logits(cfg, params, x)
    cache = {"groups": group_caches, "tail": tuple(tail_caches)} if want_cache else None
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, cache_len, dtype=None, *, device):
    _check_family(cfg)
    dtype = layers.dtype_of(dtype or cfg.dtype)
    pattern, n_groups, tail = pattern_info(cfg)
    groups = tuple(
        _stack([init_block_cache(cfg, bt, batch, cache_len, dtype, device)] * n_groups)
        for bt in pattern) if n_groups > 0 else ()
    return {
        "groups": groups,
        "tail": tuple(init_block_cache(cfg, bt, batch, cache_len, dtype, device)
                      for bt in tail),
    }


def decode_step(cfg, params, cache, tokens, pos, *, ctx=None):
    """One decode step. tokens: (B,) integer; pos: the absolute position
    (int or 0-dim tensor). The cache is updated in place. Returns
    (logits (B, V), cache)."""
    ctx = dict(ctx or {})
    _check_family(cfg)
    x = layers.embed(params["embed"], tokens).to(layers.dtype_of(cfg.dtype))
    pattern, n_groups, tail = pattern_info(cfg)
    for i in range(n_groups):
        for p_idx, bt in enumerate(pattern):
            x, _ = block_decode(_group(params["layers"][p_idx], i), cfg, bt,
                                _group(cache["groups"][p_idx], i), x, pos, ctx)
    for tp, bt, tc in zip(params["tail"], tail, cache["tail"], strict=True):
        x, _ = block_decode(tp, cfg, bt, tc, x, pos, ctx)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed_logits(cfg, params, x), cache
