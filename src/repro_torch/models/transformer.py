"""Decoder-only backbone for every family: the port of the reference's
``models/transformer.py``.

Families map to per-layer block types (``cfg.layer_types``):
  dense / moe / vlm / audio → "attn" blocks (FFN = SwiGLU or routed MoE)
  hybrid                     → pattern of "rec" (RG-LRU) and "attn" blocks
  ssm                        → "ssm" (Mamba-2) blocks, no separate FFN

The audio family sums one embedding table per codebook and unembeds with
a ``(K, d, V)`` kernel (logits ``(B, K, T, V)``, decode tokens ``(B, K)``);
the vlm family prepends the batch's patch embeddings to the token
embeddings and rotates with M-RoPE, by default at positions 0..T-1 on all
three axes.

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

``cfg.remat`` checkpoints each layer group's forward as the reference's
``jax.checkpoint`` around its scan body does (``remat_policy="dots"``
keeps the matrix products), with ``torch.utils.checkpoint``: memory
changes, values do not. ``torch.func.grad`` does not take the saved-tensor
hooks that checkpointing needs, so remat is honoured under plain autograd
(the one-device trainer, ``dist/step.py``) and skipped inside a
``torch.func`` transform (the FL engines' ``vmap(grad)``), where it
computes the same values without the memory saving.

``decode_step`` also runs against the serving engine's paged KV pool
(``serve/cache.py:init_pool``, the same structure) when ``ctx["paged"]``
holds the block ``tables`` and the ``codec``; ``pos`` is then the per-slot
(S,) position.

Over a mesh (``ctx["mesh"]``, set by ``dist/step.py:_model_ctx``) an MoE
config with ``moe_impl="ep"`` runs ``moe.moe_ep`` on the rank's local
tokens, as the reference does; at a ``model`` axis over 1 the tokens
reach it replicated over the model group (``moe_ep(..., tp=...)``).

FSDP: ``ctx["fsdp"]`` (an ``FsdpCtx``, set by ``_model_ctx`` for the
>40 B archs on a ``data`` axis over 1) holds the data group and each
leaf's dim cut over it. A layer's pieces are gathered just before the
layer runs, the embedding before the lookup and the unembedding before
the logits (``collectives.fsdp_gather``); the blocks see the leaves as
tensor parallelism alone would cut them. Under ``cfg.remat`` the gather
runs inside the layer group's checkpoint, so the backward gathers the
group again and a training step holds one group's whole leaves at a time,
as the reference's checkpointed scan does; without remat autograd keeps
each gathered leaf for the backward, as it keeps the activations. The expert leaves are left to
``moe_ep`` where it runs, which gathers them itself.

Tensor parallelism: ``ctx["tp"]`` (the mesh's model group, set by
``_model_ctx`` when the model axis is over 1) with params that are the
rank's pieces by the reference's ``_TP_RULES`` (``dist/sharding.py``;
``local_tree``). Each module uses a leaf whole where its dim does not
divide the group and its piece where it does: column-parallel products on
the replicated activation (``collectives.copy_to``), row-parallel ones
summed over the group (``reduce_from``), a vocabulary-parallel embedding
(one nonzero term a token, exact). The logits stay cut over the
vocabulary where the vocabulary divides the group: ``forward`` and
``decode_step`` return the rank's columns, which the loss takes as they
are and the serving steps gather (``dist/step.py``).
``abstract_params(cfg)`` is the meta-device params tree, the counterpart of
``jax.eval_shape(init_params)``: shapes and dtypes, no draw.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.utils import collectives as col
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

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


def _group(stacked, i):
    """Layer ``i`` of a stacked param (or cache) dict: views, no copy."""
    return tree_map(lambda a: a[i], stacked)


def _stack(dicts):
    return tree_map(lambda *xs: torch.stack(xs), *dicts)


def _init_stacked(n, make):
    """``n`` trees from ``make()`` stacked leafwise, built in place: the peak
    is the stack plus one tree (``torch.stack`` of n trees would hold two
    stacks' worth). One tree is stacked as views."""
    first = make()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), first)
    leaves = [torch.empty((n, *a.shape), dtype=a.dtype, device=a.device)
              for a in tree_leaves(first)]
    for i in range(n):
        for out, a in zip(leaves, tree_leaves(first if i == 0 else make()), strict=True):
            out[i].copy_(a)
    return tree_unflatten(first, leaves)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _write(cache, new):
    """Write a block's new recurrent cache into ``cache`` in place (it may
    be a view into the stacked group cache)."""
    for key, val in new.items():
        cache[key].copy_(val)


# ---------------------------------------------------------------------------
# FSDP: a layer's pieces gathered at its use
# ---------------------------------------------------------------------------


class FsdpCtx(NamedTuple):
    """FSDP in a forward: ``group`` the data group the pieces are cut over,
    ``dims`` a tree mirroring the params (each leaf's dim cut over the
    group, counted from the right, or None), ``sink`` None (the ranks'
    gradients are shares of one loss) or a dict (each rank its own client:
    ``collectives.fsdp_gather``, keyed by (id of the param leaf, layer))."""

    group: Any
    dims: Any
    sink: dict | None = None


def _whole(tree, dims, fs, i=None):
    """``tree``'s leaves (layer ``i`` of each stacked leaf, or the leaves
    themselves) with their FSDP pieces gathered over ``fs.group``."""
    out = {}
    for k, a in tree.items():
        d = dims.get(k) if dims is not None else None
        if isinstance(a, dict):
            out[k] = _whole(a, d, fs, i)
            continue
        x = a if i is None else a[i]
        if d is not None:
            x = col.fsdp_gather(x, fs.group, d, fs.sink, (id(a), i))
        out[k] = x
    return out


def _edge(params, name, fs):
    """``params[name]`` (the embedding or the unembedding), gathered under
    FSDP."""
    if fs is None or not params[name]:
        return params[name]
    return _whole(params[name], fs.dims[name], fs)


def _layer(params, p_idx, i, fs):
    """Layer ``i`` of pattern position ``p_idx``: views of the stacked
    leaves, gathered under FSDP."""
    if fs is None:
        return _group(params["layers"][p_idx], i)
    return _whole(params["layers"][p_idx], fs.dims["layers"][p_idx], fs, i)


def _tail(params, t, fs):
    if fs is None:
        return params["tail"][t]
    return _whole(params["tail"][t], fs.dims["tail"][t], fs)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _uses_moe(cfg):
    return cfg.num_experts > 0


def init_block(gen, cfg, block_type):
    dtype = layers.dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    if block_type == "attn":
        p = {
            "norm1": layers.init_rmsnorm(d, dtype, dev),
            "attn": attention.init_attention(gen, cfg),
            "norm2": layers.init_rmsnorm(d, dtype, dev),
        }
        if _uses_moe(cfg):
            p["moe"] = moe.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, dtype)
        return p
    if block_type == "rec":
        return {
            "norm1": layers.init_rmsnorm(d, dtype, dev),
            "rec": rglru.init_rglru_block(gen, cfg, dtype),
            "norm2": layers.init_rmsnorm(d, dtype, dev),
            "mlp": layers.init_mlp(gen, d, cfg.d_ff, dtype),
        }
    if block_type == "ssm":
        return {
            "norm1": layers.init_rmsnorm(d, dtype, dev),
            "ssm": ssm.init_ssm(gen, cfg, dtype),
        }
    raise ValueError(block_type)


def tp_over(ctx, leaf, whole: int, dim: int = -1):
    """The model group of ``ctx`` when ``leaf``'s ``dim`` is cut over it
    (shorter than the model's ``whole``), else None. A cut is read from the
    leaf's shape, as everywhere in the port (the specs decide which leaves
    are cut)."""
    tp = ctx.get("tp")
    return tp if tp is not None and leaf.shape[dim] != whole else None


def _vocab_tp(cfg, params, ctx):
    """The model group when the vocabulary is cut over it (the embedding
    table's vocabulary dim: audio's tables are (K, V, d)), else None."""
    return tp_over(ctx, params["embed"]["table"], cfg.vocab_size,
                   1 if cfg.family == "audio" else 0)


def _ffn(params, cfg, x, ctx):
    """FFN half of an attn block: SwiGLU or routed MoE. Returns (y, aux)."""
    if _uses_moe(cfg):
        if ctx.get("moe_impl", cfg.moe_impl) == "ep" and ctx.get("mesh") is not None:
            return moe.moe_ep(
                params["moe"],
                cfg,
                x,
                mesh=ctx["mesh"],
                data_axes=ctx["data_axes"],
                model_axis=ctx["model_axis"],
                fsdp_weights=ctx.get("fsdp_moe", False),
                already_manual=ctx.get("already_manual", frozenset()),
                tp=ctx.get("tp"),
            )
        return moe.moe_dense(params["moe"], cfg, x, ctx.get("token_groups", ()),
                             tp=tp_over(ctx, params["moe"]["w_gate"], cfg.num_experts, 0))
    tp = tp_over(ctx, params["mlp"]["gate"], cfg.d_ff)
    return layers.mlp(params["mlp"], x, tp), _zero(x)


def block_forward(params, cfg, block_type, x, ctx):
    """Returns (x, aux_loss, cache_entry|{}) for one block."""
    eps = cfg.norm_eps
    want_cache = ctx.get("want_cache", False)
    if block_type == "attn":
        window = ctx.get("window", cfg.sliding_window)
        h, (k, v) = attention.attention(
            params["attn"],
            cfg,
            layers.rmsnorm(params["norm1"], x, eps),
            positions=ctx.get("positions"),
            mrope_positions=ctx.get("mrope_positions"),
            window=window,
            impl=ctx.get("attn_impl", "auto"),
            tp=ctx.get("tp"),
        )
        x = x + h
        y, aux = _ffn(params, cfg, layers.rmsnorm(params["norm2"], x, eps), ctx)
        x = x + y
        cache = _kv_to_cache(cfg, k, v, ctx, window) if want_cache else {}
        return x, aux, cache
    if block_type == "rec":
        y, (h_last, conv_tail) = rglru.rglru_block_forward(
            params["rec"], cfg, layers.rmsnorm(params["norm1"], x, eps),
            tp=tp_over(ctx, params["rec"]["gate_proj"], cfg.lru_width or cfg.d_model))
        x = x + y
        x = x + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x, eps),
                           tp_over(ctx, params["mlp"]["gate"], cfg.d_ff))
        cache = {"state": h_last, "conv": conv_tail} if want_cache else {}
        return x, _zero(x), cache
    if block_type == "ssm":
        y, (final_state, conv_tail) = ssm.ssm_forward(
            params["ssm"], cfg, layers.rmsnorm(params["norm1"], x, eps), tp=ctx.get("tp"))
        cache = {"state": final_state, "conv": conv_tail} if want_cache else {}
        return x + y, _zero(x), cache
    raise ValueError(block_type)


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
    """One-token decode through a block. x_t: (B, d). The cache is written
    in place. Returns (x, cache)."""
    eps = cfg.norm_eps
    if block_type == "attn":
        window = ctx.get("window", cfg.sliding_window)
        paged = ctx.get("paged")
        if paged is not None:
            # Serving tier: ``cache`` is one layer's paged-pool entry and
            # ``pos`` is the per-slot (S,) write position.
            h, cache = attention.paged_decode_attention(
                params["attn"],
                cfg,
                cache,
                layers.rmsnorm(params["norm1"], x_t, eps),
                pos,
                tables=paged["tables"],
                codec=paged["codec"],
                window=window,
                tp=ctx.get("tp"),
            )
        else:
            h, cache = attention.decode_attention(
                params["attn"],
                cfg,
                cache,
                layers.rmsnorm(params["norm1"], x_t, eps),
                pos,
                window=window,
                mrope_positions=ctx.get("mrope_positions"),
                tp=ctx.get("tp"),
            )
        x_t = x_t + h
        y, _ = _ffn(params, cfg, layers.rmsnorm(params["norm2"], x_t, eps)[:, None, :], ctx)
        return x_t + y[:, 0, :], cache
    if block_type == "rec":
        y, new = rglru.rglru_decode_step(params["rec"], cfg, cache,
                                         layers.rmsnorm(params["norm1"], x_t, eps),
                                         tp=tp_over(ctx, params["rec"]["gate_proj"],
                                                    cfg.lru_width or cfg.d_model))
        _write(cache, new)
        x_t = x_t + y
        x_t = x_t + layers.mlp(params["mlp"], layers.rmsnorm(params["norm2"], x_t, eps),
                               tp_over(ctx, params["mlp"]["gate"], cfg.d_ff))
        return x_t, cache
    if block_type == "ssm":
        y, new = ssm.ssm_decode_step(params["ssm"], cfg, cache,
                                     layers.rmsnorm(params["norm1"], x_t, eps),
                                     tp=ctx.get("tp"))
        _write(cache, new)
        return x_t + y, cache
    raise ValueError(block_type)


def init_block_cache(cfg, block_type, batch, cache_len, dtype, device):
    if block_type == "attn":
        window = cfg.sliding_window or (cfg.local_attn_window if cfg.family == "hybrid" else 0)
        length = min(cache_len, window) if window > 0 else cache_len
        return attention.init_kv_cache(cfg, batch, length, dtype, device)
    if block_type == "rec":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    if block_type == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device)
    raise ValueError(block_type)


# ---------------------------------------------------------------------------
# Model init / embedding
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A generator whose device is ``meta``: ``init_params`` then only
    shapes its leaves."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg):
    """The params tree of ``cfg`` on the meta device (shapes, dtypes)."""
    return init_params(cfg, _MetaGenerator())


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    dtype = layers.dtype_of(cfg.param_dtype)
    pattern, n_groups, tail = pattern_info(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        k = cfg.num_codebooks
        embed_p = {"table": _init_stacked(
            k, lambda: layers.init_embedding(gen, v, d, dtype)["table"])}  # (K, V, d)
        unembed_p = {"kernel": _init_stacked(
            k, lambda: layers.init_unembed(gen, d, v, dtype)["kernel"])}  # (K, d, V)
    else:
        embed_p = layers.init_embedding(gen, v, d, dtype)
        unembed_p = {} if cfg.tie_embeddings else layers.init_unembed(gen, d, v, dtype)
    stacked = tuple(_init_stacked(n_groups, lambda bt=bt: init_block(gen, cfg, bt))
                    for bt in pattern) if n_groups > 0 else ()
    return {
        "embed": embed_p,
        "unembed": unembed_p,
        "layers": stacked,
        "tail": tuple(init_block(gen, cfg, bt) for bt in tail),
        "final_norm": layers.init_rmsnorm(d, dtype, gen.device),
    }


def _embed_codebooks(cfg, params, tokens, tp=None):
    """Audio: one table per codebook, summed in codebook order. tokens:
    (B, K, ...). With ``tp`` (the vocabulary cut over it) the K lookups are
    summed over the group in one stack, then over the codebooks."""
    table = params["embed"]["table"]  # (K, V, d)
    if tp is None:
        return sum(table[k][tokens[:, k]] for k in range(cfg.num_codebooks))
    parts = col.reduce_from(torch.stack([layers.embed_local(table[k], tokens[:, k], tp)
                                         for k in range(cfg.num_codebooks)]), tp)
    return sum(parts[k] for k in range(cfg.num_codebooks))


def embed_inputs(cfg, params, batch, tp=None):
    """Returns (x (B,T,d), ctx-extras dict); ``tp`` the model group when
    the vocabulary is cut over it."""
    dtype = layers.dtype_of(cfg.dtype)
    extras = {}
    if cfg.family == "audio":
        return _embed_codebooks(cfg, params, batch["tokens"], tp).to(dtype), extras  # (B, K, T)
    if cfg.family == "vlm":
        tok_emb = layers.embed(params["embed"], batch["tokens"], tp)  # (B, Tt, d)
        patches = batch["patch_embeds"].to(tok_emb.dtype)  # (B, P, d)
        x = torch.cat([patches, tok_emb], dim=1)
        if "mrope_positions" in batch:
            extras["mrope_positions"] = batch["mrope_positions"]
        else:
            b, t = x.shape[0], x.shape[1]
            extras["mrope_positions"] = torch.arange(t, device=x.device).expand(3, b, t)
        return x.to(dtype), extras
    return layers.embed(params["embed"], batch["tokens"], tp).to(dtype), extras


def unembed_logits(cfg, params, x, tp=None):
    """Logits; with ``tp`` (the vocabulary cut over it) the rank's columns."""
    x = col.copy_to(x, tp)
    if cfg.family == "audio":
        return torch.einsum("btd,kdv->bktv", x, params["unembed"]["kernel"])
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return layers.unembed(params["unembed"], x)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = _ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat_context(cfg):
    """The checkpoint's policy: recompute everything (``"nothing"``), or
    keep the matrix products (``"dots"``, ``checkpoint_dots``)."""
    if cfg.remat_policy == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_dots)
    return _ckpt.noop_context_fn


def _group_body(params, i, cfg, pattern, x, ctx):
    """Layer group ``i``'s blocks in pattern order -> (x, summed aux). The
    group's leaves are taken (FSDP: gathered) here, inside the checkpoint,
    so remat gathers them again for the backward instead of keeping them."""
    aux = _zero(x)
    for p_idx, bt in enumerate(pattern):
        x, a, _ = block_forward(_layer(params, p_idx, i, ctx.get("fsdp")), cfg, bt, x, ctx)
        aux = aux + a
    return x, aux


def forward(cfg, params, batch, *, ctx=None):
    """Full-sequence forward. Returns (logits, aux_loss, cache|None).

    ctx keys: attn_impl, moe_impl, want_cache, cache_len, cache_dtype,
    positions, window, last_only, last_index.
    """
    ctx = dict(ctx or {})
    fs = ctx.get("fsdp")
    edges = dict(params, embed=_edge(params, "embed", fs))
    vocab_tp = _vocab_tp(cfg, edges, ctx)
    x, extras = embed_inputs(cfg, edges, batch, vocab_tp)
    ctx.update(extras)
    pattern, n_groups, tail = pattern_info(cfg)
    want_cache = ctx.get("want_cache", False)

    aux = _zero(x)
    per_pos = [[] for _ in pattern]
    remat = cfg.remat and not want_cache and layers.remat_active(x)
    for i in range(n_groups):
        if remat:
            x, a = _ckpt.checkpoint(_group_body, params, i, cfg, pattern, x, ctx,
                                    use_reentrant=False, context_fn=_remat_context(cfg))
            aux = aux + a
            continue
        for p_idx, bt in enumerate(pattern):
            x, a, c = block_forward(_layer(params, p_idx, i, fs), cfg, bt, x, ctx)
            aux = aux + a
            per_pos[p_idx].append(c)
    group_caches = tuple(_stack(cs) if want_cache else {} for cs in per_pos) \
        if n_groups > 0 else ()
    tail_caches = []
    for t, bt in enumerate(tail):
        x, a, c = block_forward(_tail(params, t, fs), cfg, bt, x, ctx)
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
    edges["unembed"] = _edge(params, "unembed", fs)
    logits = unembed_logits(cfg, edges, x, vocab_tp)
    cache = {"groups": group_caches, "tail": tuple(tail_caches)} if want_cache else None
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, cache_len, dtype=None, *, device):
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
    """One decode step. tokens: (B,) integer (audio: (B, K)); pos: the
    absolute position (int or 0-dim tensor; with ``ctx["paged"]``, the
    per-slot (B,) positions). The cache is updated in place.
    Returns (logits (B, V) or (B, K, V), cache)."""
    ctx = dict(ctx or {})
    fs = ctx.get("fsdp")
    edges = dict(params, embed=_edge(params, "embed", fs))
    vocab_tp = _vocab_tp(cfg, edges, ctx)
    if cfg.family == "audio":
        x = _embed_codebooks(cfg, edges, tokens, vocab_tp)
    else:
        x = layers.embed(edges["embed"], tokens, vocab_tp)
    x = x.to(layers.dtype_of(cfg.dtype))
    pattern, n_groups, tail = pattern_info(cfg)
    for i in range(n_groups):
        for p_idx, bt in enumerate(pattern):
            x, _ = block_decode(_layer(params, p_idx, i, fs), cfg, bt,
                                _group(cache["groups"][p_idx], i), x, pos, ctx)
    for t, (bt, tc) in enumerate(zip(tail, cache["tail"], strict=True)):
        x, _ = block_decode(_tail(params, t, fs), cfg, bt, tc, x, pos, ctx)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    edges["unembed"] = _edge(params, "unembed", fs)
    if cfg.family == "audio":
        return torch.einsum("bd,kdv->bkv", col.copy_to(x, vocab_tp),
                            edges["unembed"]["kernel"]), cache
    return unembed_logits(cfg, edges, x, vocab_tp), cache
