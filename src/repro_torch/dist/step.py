"""Prefill and decode steps: the port of the serving half of the
reference's ``dist/step.py``, on one device.

The reference builds these for an SPMD mesh; the port runs them on the
device the params lie on. A mesh raises ``NotImplementedError`` (ROADMAP
Queue 1 item 11 ports the dist runtime), as do the train step and the
paged variants (item 12). Both steps run under ``torch.no_grad``; the
decode step writes into the cache it is given.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer


def _model_ctx(cfg, mesh, **extra) -> dict:
    """Forward-pass ctx: the hybrid family's attention window, as the
    reference sets it. The reference's also carries the mesh plumbing for
    the expert-parallel MoE, which is not ported."""
    if mesh is not None:
        raise NotImplementedError("meshes need the dist runtime, which is not ported "
                                  "yet: ROADMAP Queue 1 item 11")
    ctx = dict(extra)
    if cfg.family == "hybrid":
        # ring caches + masks sized to the local-attention window, matching
        # transformer.init_block_cache
        ctx["window"] = cfg.local_attn_window
    return ctx


def make_prefill_step(cfg, mesh=None, *, cache_len: int):
    """``prefill(params, batch) -> (last_logits, cache)``.

    Runs the full-sequence forward with ``last_only`` (the (B, T, V) logits
    tensor is never built) and returns the last position's logits in
    float32 ((B, V); audio (B, K, V)) beside the decode cache: ring KV
    caches of ``cache_len`` slots (the hybrid family's of at most its
    local window) and the recurrent blocks' states.
    """
    ctx = _model_ctx(cfg, mesh, want_cache=True, cache_len=cache_len, last_only=True)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _, cache = transformer.forward(cfg, params, batch, ctx=ctx)
        return logits[..., -1, :].float(), cache

    return prefill


def make_serve_step(cfg, mesh=None):
    """``serve(params, cache, tokens, pos) -> (next_tokens, logits, cache)``
    — one greedy decode step, over every codebook for audio (the cache is
    updated in place)."""
    ctx = _model_ctx(cfg, mesh)

    @torch.no_grad()
    def serve(params, cache, tokens, pos):
        logits, cache = transformer.decode_step(cfg, params, cache, tokens, pos, ctx=ctx)
        return torch.argmax(logits, dim=-1), logits, cache

    return serve
