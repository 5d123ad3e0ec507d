"""Train, prefill and decode steps: the port of the reference's
``dist/step.py`` on one device.

The reference builds these for an SPMD mesh; the port runs them on the
device the params lie on, as the reference runs them without one (its
single-device path: ``_num_shards`` is 1 when there is no mesh). A mesh
raises ``NotImplementedError`` (ROADMAP Queue 1 item 11 part B ports it).

Training (``make_train_step``): ``dense`` is plain SGD on the batch's
gradient; ``gmf_data`` and ``gmf_pod`` make the whole device one GMF
client (n = 1) whose gradient runs through ``Scheme.client_compress`` and
``server_aggregate`` with its own flat compression state, as the FL
engines do (``TrainState.cstate`` is a ``[1, N]`` stack per field, a
tuple of them for a tree of mixed dtypes). With n = 1 there is nothing to
``vmap`` over, so the gradient is plain autograd (``torch.autograd.grad``),
which is what lets the model honour ``remat`` here. The state keeps the
reference's dtypes: it starts in the params' dtype and promotes as jnp
promotes it; the params step in float32 and keep their dtype.

The step's phases run inside ``obs.trace.annotate_scope`` ranges with the
FL engines' names (``round.client_grads``, ``round.client_compress``,
``round.server_aggregate``, ``round.apply_update``), so a
``torch.profiler`` trace splits a step as it splits a round.

Serving: the fixed-batch prefill and decode steps, and the paged ones of
the continuous-batching engine (``serve/engine.py``), run under
``torch.no_grad``; the decode steps and the paged prefill write into the
cache or pool they are given.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import resolve
from repro_torch.core.state import ClientState, ServerState
from repro_torch.models import transformer
from repro_torch.obs import trace
from repro_torch.optim import sgd
from repro_torch.utils import scalar, tree_leaves, tree_map, tree_size, tree_unflatten
from repro_torch.utils.flat import FlatLayout

GRAD_SYNC_MODES = ("dense", "gmf_data", "gmf_pod")

# Params sharded over data AND model (FSDP) in the reference above this
# count: the >40 B archs (qwen2-vl-72b, command-r-plus-104b, kimi-k2-1t).
_FSDP_PARAM_THRESHOLD = 40e9


def needs_fsdp(cfg) -> bool:
    return cfg.param_count() > _FSDP_PARAM_THRESHOLD


class TrainState(NamedTuple):
    params: Any
    opt: Any          # optimiser slots (SGDState)
    cstate: Any       # compression state, [n, N] stacks (n = 1 without a mesh)
    sstate: Any       # server-side state (momentum for dgcwgm, downlink residual)
    gbar: Any         # last broadcast Ĝ, flat (feeds the global momentum M)
    step: int


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("meshes need the dist runtime's sharded half, which is not "
                                  "ported yet: ROADMAP Queue 1 item 11 part B")


def _sync_axis(grad_sync: str) -> str | None:
    if grad_sync == "gmf_data":
        return "data"
    if grad_sync == "gmf_pod":
        return "pod"
    if grad_sync == "dense":
        return None
    raise ValueError(f"unknown grad_sync {grad_sync!r}; choose from {GRAD_SYNC_MODES}")


def _num_shards(grad_sync: str, mesh) -> int:
    """GMF clients of a step: 1 without a mesh (the reference's
    single-device path), and for dense sync."""
    _sync_axis(grad_sync)
    _no_mesh(mesh)
    return 1


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def make_loss_fn(cfg, mesh=None):
    """Masked-NLL LM loss, ``loss_fn(params, batch) -> (loss, aux)``.

    Positions with label < 0 (VLM patch slots) are excluded from the mean,
    in float32. ``aux`` is the router load-balance loss (0 outside MoE),
    already folded into ``loss`` with ``cfg.router_aux_coef``. The forward
    runs under ``_model_ctx`` (the hybrid's attention window, R10)."""
    ctx = _model_ctx(cfg, mesh)

    def loss_fn(params, batch):
        logits, aux, _ = transformer.forward(cfg, params, batch, ctx=ctx)
        labels = batch["labels"]
        logp = F.log_softmax(logits.float(), dim=-1)
        safe = torch.clamp(labels, min=0)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        valid = (labels >= 0).float()
        loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
        return loss + cfg.router_aux_coef * aux, aux

    return loss_fn


def _model_ctx(cfg, mesh, **extra) -> dict:
    """Forward-pass ctx: the hybrid family's attention window, as the
    reference sets it. The reference's also carries the mesh plumbing for
    the expert-parallel MoE, which is not ported."""
    _no_mesh(mesh)
    ctx = dict(extra)
    if cfg.family == "hybrid":
        # ring caches + masks sized to the local-attention window, matching
        # transformer.init_block_cache
        ctx["window"] = cfg.local_attn_window
    return ctx


# ---------------------------------------------------------------------------
# Train state and step
# ---------------------------------------------------------------------------


def init_train_state(cfg, tcfg, ccfg, params, mesh=None) -> TrainState:
    """The reference's initial state: SGD slots, and for the gmf modes the
    scheme's zero client state as ``[n, N]`` stacks in the params' dtypes,
    its server state and a zero ``gbar`` (``{}`` unless the scheme keeps
    the global momentum)."""
    n = _num_shards(tcfg.grad_sync, mesh)
    opt = sgd.init(params, momentum=tcfg.momentum)
    if tcfg.grad_sync == "dense":
        cstate: Any = ClientState(u={}, v={}, m={})
        sstate: Any = ServerState(momentum={}, residual={})
        gbar: Any = {}
    else:
        scheme = resolve(ccfg)
        client, sstate = scheme.init_states(params)
        cstate = tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous(),
                          client)
        gbar = FlatLayout.of(params).zeros() if scheme.uses_m else {}
    return TrainState(params=params, opt=opt, cstate=cstate, sstate=sstate, gbar=gbar, step=0)


def _value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads) by plain autograd, the grads in the params'
    tree and dtypes."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), aux.detach()), tree_unflatten(params, list(grads))


def make_train_step(cfg, tcfg, ccfg, mesh=None):
    """Build ``step(state, batch) -> (state, metrics)`` for one grad-sync
    mode. Metrics: loss, upload_nnz (exact int64 per-shard vector ``[n]``),
    download_nnz (the post-downlink broadcast — the sparse union when the
    scheme has no downlink stage), total_params — the exact wire accounting
    the launcher turns into MB (``core.accounting.CostModel``)."""
    sync = tcfg.grad_sync
    n = _num_shards(sync, mesh)
    loss_fn = make_loss_fn(cfg, mesh)

    def _apply(params, opt, update, step):
        lr = sgd.lr_at(step, tcfg)
        return sgd.apply_updates(params, update, opt, lr=lr, momentum=tcfg.momentum,
                                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)

    if sync == "dense":

        def step_fn(state: TrainState, batch):
            with trace.annotate_scope("round.client_grads"):
                (loss, _), grads = _value_and_grad(loss_fn, state.params, batch)
            with torch.no_grad(), trace.annotate_scope("round.apply_update"):
                params, opt = _apply(state.params, state.opt, grads, state.step)
            total = torch.tensor(tree_size(state.params), dtype=torch.int64)
            metrics = {"loss": loss, "upload_nnz": total, "download_nnz": total,
                       "total_params": total}
            return state._replace(params=params, opt=opt, step=state.step + 1), metrics

        return step_fn

    scheme = resolve(ccfg)
    if scheme.owns_lr and (tcfg.weight_decay > 0.0 or tcfg.grad_clip > 0.0):
        raise ValueError(
            f"scheme {scheme.name!r} folds the learning rate into its server "
            "update, so optimiser weight_decay/grad_clip would apply to the "
            "lr-scaled update (1/lr times too strong) — set them to 0 for "
            "this scheme")

    def step_fn(state: TrainState, batch):
        layout = FlatLayout.of(state.params)
        with trace.annotate_scope("round.client_grads"):
            (loss, _), grads = _value_and_grad(loss_fn, state.params, batch)
        with torch.no_grad():
            with trace.annotate_scope("round.client_compress"):
                # the n = 1 client stack: [1, N] per dtype group
                flat = layout.flatten(tree_map(lambda g: g.unsqueeze(0), grads))
                del grads
                G, cstate, infos = scheme.client_compress(state.cstate, flat, state.gbar,
                                                          state.step, layout=layout)
                del flat
            with trace.annotate_scope("round.server_aggregate"):
                g_sum = tree_map(lambda x: torch.sum(x, dim=0), G)
                del G
                lr = sgd.lr_at(state.step, tcfg)
                gbar, sstate, ainfo = scheme.server_aggregate(state.sstate, g_sum, float(n),
                                                              layout=layout, lr=lr)
            update = layout.unflatten(gbar)
            with trace.annotate_scope("round.apply_update"):
                if scheme.owns_lr:
                    # FetchSGD: lr already entered the sketch-space error
                    # feedback — the broadcast is the finished update, applied
                    # un-scaled
                    params, opt = sgd.apply_updates(state.params, update, state.opt, lr=1.0,
                                                    momentum=tcfg.momentum)
                else:
                    params, opt = _apply(state.params, state.opt, update, state.step)
        new_gbar = gbar if scheme.uses_m else state.gbar
        metrics = {"loss": loss, "upload_nnz": infos.upload_nnz,
                   "download_nnz": ainfo.download_nnz,
                   "total_params": torch.tensor(ainfo.total_params, dtype=torch.int64)}
        return TrainState(params=params, opt=opt, cstate=cstate, sstate=sstate, gbar=new_gbar,
                          step=state.step + 1), metrics

    return step_fn


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Serving: paged (continuous-batching) variants
# ---------------------------------------------------------------------------


def make_paged_prefill_step(cfg, codec, mesh=None, *, prompt_pad: int):
    """``prefill(params, tokens, pool, table_row, length) ->
    (next_token, last_logits, pool)``: admit one request into a slot.

    ``tokens`` is (1, prompt_pad), the prompt right-padded to the fixed
    shape (``prompt_pad`` must be a page multiple); ``length`` is the true
    prompt length (a Python int or a 0-dim tensor) and ``table_row``
    (pages_per_slot,) the slot's physical pages on the pool's device. The
    forward runs ``last_only`` with ``last_index`` = length − 1, so only the
    true last token's logits are built (causal masking keeps the padding out
    of them), and the prompt's K/V pages are written into the pool with
    ``codec.write_pages`` (junk K/V beyond ``length`` lands in pages the slot
    owns and stays masked until decode overwrites it). ``last_index`` is
    made on the device by a fill, so the step copies nothing from the host.
    """
    ctx_base = _model_ctx(cfg, mesh, want_cache=True, cache_len=prompt_pad, last_only=True)

    def write_one(pe, ke, ve, phys):
        ps = pe["k"].shape[1]
        n_pages = prompt_pad // ps
        kp = ke[0].reshape(n_pages, ps, *ke.shape[2:])
        vp = ve[0].reshape(n_pages, ps, *ve.shape[2:])
        codec.write_pages(pe, kp, vp, phys[:n_pages])

    @torch.no_grad()
    def prefill(params, tokens, pool, table_row, length):
        ctx = dict(ctx_base)
        ctx["last_index"] = scalar(length, tokens.device, torch.int64).reshape(1) - 1
        logits, _, kv = transformer.forward(cfg, params, {"tokens": tokens}, ctx=ctx)
        last = logits[:, 0].float()  # (1, V)
        for pe, ce in zip(pool["groups"], kv["groups"], strict=True):
            for i in range(ce["k"].shape[0]):  # the stacked layers of the group
                write_one({key: a[i] for key, a in pe.items()}, ce["k"][i], ce["v"][i],
                          table_row)
        for pe, ce in zip(pool["tail"], kv["tail"], strict=True):
            write_one(pe, ce["k"], ce["v"], table_row)
        return torch.argmax(last, dim=-1), last, pool

    return prefill


def make_paged_serve_step(cfg, codec, mesh=None):
    """``serve(params, pool, tables, lengths, tokens) ->
    (next_tokens, logits, pool)``: one greedy decode step over every serving
    slot at once, the pool written in place.

    ``lengths`` (S,) is each slot's current absolute position (prompt
    length + tokens generated so far), on the pool's device: the step writes
    slot i's token at position ``lengths[i]`` and attends over positions up
    to it. Inactive slots (length 0, table row all scratch) compute garbage
    that is never read back: completion is length bookkeeping on the host,
    so the decode loop reads nothing back from the device.
    """
    ctx = _model_ctx(cfg, mesh)

    @torch.no_grad()
    def serve(params, pool, tables, lengths, tokens):
        c = dict(ctx, paged={"tables": tables, "codec": codec})
        logits, pool = transformer.decode_step(cfg, params, pool, tokens, lengths, ctx=c)
        return torch.argmax(logits, dim=-1), logits, pool

    return serve
