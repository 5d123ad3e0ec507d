"""Mixture-of-Experts FFN (Kimi-K2 / Granite-MoE style: softmax top-k
router): the port of the reference's ``models/moe.py``, dense dispatch.

``moe_dense`` computes the reference's function: every expert on every
token, combined with the router's gates (exact, no token dropping). The
reference builds the whole ``(E, BT, d)`` expert output before it
combines; at kimi-k2's width that is 384 × BT × 7168. The port walks the
experts in groups whose ``(group, BT, max(d, f))`` intermediates stay under
``GROUP_ELEMENTS`` and adds each group's gated output into a float32
``(BT, d)`` accumulator, so nothing of size E × BT × d is ever held. The
walk has no host sync: which experts a token chose changes the gates, not
the work. The one-hot is a comparison with ``arange(E)`` and the combine
table and the group sum are built out of place, so the function runs
under ``torch.func.vmap`` (the engines take client gradients that way).

The router stays float32; the gates are cast to x's dtype, as in the
reference. Over a group of ranks that share one loss (a pod's data ranks
under ``gmf_pod``, the data ranks of a dense step), ``router_topk`` takes
the group's expert density (one sum of an ``[E]`` vector a layer, no
gradient) and this rank's share of the mean router probability, so the
ranks' aux terms add up to the reference's aux over the group's tokens.

Under tensor parallelism (``tp``, the model group, whose size cuts the
experts' E dim by the reference's rules) the router stays replicated, so
every rank routes alike; each rank walks its own experts with its columns
of the combine table and the float32 partial outputs are summed over the
group.

``moe_ep`` is the expert-parallel path over a mesh (``launch/mesh.py``):
capacity-limited routed dispatch (``dispatch_local``: sort, positions,
a fixed ``(E_loc, capacity, d)`` buffer; assignments past an expert's
capacity are dropped), grouped GEMMs, ``combine_local``. It computes on
each rank's local pieces: x is the rank's tokens (laid over the data axes,
whole over ``model``), the expert weights its experts (E over ``model``,
and f over the last data axis when ``fsdp_weights``). The all-to-all body
cuts the sequence over ``model``, routes its tokens to every expert and
exchanges the buffers (``all_to_all_single``, twice); the other body keeps
the tokens whole and sums the ranks' partial outputs (``all_reduce``).
Both return x's shape, whole on every model rank. Inside a forward under
tensor parallelism (``tp``, the model group: the tokens reach the MoE
replicated over it and every rank holds the same loss, Megatron's
convention) the all-to-all body takes its slice of the sequence with
``slice_to`` and the output is put back whole with ``gather_from``; the
other body takes the tokens through ``copy_to`` and sums the ranks'
partial outputs with ``reduce_from``; the router enters through
``copy_to`` (each rank routes its own tokens, or weighs its own experts'
gates), and the model ranks' auxes are averaged with ``reduce_from``. So
the gradient of the replicated tokens and of the router comes back
summed over the group once, as the transpose of the reference's
``shard_map`` gives it. ``combine_local`` adds
a token's k rows in the order the reference's scatter adds them (the
sorted-expert order of ``dispatch_local``), with no atomics, so its bits
do not depend on the schedule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_size
from repro_torch.models import layers
from repro_torch.utils import collectives as col

# Bound on the elements of one expert group's intermediate (group × BT ×
# max(d, f)): 2^28 is 512 MiB in bfloat16.
GROUP_ELEMENTS = 1 << 28


def _expert_weights(gen, e, d_in, d_out, dtype):
    """(e, d_in, d_out) expert kernels drawn one expert at a time, so the
    float32 draw is one expert's, never the whole stack's."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    if out.device.type == "meta":  # a shape pass: nothing to draw
        return out
    for i in range(e):
        out[i] = layers.truncated_normal_init(gen, (d_in, d_out), d_in**-0.5, dtype)
    return out


def init_moe(gen, cfg, dtype=None):
    dtype = dtype or layers.dtype_of(cfg.param_dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": layers.dense_init(gen, d, e, torch.float32),  # router kept fp32
        "w_gate": _expert_weights(gen, e, d, f, dtype),
        "w_up": _expert_weights(gen, e, d, f, dtype),
        "w_down": _expert_weights(gen, e, f, d, dtype),
    }


def router_topk(params, cfg, x, groups=()):
    """Route: returns (eids (..., k) int64, gates (..., k) in x's dtype,
    aux_loss float32 scalar). With ``groups`` (process groups whose ranks
    hold equal shares of one batch) the density is the groups' and the
    aux this rank's share: the ranks' auxes sum to the batch's."""
    logits = x.float() @ params["router"]  # (..., E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux loss: E * sum_e f_e * p_e
    e = cfg.num_experts
    lead = tuple(range(eids.dim() - 1))
    density = _one_hot(eids, e).float().sum(dim=-2).mean(dim=lead)  # tokens per expert (×k)
    mean_prob = probs.mean(dim=lead)
    if groups:
        n = 1
        for g in groups:
            density = col.sum_over(density, g)
            n *= col.size(g)
        density, mean_prob = density / n, mean_prob / n
    aux = e * torch.sum(density / cfg.experts_per_token * mean_prob)
    return eids, gates.to(x.dtype), aux


def _one_hot(ids, n):
    """``F.one_hot`` as a comparison with ``arange(n)``: int64, with no read
    of the ids' values on the host, so it runs under ``torch.func.vmap``."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def group_size(cfg, tokens: int) -> int:
    """Experts per group of ``moe_dense``'s walk for ``tokens`` tokens."""
    per_expert = tokens * max(cfg.d_model, cfg.d_ff)
    return max(1, min(cfg.num_experts, GROUP_ELEMENTS // max(per_expert, 1)))


def moe_dense(params, cfg, x, groups=(), tp=None):
    """All experts on all tokens, combined by the gates. x: (B, T, d).
    Returns (y (B, T, d), aux); ``groups`` as in ``router_topk``; with
    ``tp`` the expert weights are the rank's E/m experts."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    eids, gates, aux = router_topk(params, cfg, xf, groups)
    e = cfg.num_experts
    # (BT, E): each token's gate on the experts it chose, 0 elsewhere. The
    # chosen experts are distinct, so each entry sums one gate and zeros.
    combine = (_one_hot(eids, e).to(gates.dtype) * gates[..., None]).sum(dim=-2)
    if tp is not None:  # this rank's experts: their columns, and x into them
        combine = col.slice_to(combine, tp, 1)
        xf = col.copy_to(xf, tp)
    e_loc = params["w_gate"].shape[0]
    y = None
    step = group_size(cfg, b * t)
    for e0 in range(0, e_loc, step):
        sl = slice(e0, min(e0 + step, e_loc))
        h = F.silu(xf @ params["w_gate"][sl]) * (xf @ params["w_up"][sl])  # (g, BT, f)
        out = h @ params["w_down"][sl]  # (g, BT, d)
        part = torch.einsum("gbd,bg->bd", out, combine[:, sl]).float()
        y = part if y is None else y + part
    y = col.reduce_from(y, tp)
    return y.to(x.dtype).reshape(b, t, d), aux


def capacity_per_expert(tokens: int, cfg) -> int:
    """Fixed per-expert buffer length (local to one model rank's dispatch)."""
    mean = tokens * cfg.experts_per_token / cfg.num_experts
    return max(1, int(mean * cfg.capacity_factor + 0.999))


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------


def dispatch_local(x, eids, gates, e_base, e_loc, capacity):
    """Build the (e_loc, capacity, d) buffer for this rank's experts from
    local tokens. Local (no collectives).

    x: (Tl, d); eids/gates: (Tl, k). Returns (buf, tok_s, p_idx, keep,
    e_idx, gate_s): the buffer and, per assignment in sorted order, its
    token, buffer position, whether it was kept, its buffer row (``e_loc``
    for a dropped one) and its gate.
    """
    tl, k = eids.shape
    dev = x.device
    flat_e = eids.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(tl, device=dev).repeat_interleave(k)
    le = flat_e - e_base
    hit = (le >= 0) & (le < e_loc)
    # Sort all TK assignments by (miss, local_expert) so this rank's tokens
    # group into contiguous runs; misses sort to the back.
    sort_key = torch.where(hit, le, e_loc)
    order = torch.argsort(sort_key, stable=True)
    le_s = sort_key[order]
    tok_s = flat_t[order]
    gate_s = flat_g[order]
    hit_s = hit[order]
    # Position of each assignment within its expert run.
    seg_start = torch.searchsorted(le_s, torch.arange(e_loc + 1, device=dev), side="left")
    pos = torch.arange(tl * k, device=dev) - seg_start[torch.clamp(le_s, 0, e_loc)]
    keep = hit_s & (pos < capacity)
    # Scatter into the buffer; dropped rows land in a sacrificial extra slot.
    e_idx = torch.where(keep, le_s, e_loc)
    p_idx = torch.where(keep, pos, 0)
    rows = torch.where(keep[:, None], x[tok_s], 0)
    buf = torch.zeros((e_loc + 1, capacity, x.shape[-1]), dtype=x.dtype, device=dev)
    buf = buf.index_put((e_idx, p_idx), rows, accumulate=True)
    return buf[:e_loc], tok_s, p_idx, keep, e_idx, gate_s


def combine_local(y_buf, tok_s, p_idx, keep, e_idx, gate_s, tl):
    """Gather expert outputs back to token order and gate-weight them: a
    token's k rows are added one after another in sorted-assignment order,
    from zeros, as the reference's scatter-add adds them."""
    d = y_buf.shape[-1]
    y_pad = torch.cat([y_buf, torch.zeros_like(y_buf[:1])], dim=0)
    rows = y_pad[e_idx, p_idx]  # (TK, d)
    rows = torch.where(keep[:, None], rows, 0) * gate_s[:, None].to(y_buf.dtype)
    # each token's k sorted positions, ascending: (tl, k)
    mine = torch.argsort(tok_s, stable=True).reshape(tl, -1)
    out = torch.zeros((tl, d), dtype=y_buf.dtype, device=y_buf.device)
    for j in range(mine.shape[1]):
        out = out + rows[mine[:, j]]
    return out


def _expert_ffn(buf, w_g, w_u, w_d):
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_g)) * torch.einsum("ecd,edf->ecf", buf, w_u)
    return torch.einsum("ecf,efd->ecd", h, w_d)


def _gathered_weights(params_loc, fsdp_axis):
    """This rank's experts' weights, their f dim gathered over the FSDP
    group when it is sharded."""
    w_g, w_u, w_d = params_loc["w_gate"], params_loc["w_up"], params_loc["w_down"]
    if fsdp_axis is not None:
        w_g = col.gather_cat(w_g, fsdp_axis, 2)
        w_u = col.gather_cat(w_u, fsdp_axis, 2)
        w_d = col.gather_cat(w_d, fsdp_axis, 1)
    return w_g, w_u, w_d


def _model_mean(aux, group, shared: bool):
    """``aux`` averaged over the model group: its gradient summed over the
    ranks (their shares of one loss), or, with ``shared`` (every rank holds
    the same loss), passed to each rank as it is."""
    if not shared:
        return col.mean_over(aux, [group])
    return col.reduce_from(aux, group) / col.size(group)


def moe_ep_a2a_body(params_loc, cfg, x_loc, *, model_axis, fsdp_axis, n_model: int,
                    shared: bool = False):
    """All-to-all expert parallelism: ``x_loc`` (Bl, Tl, d) is this rank's
    slice of the sequence; it routes its tokens to ALL global experts
    through a per-source capacity buffer, one exchange over ``model_axis``
    (the model group) ships each expert's rows to its owner, the local
    grouped GEMMs run, and the reverse exchange returns the outputs.
    ``fsdp_axis`` is the FSDP group or None; ``shared`` as in
    ``_model_mean``."""
    bl, tl, d = x_loc.shape
    xf = x_loc.reshape(bl * tl, d)
    eids, gates, aux = router_topk(params_loc, cfg, xf)
    w_g, w_u, w_d = _gathered_weights(params_loc, fsdp_axis)
    e = cfg.num_experts
    e_loc = e // n_model
    cap = capacity_per_expert(bl * tl, cfg)
    # route MY tokens to ALL experts (e_base=0, e_loc=E), then exchange
    buf, tok_s, p_idx, keep, e_idx, gate_s = dispatch_local(xf, eids, gates, 0, e, cap)
    # (E, cap, d) -> (E/n, n·cap, d): rows for MY experts from every rank
    buf = col.exchange(buf, model_axis).reshape(n_model, e_loc, cap, d)
    buf = buf.transpose(0, 1).reshape(e_loc, n_model * cap, d)
    y_buf = _expert_ffn(buf, w_g, w_u, w_d)
    y_buf = y_buf.reshape(e_loc, n_model, cap, d).transpose(0, 1).contiguous()
    y_buf = col.exchange(y_buf, model_axis).reshape(e, cap, d)
    y = combine_local(y_buf, tok_s, p_idx, keep, e_idx, gate_s, bl * tl)
    aux = _model_mean(aux, model_axis, shared)
    return y.reshape(bl, tl, d), aux


def moe_ep_body(params_loc, cfg, x_loc, rank, *, model_axis, fsdp_axis, shared: bool = False):
    """Replicated-token expert parallelism: ``x_loc`` (Bl, T, d) whole on
    every model rank; this rank (``rank``, its index in ``model_axis``, the
    model group) runs its experts' share of the assignments and the
    partial outputs are summed over the group (``shared``: with
    ``reduce_from``, and ``_model_mean``)."""
    bl, t, d = x_loc.shape
    xf = x_loc.reshape(bl * t, d)
    eids, gates, aux = router_topk(params_loc, cfg, xf)
    w_g, w_u, w_d = _gathered_weights(params_loc, fsdp_axis)
    e_loc = w_g.shape[0]
    cap = capacity_per_expert(bl * t, cfg)
    buf, tok_s, p_idx, keep, e_idx, gate_s = dispatch_local(
        xf, eids, gates, int(rank) * e_loc, e_loc, cap)
    y_buf = _expert_ffn(buf, w_g, w_u, w_d)
    y = combine_local(y_buf, tok_s, p_idx, keep, e_idx, gate_s, bl * t)
    y = col.reduce_from(y, model_axis) if shared else col.sum_over(y, model_axis)
    aux = _model_mean(aux, model_axis, shared)
    return y.reshape(bl, t, d), aux


def moe_ep(params, cfg, x, *, mesh, data_axes, model_axis: str, fsdp_weights: bool,
           already_manual=frozenset(), tp=None):
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh``). ``params``
    holds this rank's expert pieces, ``x`` (Bl, T, d) its tokens.
    ``data_axes``: mesh axes the batch is laid over; ``model_axis``: the EP
    axis. ``fsdp_weights``: expert f-dim sharded over data_axes[-1].
    ``already_manual``: data axes whose aux mean the caller takes (the
    reference's axes made manual by an enclosing region).

    Takes the all-to-all body when the sequence and the experts divide the
    model axis (training, prefill), else the all-reduce body (decode at
    T == 1 on a model axis > 1), as the reference chooses. ``aux`` is
    averaged over ``model`` and the data axes not ``already_manual``.
    ``tp`` (the model group, inside a forward under tensor parallelism):
    ``x`` is replicated over it under Megatron's convention (the module
    docstring)."""
    already_manual = frozenset(already_manual)
    fsdp_name = data_axes[-1] if fsdp_weights else None
    if fsdp_name is not None and fsdp_name in already_manual:
        raise ValueError("FSDP expert sharding cannot use an axis that the "
                         "compressed grad-sync already made manual")
    model = mesh.get_group(model_axis)
    n_model = axis_size(mesh, model_axis)
    fsdp = mesh.get_group(fsdp_name) if fsdp_name is not None else None
    inner = [mesh.get_group(a) for a in reversed(data_axes) if a not in already_manual]
    seq_len = x.shape[1]
    shared = tp is not None and n_model > 1
    if shared:  # the router replicated over the model group: its gradient summed once
        params = dict(params, router=col.copy_to(params["router"], model))
    if seq_len % n_model == 0 and cfg.num_experts % n_model == 0:
        # sequence-sharded dispatch + all_to_all exchange (training/prefill)
        t = seq_len // n_model
        r = col.rank(model)
        x_loc = col.slice_to(x, model, 1) if shared else x[:, r * t:(r + 1) * t]
        y, aux = moe_ep_a2a_body(params, cfg, x_loc, model_axis=model, fsdp_axis=fsdp,
                                 n_model=n_model, shared=shared)
        # the whole sequence on every model rank
        y = col.gather_from(y, model, 1) if shared else col.gather_cat(y, model, 1)
    else:
        # replicated-token + all-reduce combine (decode: T == 1)
        y, aux = moe_ep_body(params, cfg, col.copy_to(x, model) if shared else x,
                             col.rank(model), model_axis=model, fsdp_axis=fsdp, shared=shared)
    if inner:
        aux = col.mean_over(aux, inner)
    return y, aux
