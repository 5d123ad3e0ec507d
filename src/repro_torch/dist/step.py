"""Train, prefill and decode steps: the port of the reference's
``dist/step.py``, on one device or over a mesh (``launch/mesh.py``).

Without a mesh the steps run on the device the params lie on, as the
reference runs them without one (``_num_shards`` is 1). Over a mesh every
rank runs the same step on plain local tensors, its pieces of the state
and batch (``dist/sharding.py``), and the collectives are
``torch.distributed`` calls over the mesh's axis groups:

- ``dense``: each rank takes the gradient of its share of the global
  batch's loss (its NLL over the valid-label count all-reduced over the
  data axes, its share of the router aux) and the gradients are summed
  over ``data`` and ``pod``: the gradient of the global loss.
- ``gmf_data``: each ``data`` rank is one GMF client (the reference's vmap
  row): it runs ``Scheme.client_compress`` on its own ``[1, N]`` row, the
  payloads are summed with one ``all_reduce`` over ``data``, and
  ``server_aggregate`` and the update run replicated.
- ``gmf_pod``: a pod's gradient is the sum over its ``data`` ranks of their
  shares of the pod's loss; every data rank of the pod then runs the same
  ``client_compress`` on the same row, and the payloads are summed over
  ``pod``.

The metrics follow the reference: ``loss`` is the mean over shards (the
global loss under dense sync), ``upload_nnz`` the exact int64 ``[n]``
vector gathered in shard order. As in the reference, the expert-parallel
MoE (``moe_ep``) runs only under dense sync and in serving; the gmf modes
run ``moe_dense``.

Tensor parallelism: on a mesh whose ``model`` axis is m > 1 every rank
holds its pieces of the params by the reference's ``_TP_RULES``
(``sharding.local_tree`` of ``param_specs``) and the batch lies over the
data axes only, so the ranks of a model group hold the same rows and the
same loss. The forward is the reference's function with the model group
in its ctx (``models/transformer.py``); the loss is vocabulary-parallel
where the logits are cut (the max, the sum of exponentials and the
target's logit each combined over ``model``). Each rank's flat
compression row holds its pieces of the leaves; its ``FlatLayout`` is
``over`` the model group, so the keep counts come from the whole leaves'
sizes, a cut segment's norms and threshold are the whole leaf's
(``gmf_select``'s group mode), and ``upload_nnz`` / ``total_params``
count the whole model. The stages that cut or key a leaf by flat
coordinate (the sampled estimator, global top-k, random-k, FetchSGD's
sketch, the int8 and probquant wires, the Hadamard rotation) read each
piece's place in its whole leaf from the layout's boxes
(``sharding.boxes``) and give the rank's piece of the mesh-less result.
The expert-parallel MoE runs inside the forward at any model axis (the
tokens replicated over the model group, ``moe.moe_ep(..., tp=...)``).

FSDP: the >40 B archs (``needs_fsdp``) on a ``data`` axis over 1 hold
their params cut over ``data`` too (``param_specs(..., fsdp=True)``), the
optimiser slots with them, and the forward gathers a layer's pieces just
before the layer runs (``transformer.FsdpCtx``, ``_model_ctx``). The
gather's backward is each mode's:

- ``dense``: a reduce-scatter (``collectives.gather_cat``): each rank's
  gradient piece is its slice of the data ranks' summed shares, then
  summed over ``pod``; the leaves FSDP leaves whole are summed over the
  data axes as before.
- ``gmf_data``: each data rank is one client and needs its own whole
  gradient, so the gather's backward writes it whole to a sink the step
  reads (``collectives.fsdp_gather`` with a sink): the client's row,
  its U, V and M, the server state and ``gbar`` are whole over ``data``
  and cut over ``model`` as without FSDP (``train_state_specs`` strips
  ``data``), and each rank applies its data slice of the update to its
  pieces.
- ``gmf_pod``: a pod's gradient is reduce-scattered over ``data`` (the
  leaves FSDP leaves whole are all-reduced), so the rank's row, its state
  and ``gbar`` hold pieces of leaves cut over the pod's data × model ranks:
  the ``FlatLayout`` is ``over`` that group, with owner flags
  (``sharding.owner_flags``) so that a piece several of its ranks hold
  alike (a leaf cut over ``model`` alone, or over neither) counts once in
  the norms, thresholds, histograms and counts.

The clip's global norm sums over the data × model ranks with the same
once-counting. The >40 B archs at smoke size, or cut in depth, fall under
the 40e9 threshold: a test or a smoke run that wants FSDP there sets
``_FSDP_PARAM_THRESHOLD`` to 0 in its own process.

Training: the gmf modes make each shard one GMF client whose gradient runs
through ``Scheme.client_compress`` and ``server_aggregate`` with its own
flat compression state, as the FL engines do (``TrainState.cstate`` is
the rank's ``[1, N]`` row per field, a tuple of them for a tree of mixed
dtypes). The gradient is plain autograd (``torch.autograd.grad``), which
is what lets the model honour ``remat`` here. The state keeps the
reference's dtypes: it starts in the params' dtype and promotes as jnp
promotes it; the params step in float32 and keep their dtype.

The step's phases run inside ``obs.trace.annotate_scope`` ranges with the
FL engines' names (``round.client_grads``, ``round.client_compress``,
``round.server_aggregate``, ``round.apply_update``), so a
``torch.profiler`` trace splits a step as it splits a round.

Serving: the fixed-batch prefill and decode steps, and the paged ones of
the continuous-batching engine (``serve/engine.py``), run under
``torch.no_grad``; the decode steps and the paged prefill write into the
cache or pool they are given. Over a mesh they take the rank's batch,
params and cache or pool (the kv heads the rank's where they divide the
model axis: ``kv_entry_spec``, ``pool_specs``, with the int8 codec's
scales cut alike) and carry the model group, FSDP's gathers and the EP
keys in their ctx; the logits come back whole.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

import torch.distributed as dist

from repro_torch.core import resolve
from repro_torch.obs.health import NormSpan
from repro_torch.core.state import ClientState, ServerState
from repro_torch.dist import sharding as shr
from repro_torch.launch.mesh import axis_size, mesh_axes
from repro_torch.models import transformer
from repro_torch.obs import trace
from repro_torch.optim import sgd
from repro_torch.utils import collectives as col
from repro_torch.utils import scalar, tree_leaves, tree_map, tree_size, tree_unflatten
from repro_torch.utils.flat import FlatLayout, GroupedLayout

GRAD_SYNC_MODES = ("dense", "gmf_data", "gmf_pod")

# Params sharded over data AND model (FSDP) in the reference above this
# count: the >40 B archs (qwen2-vl-72b, command-r-plus-104b, kimi-k2-1t).
_FSDP_PARAM_THRESHOLD = 40e9


def needs_fsdp(cfg) -> bool:
    return cfg.param_count() > _FSDP_PARAM_THRESHOLD


class TrainState(NamedTuple):
    params: Any
    opt: Any          # optimiser slots (SGDState)
    cstate: Any       # compression state: this rank's [1, N] row of each [n, N] stack
    sstate: Any       # server-side state (momentum for dgcwgm, downlink residual)
    gbar: Any         # last broadcast Ĝ, flat (feeds the global momentum M)
    step: int


def fsdp_active(cfg, mesh) -> bool:
    """Whether ``cfg``'s params are cut over ``mesh``'s data axis (FSDP):
    ``needs_fsdp`` on a data axis over 1."""
    return mesh is not None and needs_fsdp(cfg) and axis_size(mesh, "data") > 1


_EXPERTS = ("w_gate", "w_up", "w_down")


def _without_experts(dims):
    """FSDP's dims with the expert leaves left whole: ``moe_ep`` gathers
    them itself."""
    if isinstance(dims, dict):
        return {k: (None if k in _EXPERTS and "router" in dims else _without_experts(v))
                for k, v in dims.items()}
    if isinstance(dims, tuple):
        return tuple(_without_experts(v) for v in dims)
    return dims


def _fsdp_ctx(cfg, mesh, ep: bool = False):
    """FSDP's forward ctx (``transformer.FsdpCtx``) for ``cfg`` over
    ``mesh``, or None; ``ep``: the expert-parallel MoE runs, and gathers its
    experts itself."""
    if not fsdp_active(cfg, mesh):
        return None
    dims = shr.fsdp_dims(transformer.abstract_params(cfg), mesh)
    return transformer.FsdpCtx(mesh.get_group("data"), _without_experts(dims) if ep else dims)


_GROUPS: dict = {}


def mesh_group(mesh, axes):
    """The process group over ``mesh``'s axes among ``axes`` whose size is
    over 1: None for none, the axis's own group for one, else their
    flattened group, made once per mesh (a collective of the mesh's
    ranks)."""
    names = tuple(a for a in mesh_axes(mesh) if a in axes and axis_size(mesh, a) > 1)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (id(mesh), names)
    if key not in _GROUPS:  # the mesh is held beside its group, so its id stays its own
        _GROUPS[key] = (mesh, mesh[names]._flatten().get_group())
    return _GROUPS[key][1]


def model_group(mesh):
    """The mesh's model group when its model axis is over 1 (tensor
    parallelism), else None."""
    if mesh is None or axis_size(mesh, shr.MODEL_AXIS) == 1:
        return None
    return mesh.get_group(shr.MODEL_AXIS)


def full_sizes(cfg) -> tuple[int, ...]:
    """The whole leaves' sizes of ``cfg``'s params, in ``tree_leaves``
    order (a meta-device shape pass)."""
    return tuple(x.numel() for x in tree_leaves(transformer.abstract_params(cfg)))


def _cut_leaves(params, sizes) -> tuple[bool, ...]:
    """Which of the rank's leaves are pieces (their size not the whole's)."""
    return tuple(x.numel() != n for x, n in zip(tree_leaves(params), sizes, strict=True))


def _sync_axis(grad_sync: str) -> str | None:
    if grad_sync == "gmf_data":
        return "data"
    if grad_sync == "gmf_pod":
        return "pod"
    if grad_sync == "dense":
        return None
    raise ValueError(f"unknown grad_sync {grad_sync!r}; choose from {GRAD_SYNC_MODES}")


def _num_shards(grad_sync: str, mesh) -> int:
    """GMF clients of a step: the sync axis's size; 1 without a mesh (the
    reference's single-device path) and for dense sync."""
    axis = _sync_axis(grad_sync)
    if axis is None or mesh is None:
        return 1
    if axis not in mesh_axes(mesh):
        raise ValueError(f"grad_sync={grad_sync!r} needs a {axis!r} mesh axis "
                         f"(got axes {mesh_axes(mesh)})")
    return axis_size(mesh, axis)


def _groups(mesh, axes) -> list:
    """The process groups of the mesh's ``axes`` that it has, in order."""
    return [mesh.get_group(a) for a in axes if a in mesh_axes(mesh)]


def _step_groups(sync: str, mesh):
    """(loss groups, sync group): the groups whose ranks share one loss
    (their batch rows make it), innermost first, and the group the
    payloads are summed over."""
    if mesh is None:
        return [], None
    if sync == "dense":
        return _groups(mesh, ("data", "pod")), None
    if sync == "gmf_data":
        return [], mesh.get_group("data")
    return _groups(mesh, ("data",)), mesh.get_group("pod")


def sync_group(grad_sync: str, mesh):
    """The process group a step sums its payloads over (``data`` for
    ``gmf_data``, ``pod`` for ``gmf_pod``); None without a mesh or under
    dense sync."""
    return _step_groups(grad_sync, mesh)[1]


def _psum_(x, groups):
    """``x`` summed over the ranks of each group in place (no gradient)."""
    x = x.contiguous()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def step_batch_specs(cfg, tcfg, mesh) -> dict:
    """How a train step's batch lies over ``mesh``: the reference's
    ``train_batch_specs`` (rows over the data axes, pod outermost), but for
    ``gmf_data``, whose shard c takes rows c·B/n..(c+1)·B/n over ``data``
    alone (a pod axis, if any, repeats the step)."""
    specs = shr.train_batch_specs(cfg, mesh)
    if tcfg.grad_sync != "gmf_data":
        return specs
    return {k: shr.P("data", *tuple(s)[1:]) for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def make_loss_fn(cfg, mesh=None):
    """Masked-NLL LM loss, ``loss_fn(params, batch) -> (loss, aux)``.

    Positions with label < 0 (VLM patch slots) are excluded from the mean,
    in float32. ``aux`` is the router load-balance loss (0 outside MoE),
    already folded into ``loss`` with ``cfg.router_aux_coef``. The forward
    runs under ``_model_ctx`` (the hybrid's attention window, R10; the EP
    keys over a mesh)."""
    return _share_loss_fn(cfg, _model_ctx(cfg, mesh), [])


def _nll(cfg, logits, labels, tp):
    """Per-position float32 NLL of ``labels`` (clamped at 0) under
    ``logits``: ``log_softmax`` and a gather, or, where ``tp`` cuts the
    vocabulary (the rank's columns), the vocabulary-parallel form: the max,
    the sum of exponentials and the target's logit each combined over the
    group (the max without a gradient, which it does not change)."""
    safe = torch.clamp(labels, min=0)
    if tp is None or logits.shape[-1] == cfg.vocab_size:
        logp = F.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, safe[..., None])[..., 0]
    lf = logits.float()
    v_loc = lf.shape[-1]
    shifted = lf - col.max_over(lf.detach().amax(dim=-1), tp)[..., None]
    sumexp = col.reduce_from(torch.exp(shifted).sum(dim=-1), tp)
    local = safe - col.rank(tp) * v_loc
    hit = (local >= 0) & (local < v_loc)
    tgt = torch.gather(shifted, -1, torch.where(hit, local, 0)[..., None])[..., 0]
    tgt = col.reduce_from(torch.where(hit, tgt, torch.zeros((), device=tgt.device)), tp)
    return torch.log(sumexp) - tgt


def _share_loss_fn(cfg, ctx, groups):
    """This rank's share of the loss of a batch laid over ``groups``: its
    NLL over the valid-label count summed over the groups, and its share of
    the router aux (the groups' density and this rank's mean probability
    under dense dispatch; 1/n of the groups' mean under EP). The ranks'
    shares add up to the reference's loss of the whole batch. ``sink`` (a
    dict) takes each FSDP gather's gradient whole (``gmf_data``)."""
    n = 1
    for g in groups:
        n *= col.size(g)
    if groups:
        ctx = dict(ctx, token_groups=tuple(groups))
    ep = ctx.get("moe_impl") == "ep"
    tp = ctx.get("tp")

    def loss_fn(params, batch, sink=None):
        call = ctx if sink is None else dict(ctx, fsdp=ctx["fsdp"]._replace(sink=sink))
        logits, aux, _ = transformer.forward(cfg, params, batch, ctx=call)
        labels = batch["labels"]
        nll = _nll(cfg, logits, labels, tp)
        valid = (labels >= 0).float()
        count = torch.sum(valid)
        for g in groups:
            count = col.sum_over(count, g)
        loss = torch.sum(nll * valid) / torch.clamp(count, min=1.0)
        if ep and n > 1:
            aux = aux / n
        return loss + cfg.router_aux_coef * aux, aux

    return loss_fn


def _model_ctx(cfg, mesh, *, ep: bool = True, **extra) -> dict:
    """Forward-pass ctx: the hybrid family's attention window, and over a
    mesh the model group (tensor parallelism at a model axis over 1), FSDP's
    gathers and, with ``ep``, the plumbing of the expert-parallel MoE, as
    the reference sets them."""
    ctx = dict(extra)
    if cfg.family == "hybrid":
        # ring caches + masks sized to the local-attention window, matching
        # transformer.init_block_cache
        ctx["window"] = cfg.local_attn_window
    tp = model_group(mesh)
    if tp is not None:
        ctx["tp"] = tp
    ep = ep and mesh is not None and cfg.num_experts > 0 and cfg.moe_impl == "ep"
    if ep:
        ctx.update(mesh=mesh, data_axes=shr.dp_axes(mesh), model_axis=shr.MODEL_AXIS,
                   moe_impl="ep", fsdp_moe=needs_fsdp(cfg))
    fs = _fsdp_ctx(cfg, mesh, ep)
    if fs is not None:
        ctx["fsdp"] = fs
    return ctx


# ---------------------------------------------------------------------------
# Train state and step
# ---------------------------------------------------------------------------


def _own_whole(grad_sync: str, cfg, mesh) -> bool:
    """Whether each client's state is whole over ``data`` while its params
    are cut over it: ``gmf_data`` under FSDP."""
    return grad_sync == "gmf_data" and fsdp_active(cfg, mesh)


def _client_like(params, cfg, mesh):
    """A tree shaped as the client state's leaves under ``gmf_data`` with
    FSDP: each leaf cut over ``data`` as the whole over ``data`` (expanded
    zeros, no memory), the others the params themselves."""
    n = axis_size(mesh, "data")
    dims = tree_leaves(shr.fsdp_dims(transformer.abstract_params(cfg), mesh))
    out = []
    for x, d in zip(tree_leaves(params), dims, strict=True):
        if d is None:
            out.append(x)
            continue
        shape = list(x.shape)
        shape[d] *= n
        out.append(torch.zeros((), dtype=x.dtype, device=x.device).expand(shape))
    return tree_unflatten(params, out)


def _data_pieces(tree, dims, mesh):
    """This rank's data slices (views) of ``tree``'s leaves that FSDP cuts
    (``dims``: each leaf's dim cut over data, or None)."""
    n, r = axis_size(mesh, "data"), mesh.get_local_rank("data")
    out = [x if d is None else x.chunk(n, dim=d)[r]
           for x, d in zip(tree_leaves(tree), dims, strict=True)]
    return tree_unflatten(tree, out)


def _over_data(flat, src, dst, dims, mesh, whole: bool):
    """A flat quantity of the leaves of layout ``src`` as one of ``dst``'s:
    each leaf FSDP cuts (``dims``) gathered whole over ``data``
    (``whole``) or cut to this rank's piece. ``{}`` (a field the scheme
    does not use) stays."""
    if not isinstance(flat, (torch.Tensor, tuple)):
        return flat
    tree = src.unflatten(flat)
    if whole:
        group = mesh.get_group("data")
        tree = tree_unflatten(tree, [x if d is None else col.gather_cat(x, group, d)
                                     for x, d in zip(tree_leaves(tree), dims, strict=True)])
    else:
        tree = _data_pieces(tree, dims, mesh)
    return dst.flatten(tree)


def init_train_state(cfg, tcfg, ccfg, params, mesh=None) -> TrainState:
    """The reference's initial state, as this rank's local piece: SGD
    slots, and for the gmf modes the scheme's zero client state as the
    rank's ``[1, N]`` row of each stack (its data-axis row under
    ``gmf_data``, its pod's under ``gmf_pod``) in the params' dtypes, its
    server state and a zero ``gbar`` (``{}`` unless the scheme keeps the
    global momentum). Params, opt slots, ``gbar`` and the server state are
    every rank's own: every rank passes its pieces of the params
    (``sharding.local_tree``; the whole at a mesh of one rank). Under
    ``gmf_data`` with FSDP the client state is whole over ``data``, the
    server state and ``gbar`` cut like the params (``train_state_specs``)."""
    _num_shards(tcfg.grad_sync, mesh)
    opt = sgd.init(params, momentum=tcfg.momentum)
    if tcfg.grad_sync == "dense":
        cstate: Any = ClientState(u={}, v={}, m={})
        sstate: Any = ServerState(momentum={}, residual={})
        gbar: Any = {}
    else:
        scheme = resolve(ccfg)
        client, sstate = scheme.init_states(params)
        if _own_whole(tcfg.grad_sync, cfg, mesh):
            client = scheme.init_states(_client_like(params, cfg, mesh))[0]
        cstate = tree_map(lambda x: x.unsqueeze(0).contiguous(), client)
        gbar = FlatLayout.of(params).zeros() if scheme.uses_m else {}
    return TrainState(params=params, opt=opt, cstate=cstate, sstate=sstate, gbar=gbar, step=0)


def train_state_specs(cfg, tcfg, ccfg, params, mesh) -> TrainState:
    """Spec tree mirroring ``init_train_state``: per-leaf specs for the
    params, the opt slots, ``gbar`` and the server state, the reference's
    (the port holds ``gbar`` and the server state flat, each rank its pieces
    of the leaves as those specs cut them); ``P(axis)`` for each flat
    ``[n, N]`` compression stack of the rank's pieces (a tuple of them for a
    tree of mixed dtypes; under ``gmf_data`` with FSDP a row of pieces cut
    over ``model`` alone, as the reference strips the sync axis)."""
    pspec = shr.param_specs(params, fsdp=needs_fsdp(cfg), mesh=mesh)
    axis = _sync_axis(tcfg.grad_sync)
    if tcfg.grad_sync == "dense":
        cstate: Any = ClientState(u={}, v={}, m={})
        gbar: Any = {}
        srv_spec: Any = {}
        res_spec: Any = {}
    else:
        scheme = resolve(ccfg)
        layout = FlatLayout.of(params)
        stack = (tuple(shr.P(axis) for _ in layout.groups)
                 if isinstance(layout, GroupedLayout) else shr.P(axis))
        cstate = ClientState(u=stack if scheme.uses_u else {},
                             v=stack if scheme.uses_v else {},
                             m=stack if scheme.uses_m else {})
        gbar = pspec if scheme.uses_m else {}
        if scheme.is_sketch:
            srv_spec = {"s_mom": shr.P(), "s_err": shr.P()}  # small, replicated
        else:
            srv_spec = pspec if scheme.server_momentum else {}
        res_spec = pspec if scheme.downlink_residual else {}
    return TrainState(
        params=pspec,
        opt=sgd.SGDState(momentum=pspec if tcfg.momentum > 0 else {}),
        cstate=cstate,
        sstate=ServerState(momentum=srv_spec, residual=res_spec),
        gbar=gbar,
        step=shr.P(),
    )


def _value_and_grad(loss_fn, params, batch, own=None):
    """((loss, aux), grads) by plain autograd, the grads in the params'
    tree and dtypes. ``own`` (FSDP's dim of each leaf, or None, in
    ``tree_leaves`` order) takes each FSDP leaf's gradient whole over
    ``data`` from the sink its gathers' backward writes (``gmf_data``): a
    stacked leaf's is its layers' stacked."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        if own is None:
            loss, aux = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves)
            return (loss.detach(), aux.detach()), tree_unflatten(params, list(grads))
        sink: dict = {}
        loss, aux = loss_fn(live, batch, sink)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = []
    for x, g, d in zip(leaves, got, own, strict=True):
        if d is None:
            out.append(torch.zeros_like(x) if g is None else g)
        elif (id(x), None) in sink:
            out.append(sink[(id(x), None)])
        else:
            out.append(torch.stack([sink[(id(x), i)] for i in range(x.shape[0])]))
    return (loss.detach(), aux.detach()), tree_unflatten(params, out)


def _psum_tree(grads, groups, cut_groups, gathered):
    """Each gradient leaf summed in place over ``groups``, or over
    ``cut_groups`` (``groups`` without FSDP's data group) for the leaves
    ``gathered`` flags: their gathers' backward summed them over ``data``."""
    out = [_psum_(g, cut_groups if cut else groups)
           for g, cut in zip(tree_leaves(grads), gathered, strict=True)]
    return tree_unflatten(grads, out)


def health_spans(cfg, tcfg, mesh, params) -> dict | None:
    """How the trainer's flat compression state lies over ``mesh``, for
    ``obs.health.compensation_norms`` to report the whole model's norms (the
    reference's, of global arrays): every segment's squares summed over
    the mesh's ranks, each piece once. The client rows are distinct over
    the sync axis (each shard a client), the server state and ``gbar``
    replicated over it; a piece several ranks hold alike (a leaf whole over
    ``data``, or over ``model``) counts on the rank whose coordinate is 0
    there (``sharding.owner_flags``). None without a mesh, under dense
    sync, or at a mesh of one rank. ``params`` are the rank's pieces."""
    if mesh is None or tcfg.grad_sync == "dense":
        return None
    axes = shr.DATA_AXES + (shr.MODEL_AXIS,)
    group = mesh_group(mesh, axes)
    if group is None:
        return None
    sync = _sync_axis(tcfg.grad_sync)
    own = _own_whole(tcfg.grad_sync, cfg, mesh)
    abstract = transformer.abstract_params(cfg)
    fsdp = fsdp_active(cfg, mesh)
    spans = {}
    # (the client rows under gmf_data with FSDP: whole over data)
    for name, like, cut_data, distinct in (
            ("client", _client_like(params, cfg, mesh) if own else params, fsdp and not own,
             (sync,)),
            ("server", params, fsdp, ())):
        layout = FlatLayout.of(like)
        order = ([i for idx in layout.index for i in idx] if isinstance(layout, GroupedLayout)
                 else list(range(layout.num_leaves)))
        flags = shr.owner_flags(shr.param_specs(abstract, fsdp=cut_data, mesh=mesh), mesh, axes,
                                distinct)
        spans[name] = NormSpan(_segments_of(layout), group, (True,) * len(order),
                               tuple(flags[i] for i in order))
    return spans


def _segments_of(layout):
    """A flat field's per-leaf segments (every dtype group's, in order)."""
    def segments(field):
        if isinstance(layout, GroupedLayout):
            return [seg for g, x in zip(layout.groups, field, strict=True)
                    for seg in g.segments(x)]
        return layout.segments(field)

    return segments


def make_train_step(cfg, tcfg, ccfg, mesh=None):
    """Build ``step(state, batch) -> (state, metrics)`` for one grad-sync
    mode; over ``mesh`` it takes this rank's local state and batch
    (``step_batch_specs``) and every rank calls it. Metrics: loss,
    upload_nnz (exact int64 per-shard vector ``[n]``), download_nnz (the
    post-downlink broadcast — the sparse union when the scheme has no
    downlink stage), total_params — the exact wire accounting the launcher
    turns into MB (``core.accounting.CostModel``)."""
    sync = tcfg.grad_sync
    n = _num_shards(sync, mesh)
    loss_groups, sync_group = _step_groups(sync, mesh)
    tp = model_group(mesh)
    fsdp = fsdp_active(cfg, mesh)
    sizes = full_sizes(cfg) if tp is not None or fsdp else None
    # the compressed modes run dense experts, as the reference's vmap over
    # shards does; EP only under dense sync
    ctx = _model_ctx(cfg, mesh, ep=sync == "dense")
    loss_fn = _share_loss_fn(cfg, ctx, loss_groups)
    # each leaf's dim the forward gathers over data under FSDP (its gradient
    # summed or taken whole there; under EP moe_ep gathers the experts by
    # the same dims), and the groups the others' gradients are summed over
    abstract = transformer.abstract_params(cfg)
    dims = (tree_leaves(shr.fsdp_dims(abstract, mesh)) if fsdp
            else [None] * len(tree_leaves(abstract)))
    gathered = tuple(d is not None for d in dims)
    cut_groups = _groups(mesh, ("pod",)) if sync == "dense" and fsdp else []
    if fsdp:
        # the clip's group: the data x model ranks, a piece several of them
        # hold alike counted once
        clip_group = mesh_group(mesh, ("data", shr.MODEL_AXIS))
        clip_owner = shr.owner_flags(shr.param_specs(abstract, fsdp=True, mesh=mesh),
                                     mesh, ("data", shr.MODEL_AXIS))
    own = _own_whole(sync, cfg, mesh)

    def _apply(params, opt, update, step):
        lr = sgd.lr_at(step, tcfg)
        cut = _cut_leaves(params, sizes) if sizes is not None else None
        group, owner = (clip_group, clip_owner) if fsdp else (tp, None)
        return sgd.apply_updates(params, update, opt, lr=lr, momentum=tcfg.momentum,
                                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                                 group=group, cut=cut, owner=owner)

    if sync == "dense":

        def step_fn(state: TrainState, batch):
            with trace.annotate_scope("round.client_grads"):
                (loss, _), grads = _value_and_grad(loss_fn, state.params, batch)
                if loss_groups:  # the ranks' shares add up to the global loss
                    grads = _psum_tree(grads, loss_groups, cut_groups, gathered)
                    loss = _psum_(loss, loss_groups)
            with torch.no_grad(), trace.annotate_scope("round.apply_update"):
                params, opt = _apply(state.params, state.opt, grads, state.step)
            total = torch.tensor(sum(sizes) if sizes else tree_size(state.params),
                                 dtype=torch.int64)
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
    # the group a row's segments are cut over: a pod's data x model ranks
    # where FSDP cuts the state over data (gmf_pod), else the model group
    if fsdp and not own:
        row_axes, row_group = ("data", shr.MODEL_AXIS), mesh_group(mesh, ("data", shr.MODEL_AXIS))
    else:
        row_axes, row_group = (shr.MODEL_AXIS,), tp
    # every rank of the row's group: its owner flags (where FSDP cuts the
    # state over data) and its pieces' places in their whole leaves
    row_places = (shr.places(abstract, shr.param_specs(abstract, fsdp=fsdp and not own, mesh=mesh),
                             mesh, row_axes, owners=fsdp and not own)
                  if row_group is not None else None)

    def step_fn(state: TrainState, batch):
        with trace.annotate_scope("round.client_grads"):
            if own:  # each client's whole gradient from FSDP's gathers
                (loss, _), grads = _value_and_grad(loss_fn, state.params, batch, dims)
            else:
                (loss, _), grads = _value_and_grad(loss_fn, state.params, batch)
        with torch.no_grad():
            with trace.annotate_scope("round.client_compress"):
                # gmf_data: the client's whole gradient; else the rank's pieces
                layout = FlatLayout.of(grads)
                if row_group is not None:
                    layout = layout.over(row_group, sizes, row_places)
                gbar_in, sstate_in = state.gbar, state.sstate
                if own:  # the broadcast and the server state whole over data
                    pieces = FlatLayout.of(state.params)
                    gbar_in = _over_data(gbar_in, pieces, layout, dims, mesh, True)
                    sstate_in = ServerState(*(_over_data(f, pieces, layout, dims, mesh, True)
                                              for f in sstate_in))
                if loss_groups and fsdp:  # gmf_pod: the pod's gradient, reduce-scattered
                    grads = _psum_tree(grads, loss_groups, cut_groups, gathered)
                # this shard's [1, N] row per dtype group
                flat = layout.flatten(tree_map(lambda g: g.unsqueeze(0), grads))
                del grads
                if loss_groups:  # gmf_pod: the pod's gradient and loss
                    if not fsdp:
                        flat = tree_map(lambda g: _psum_(g, loss_groups), flat)
                    loss = _psum_(loss, loss_groups)
                G, cstate, infos = scheme.client_compress(state.cstate, flat, gbar_in,
                                                          state.step, layout=layout)
                del flat
            with trace.annotate_scope("round.server_aggregate"):
                # the rank's one row is its own sum (a sum of one value rounds
                # back to it), where torch's bf16 sum would hold a float32 row
                g_sum = tree_map(lambda x: x[0] if x.shape[0] == 1 else torch.sum(x, dim=0), G)
                del G
                if sync_group is not None:  # the one cross-shard collective
                    g_sum = tree_map(lambda x: _psum_(x, [sync_group]), g_sum)
                lr = sgd.lr_at(state.step, tcfg)
                gbar, sstate, ainfo = scheme.server_aggregate(sstate_in, g_sum, float(n),
                                                              layout=layout, lr=lr)
            update = layout.unflatten(gbar)
            if own:  # this rank's data slice of the whole update, and of the state kept
                update = _data_pieces(update, dims, mesh)
                gbar = _over_data(gbar, layout, pieces, dims, mesh, False)
                sstate = ServerState(*(_over_data(f, layout, pieces, dims, mesh, False)
                                       for f in sstate))
            with trace.annotate_scope("round.apply_update"):
                if scheme.owns_lr:
                    # FetchSGD: lr already entered the sketch-space error
                    # feedback — the broadcast (the rank's pieces of it over a
                    # mesh) is the finished update, applied un-scaled
                    params, opt = sgd.apply_updates(state.params, update, state.opt, lr=1.0,
                                                    momentum=tcfg.momentum)
                else:
                    params, opt = _apply(state.params, state.opt, update, state.step)
        new_gbar = gbar if scheme.uses_m else state.gbar
        upload_nnz = infos.upload_nnz
        if sync_group is not None:  # the mean over shards; the counts in shard order
            loss = _psum_(loss, [sync_group]) / n
            upload_nnz = col.gather_cat(upload_nnz, sync_group, 0)
        metrics = {"loss": loss, "upload_nnz": upload_nnz,
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
        return _whole_logits(cfg, logits[..., -1, :].float(), ctx), cache

    return prefill


def _whole_logits(cfg, logits, ctx):
    """Logits over the whole vocabulary: gathered over the model group
    where it cuts them (the rank's columns)."""
    tp = ctx.get("tp")
    if tp is None or logits.shape[-1] == cfg.vocab_size:
        return logits
    return col.gather_from(logits, tp, -1)


def make_serve_step(cfg, mesh=None):
    """``serve(params, cache, tokens, pos) -> (next_tokens, logits, cache)``
    — one greedy decode step, over every codebook for audio (the cache is
    updated in place)."""
    ctx = _model_ctx(cfg, mesh)

    @torch.no_grad()
    def serve(params, cache, tokens, pos):
        logits, cache = transformer.decode_step(cfg, params, cache, tokens, pos, ctx=ctx)
        logits = _whole_logits(cfg, logits, ctx)
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
    Over a mesh whose model axis is over 1 the pool holds the rank's kv
    heads where they divide the axis (``sharding.pool_specs``) and the
    logits come back whole.
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
        last = _whole_logits(cfg, logits[:, 0].float(), ctx)  # (1, V)
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
    so the decode loop reads nothing back from the device. Over a model
    axis the attention runs on the rank's heads (its pool's) and the logits
    come back whole.
    """
    ctx = _model_ctx(cfg, mesh)

    @torch.no_grad()
    def serve(params, pool, tables, lengths, tokens):
        c = dict(ctx, paged={"tables": tables, "codec": codec})
        logits, pool = transformer.decode_step(cfg, params, pool, tokens, lengths, ctx=c)
        logits = _whole_logits(cfg, logits, c)
        return torch.argmax(logits, dim=-1), logits, pool

    return serve
