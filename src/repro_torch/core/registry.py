"""Scheme registry: named presets composing the compression stages.

``resolve(cfg)`` binds a preset's ``SchemeSpec`` (after any per-config
stage overrides) to a ``CompressionConfig`` and returns a ``Scheme``, the
object the round engine calls. The ported presets are the paper's scheme
family (``none``, ``dgc``, ``gmc``, ``dgcwgm``, ``dgcwgmf``), the
``topk`` and ``randomk`` ablations, ``fetchsgd`` (a count-sketch upload
with momentum and error feedback in sketch space at the server,
``core/sketch.py``), ``dgcwgmf_dl`` (a top-k downlink with a server
residual), ``adaptive_dgcwgmf`` (per-client rates), ``async_dgcwgmf``
(``gmf_damp`` staleness for the async buffered engine) and
``hier_dgcwgmf`` (a DGCwGMF aggregator tier under the hierarchical
topology, ``resolve_tier``).

Registering a scheme is one call, and ``python -m
repro_torch.core.registry`` lists every stage and preset::

    register_preset("topk_ef", SchemeSpec(selector="topk", compensator="ef"),
                    doc="top-k with plain error feedback")

The client axis is explicit and the state is flat: ``Scheme.client_compress``
takes the ``[k, N]`` state and gradient stacks of k clients
(``utils/flat.py``) with their layout and compresses them all at once (the
reference compresses one client's tree and is vmapped). A tree of mixed
dtypes (``GroupedLayout``) runs the same steps once per dtype group, with
every flat quantity a tuple of one stack per group; the counts add up
over the groups. Each group holds whole leaves, each keyed and indexed by
its place in the whole tree (``FlatLayout.leaf_ids``, ``tree_index``), so
this is the reference's per-leaf computation for every stage that works
leaf by leaf, random-k, the stochastic wire, the rotation and per-client
rates among them. The stages that work across leaves work across the
groups: global top-k (uplink and downlink) takes one threshold over
every group's scores, and FetchSGD sends one sketch of the whole tree,
keeps one sketch-space momentum and error at the server and un-sketches
its heavy hitters into each group in the group's dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import rate_control as _rate_control  # noqa: F401  registers its stages
from repro_torch.core import sketch as count_sketch
from repro_torch.core import stages
from repro_torch.core.accounting import CostModel
from repro_torch.core.fusion import rows
from repro_torch.core.stages import AggregateInfo, CompressInfo, StageCtx
from repro_torch.core.state import (
    ClientState,
    ServerState,
    init_client_state,
    init_server_state,
)
from repro_torch.utils import scalar, tree_nnz
from repro_torch.utils.flat import FlatLayout, GroupedLayout
from repro_torch.utils.quant import roundtrip_q8_segments


def _group(x, i):
    """Group ``i``'s part of a flat quantity: ``x[i]`` of a tuple; an
    unused ``{}`` (or None) field stays as it is."""
    return x[i] if isinstance(x, tuple) else x


def _gather(parts):
    """Per-group results -> one tuple per field, unused fields kept ``{}``."""
    return parts[0] if isinstance(parts[0], dict) and not parts[0] else tuple(parts)


# Presets of the reference not ported yet -> the ROADMAP item that ports them.
NOT_PORTED_PRESETS: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """Eight stage names composing one scheme (``wire="auto"`` resolves to
    the config's ``wire_dtype``), plus ``tier``: the preset the aggregator
    tier re-compresses with under ``topology="hierarchical"`` (checked by
    ``resolve_tier``, since presets register through this class; ``none``,
    the dense float32 passthrough, makes ``groups=1`` the star bitwise)."""

    selector: str = "topk"
    compensator: str = "none"
    fusion: str = "none"
    wire: str = "auto"
    rotation: str = "none"
    downlink: str = "none"
    staleness: str = "none"
    rate_control: str = "fixed"
    tier: str = "none"

    def __post_init__(self):
        stages.get_stage("selector", self.selector)
        stages.get_stage("compensator", self.compensator)
        stages.get_stage("fusion", self.fusion)
        if self.wire != "auto":
            stages.get_stage("wire", self.wire)
        stages.get_stage("rotation", self.rotation)
        stages.get_stage("downlink", self.downlink)
        stages.get_stage("staleness", self.staleness)
        stages.get_stage("rate_control", self.rate_control)


PRESETS: dict[str, SchemeSpec] = {}
PRESET_DOCS: dict[str, str] = {}


def register_preset(name: str, spec: SchemeSpec, *, doc: str = "",
                    override: bool = False) -> None:
    if name in PRESETS and not override:
        raise ValueError(f"preset {name!r} is already registered ({PRESETS[name]}); pass "
                         f"register_preset(..., override=True) to replace it")
    PRESETS[name] = spec
    PRESET_DOCS[name] = doc
    # re-registering a name invalidates the Schemes resolved from it (the
    # built-in registrations below run before ``resolve`` exists)
    cached_resolve = globals().get("resolve")
    if cached_resolve is not None:
        cached_resolve.cache_clear()


def available_presets() -> tuple[str, ...]:
    return tuple(PRESETS)


def check_preset(name: str) -> None:
    """Raise for a preset that is not registered here."""
    if name in PRESETS:
        return
    if name in NOT_PORTED_PRESETS:
        raise NotImplementedError(
            f"scheme {name!r} is not ported yet: {NOT_PORTED_PRESETS[name]}")
    raise ValueError(f"unknown scheme {name!r}; registered presets: {available_presets()}")


register_preset("none", SchemeSpec(selector="dense"),
                doc="dense FedSGD (no compression; accounting baseline)")
register_preset("topk", SchemeSpec(selector="topk"),
                doc="plain top-k sparsification, no compensation (ablation)")
register_preset("randomk", SchemeSpec(selector="randomk", compensator="ef"),
                doc="random-k with error feedback (ablation: magnitude selection matters)")
register_preset("dgc", SchemeSpec(selector="topk", compensator="dgc"),
                doc="Deep Gradient Compression (momentum correction + EF)")
register_preset("gmc", SchemeSpec(selector="topk", compensator="ef", fusion="gmc"),
                doc="Global Momentum Compression (global momentum in the compensation)")
register_preset("dgcwgm", SchemeSpec(selector="topk", compensator="dgc", fusion="server_gm"),
                doc="DGC + server-side global momentum (paper problem 2.1)")
register_preset("dgcwgmf", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf"),
                doc="DGC + Global Momentum Fusion in the selection (the paper)")
register_preset("fetchsgd", SchemeSpec(selector="sketch", fusion="server_gm"),
                doc="FetchSGD (Rothchild et al. 2020): count-sketch upload; momentum + "
                    "error feedback in sketch space at the server; k-sparse heavy-hitter "
                    "download")
register_preset("dgcwgmf_dl", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf",
                                         downlink="topk"),
                doc="DGCwGMF plus a top-k downlink with server-side error feedback")
register_preset("async_dgcwgmf", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf",
                                            staleness="gmf_damp"),
                doc="DGCwGMF for the asynchronous buffered engine (FLConfig.backend='async'): "
                    "late payloads are poly-damped and the server-held global momentum fills "
                    "the gap (gmf_damp staleness). Identical to dgcwgmf under any synchronous "
                    "backend and at zero delay")
register_preset("hier_dgcwgmf", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf",
                                           tier="dgcwgmf"),
                doc="DGCwGMF at the leaf tier plus a DGCwGMF re-compression at the aggregator "
                    "tier (topology=hierarchical): GMF momentum and EF residuals are held per "
                    "tier, so fusion compensates where the compression error is introduced")
register_preset("adaptive_dgcwgmf", SchemeSpec(selector="topk", compensator="dgc",
                                               fusion="gmf", rate_control="adaptive"),
                doc="DGCwGMF with the adaptive per-client rate controller "
                    "(core/rate_control.py)")


class Scheme:
    """A compression scheme bound to one ``CompressionConfig``."""

    def __init__(self, cfg, spec: SchemeSpec):
        self.cfg = cfg
        self.spec = spec
        self.name = cfg.scheme
        self.selector = stages.get_stage("selector", spec.selector)
        self.compensator = stages.get_stage("compensator", spec.compensator)
        self.fusion = stages.get_stage("fusion", spec.fusion)
        wire_name = cfg.wire_dtype if spec.wire == "auto" else spec.wire
        self.wire = stages.get_stage("wire", wire_name)
        self.rotation = stages.get_stage("rotation", spec.rotation)
        self.downlink = stages.get_stage("downlink", spec.downlink)
        self.staleness = stages.get_stage("staleness", spec.staleness)
        self.rate_control = stages.get_stage("rate_control", spec.rate_control)

    @property
    def is_sketch(self) -> bool:
        return self.selector.sketch

    @property
    def uses_u(self) -> bool:
        return self.compensator.uses_u

    @property
    def uses_v(self) -> bool:
        return self.compensator.uses_v

    @property
    def uses_m(self) -> bool:
        return self.fusion.uses_m

    @property
    def server_momentum(self) -> bool:
        return self.fusion.server_momentum and not self.is_sketch

    @property
    def downlink_residual(self) -> bool:
        return self.downlink.uses_residual

    @property
    def owns_lr(self) -> bool:
        """True when the server step applies the learning rate itself and the
        broadcast is the finished update (FetchSGD: lr enters the
        sketch-space error feedback)."""
        return self.is_sketch

    @property
    def rate_adaptive(self) -> bool:
        """True when the rate controller varies per-client rates: the engine
        threads rates (and wire levels) into ``client_compress`` only then."""
        return self.rate_control.name != "fixed"

    @property
    def staleness_momentum(self) -> bool:
        """True when the staleness policy reads the server-held global
        momentum (the async engine then keeps the EMA of broadcasts)."""
        return self.staleness.uses_momentum

    def staleness_weight(self, gaps):
        """The policy's float32 weights for payloads of ages ``gaps`` ([B])."""
        return self.staleness.weight(self.cfg, gaps)

    def apply_staleness(self, payloads, gaps, gmom=None):
        """Weigh a ``[B, W]`` buffer of payloads (W is N, or rows·cols under
        a sketch; one ``[B, N_g]`` buffer per dtype group of a tree of mixed
        dtypes) by their ``[B]`` gaps, a device tensor; ``gmom`` is the
        server-held global momentum, flat ``[N]`` (a tuple per group). The
        ``none`` policy returns the buffer itself (bitwise), which pins the
        async engine to the synchronous ones at zero delay."""
        gmom = {} if gmom is None else gmom
        if isinstance(payloads, tuple):
            return tuple(self.staleness.combine(self.cfg, b, gaps, _group(gmom, i))
                         for i, b in enumerate(payloads))
        return self.staleness.combine(self.cfg, payloads, gaps, gmom)

    def init_states(self, params) -> tuple[ClientState, ServerState]:
        """One client's zero state (flat ``[N]`` fields, no client axis) and
        the server state. Under a sketch the client state is empty and the
        server's momentum holds ``s_mom`` and ``s_err``, ``[rows, cols]``."""
        if self.is_sketch:
            residual = init_server_state(params, use_momentum=False,
                                         use_residual=self.downlink_residual).residual
            zeros = lambda: torch.zeros(self.cfg.sketch_rows, self.cfg.sketch_cols,
                                        dtype=torch.float32,
                                        device=FlatLayout.of(params).device)
            return (ClientState(u={}, v={}, m={}),
                    ServerState(momentum={"s_mom": zeros(), "s_err": zeros()},
                                residual=residual))
        client = init_client_state(
            params, use_u=self.uses_u, use_v=self.uses_v, use_m=self.uses_m)
        server = init_server_state(
            params, use_momentum=self.server_momentum,
            use_residual=self.downlink_residual)
        return client, server

    def cost_model(self) -> CostModel:
        """Value bytes from the wire codec; sketch uploads are charged value
        bytes only (the sketch's shape is fixed, so no indices)."""
        return CostModel(value_bytes=self.wire.value_bytes,
                         upload_dense_values=self.is_sketch)

    def client_compress(self, state: ClientState, grad, gbar_prev, round_idx,
                        local_steps=1.0, mean_steps=1.0, tau_override=None, rates=None,
                        wire_levels=None, client_ids=None, *, layout):
        """One compression step for a stack of k clients (paper Algorithm 1
        lines 6-13). ``state`` fields and ``grad`` are flat ``[k, N]``
        stacks of the params ``layout`` describes; ``gbar_prev`` is last
        round's broadcast, ``[N]``; ``local_steps`` / ``mean_steps`` are
        scalars or ``[k]``. ``rates`` (float32 ``[k]``) and ``wire_levels``
        (int ``[k]``, 1 = drop to int8) are the adaptive rate controller's,
        threaded only under it: per-client rates take the staged path with
        per-client keep counts, as the reference sends a traced rate.
        ``client_ids`` (int ``[k]``, the clients' global ids) key a
        stochastic wire's draws per client. Returns the payload stack
        (``[k, N]``; ``[k, rows·cols]`` under a sketch), the new state stack
        and a ``CompressInfo`` whose ``upload_nnz`` is ``[k]``."""
        cfg = self.cfg
        if self.is_sketch:
            return self._sketch_client(state, grad, layout)
        if isinstance(layout, GroupedLayout):
            return self._grouped_client(state, grad, gbar_prev, round_idx, local_steps,
                                        mean_steps, tau_override, rates, wire_levels,
                                        client_ids, layout)
        ctx = StageCtx(round_idx=round_idx, gbar_prev=gbar_prev,
                       local_steps=local_steps, mean_steps=mean_steps,
                       tau_override=tau_override, layout=layout, client_ids=client_ids)
        ops = stages.elementwise_ops(cfg)
        total = layout.full_total

        m, extra = self.fusion.pre(cfg, state.m, gbar_prev)
        value, u, v = self.compensator.accumulate(cfg, ops, state.u, state.v, grad, extra)

        # The fused kernel implements exactly the topk + dgc + gmf
        # composition; any other composition takes the staged path.
        fused = getattr(self.fusion, "fused_compress", None)
        if (cfg.use_kernels and fused is not None and cfg.per_tensor and rates is None
                and self.selector.name == "topk"
                and self.compensator.uses_u and self.compensator.uses_v):
            g_out, u, v, m, masks = fused(cfg, u, v, m, ctx)
            nnz = layout.nnz(masks)
        elif self.selector.dense:
            g_out, u, v = self.compensator.extract(cfg, ops, u, v, value, None)
            nnz = torch.full((grad.shape[0],), total, dtype=torch.int64, device=grad.device)
        else:
            if self.selector.needs_scores:
                ref, m = self.fusion.scores(cfg, value, m, ctx)
            else:
                ref = value
            masks = self.selector.select(cfg, ref, round_idx, layout, rates=rates)
            g_out, u, v = self.compensator.extract(cfg, ops, u, v, value, masks)
            nnz = layout.nnz(masks)

        return self._finish(cfg, g_out, ClientState(u=u, v=v, m=m), nnz, layout, wire_levels,
                            ctx)

    def _finish(self, cfg, g_out, state: ClientState, nnz, layout, wire_levels, ctx):
        """The wire step of a ``[k, N]`` payload stack of ``layout`` and its
        ``CompressInfo`` (the rotation densifies: the padded rotated leaves
        cross the wire)."""
        if not self.rotation.identity:
            nnz = torch.full((g_out.shape[0],), sum(self.rotation.wire_size(n)
                                                    for n in layout.full_sizes),
                             dtype=torch.int64, device=g_out.device)
        g_out, new_state = self._encode_payload(cfg, g_out, state, layout, wire_levels, ctx)
        return g_out, new_state, CompressInfo(upload_nnz=nnz, total_params=layout.full_total)

    def _grouped_client(self, state, grad, gbar_prev, round_idx, local_steps, mean_steps,
                        tau_override, rates, wire_levels, client_ids, layout):
        """``client_compress`` over the dtype groups of a ``GroupedLayout``:
        payloads and state fields come back as tuples, the upload counts
        summed over the groups. Each group holds whole leaves keyed by their
        tree places (``FlatLayout.leaf_ids``), so every stage that works leaf
        by leaf runs each group on its own; global top-k scores each group
        and selects once over the whole tree (``grouped_topk_masks``)."""
        cfg = self.cfg
        if self.selector.name == "topk" and not cfg.per_tensor:
            outs = self._grouped_across(state, grad, gbar_prev, round_idx, local_steps,
                                        mean_steps, tau_override, rates, wire_levels,
                                        client_ids, layout)
        else:
            outs = [self.client_compress(
                ClientState(*(_group(f, i) for f in state)), grad[i], _group(gbar_prev, i),
                round_idx, local_steps, mean_steps, tau_override, rates, wire_levels,
                client_ids, layout=sub) for i, sub in enumerate(layout.groups)]
        payload = tuple(o[0] for o in outs)
        new_state = ClientState(*(_gather([o[1][f] for o in outs]) for f in range(3)))
        nnz = sum(o[2].upload_nnz for o in outs)
        return payload, new_state, CompressInfo(upload_nnz=nnz, total_params=layout.full_total)

    def _grouped_across(self, state, grad, gbar_prev, round_idx, local_steps, mean_steps,
                        tau_override, rates, wire_levels, client_ids, layout):
        """Global top-k over a ``GroupedLayout``: each group accumulated and
        scored, one selection over every group's scores, then each group's
        extract and wire -> one (payload, state, info) per group."""
        cfg = self.cfg
        ops = stages.elementwise_ops(cfg)
        ctxs, accs, refs = [], [], []
        for i, sub in enumerate(layout.groups):
            ctx = StageCtx(round_idx=round_idx, gbar_prev=_group(gbar_prev, i),
                           local_steps=local_steps, mean_steps=mean_steps,
                           tau_override=tau_override, layout=sub, client_ids=client_ids)
            st = ClientState(*(_group(f, i) for f in state))
            m, extra = self.fusion.pre(cfg, st.m, ctx.gbar_prev)
            value, u, v = self.compensator.accumulate(cfg, ops, st.u, st.v, grad[i], extra)
            ref, m = self.fusion.scores(cfg, value, m, ctx)
            ctxs.append(ctx)
            accs.append((value, u, v, m))
            refs.append(ref)
        masks = self.selector.select(cfg, tuple(refs), round_idx, layout, rates=rates)
        outs = []
        for ctx, (value, u, v, m), mk in zip(ctxs, accs, masks, strict=True):
            g_out, u, v = self.compensator.extract(cfg, ops, u, v, value, mk)
            outs.append(self._finish(cfg, g_out, ClientState(u=u, v=v, m=m), ctx.layout.nnz(mk),
                                     ctx.layout, wire_levels, ctx))
        return outs

    def _encode_payload(self, cfg, g_out, state: ClientState, layout, wire_levels, ctx):
        """Wire-encode the payload stack: rotation forward, the wire round
        trip (clients at wire level 1, the adaptive controller's int8 drop,
        take the int8 round trip instead of the scheme's codec), rotation
        inverse, then every client's residual G − wire(G) folds into V, as
        the reference's per-client ``_encode_payload`` does. With the
        identity rotation and no levels this is the wire stage's own
        ``encode``."""
        if self.rotation.identity and wire_levels is None:
            return self.wire.encode(cfg, g_out, state, layout, ctx)

        def through(y, wire_layout):
            y_wire = self.wire.roundtrip_ctx(cfg, y, wire_layout, ctx)
            if wire_levels is None:
                return y_wire
            return torch.where(rows(wire_levels, y) > 0, roundtrip_q8_segments(y, wire_layout),
                               y_wire)

        if self.rotation.by_leaf(layout):
            g_wire = self.rotation.roundtrip_by_leaf(cfg, g_out, ctx.round_idx, layout, through)
        else:
            y, wire_layout = self.rotation.forward(cfg, g_out, ctx.round_idx, layout)
            g_wire = self.rotation.inverse(cfg, through(y, wire_layout), ctx.round_idx, layout)
        # the rotation works in float32; its inverse lands in the payload's
        # dtype, as the reference's ``astype(like.dtype)`` does
        g_wire = g_wire.to(g_out.dtype)
        return g_wire, ClientState(u=state.u, v=stages.fold_residual(state.v, g_out, g_wire),
                                   m=state.m)

    def _sketch_client(self, state: ClientState, grad, layout):
        """FetchSGD's upload: each client's count sketch of its whole
        gradient, ``[k, rows·cols]``, through the wire; rows·cols values a
        client. Over a layout cut across a group each rank sketches its
        entries by their whole-tree indices and the partial sketches are
        summed over the group (``count_sketch.sketch_pieces``); a tree of
        mixed dtypes sends one sketch of the whole tree, its groups'
        entries hashed by their whole-tree indices."""
        cfg = self.cfg
        size = cfg.sketch_rows * cfg.sketch_cols
        if count_sketch.by_pieces(layout, cfg.sketch_rows):
            payload = count_sketch.sketch_pieces(grad, layout, cfg.sketch_rows, cfg.sketch_cols)
        else:
            payload = count_sketch.sketch(grad, cfg.sketch_rows, cfg.sketch_cols)
        payload, state = self.wire.encode(cfg, payload.reshape(-1, size), state,
                                          FlatLayout.of_sizes([size], payload.device))
        nnz = torch.full((payload.shape[0],), size, dtype=torch.int64, device=payload.device)
        return payload, state, CompressInfo(upload_nnz=nnz, total_params=layout.full_total)

    def server_aggregate(self, server_state: ServerState, g_sum, num_clients, *, layout=None,
                         lr=None):
        """Average the summed payloads, apply the fusion stage's server
        transform and the downlink stage; returns the ``[N]`` broadcast. The
        ``topk`` downlink selects per leaf of ``layout``. A sketch scheme
        (``owns_lr``) needs ``layout`` (for N) and ``lr``, which enters its
        sketch-space error feedback."""
        cfg = self.cfg
        if self.is_sketch:
            bcast, new_momentum, union_nnz = self._sketch_server(
                server_state, g_sum, num_clients, layout=layout, lr=lr)
        elif isinstance(layout, GroupedLayout):  # each dtype group's [N_g] on its own
            outs = [self._server_mean(_group(server_state.momentum, i), g_sum[i], num_clients,
                                      sub) for i, sub in enumerate(layout.groups)]
            bcast, new_momentum = tuple(o[0] for o in outs), _gather([o[1] for o in outs])
            union_nnz = sum(o[2] for o in outs)
        else:
            # A divisor on the device: CUDA divides by a Python scalar as a
            # multiplication by its reciprocal, one rounding off x / n.
            gbar = g_sum / scalar(num_clients, g_sum.device, g_sum.dtype)
            if self.server_momentum:
                bcast, new_momentum = self.fusion.server(cfg, server_state.momentum, gbar)
            else:
                bcast, new_momentum = gbar, server_state.momentum
            union_nnz = tree_nnz(bcast) if layout is None else layout.nnz(bcast)
        total = bcast.numel() if layout is None else layout.full_total
        if self.downlink.uses_residual and layout is None:
            raise ValueError(f"the {self.downlink.name} downlink needs the params' layout: "
                             f"server_aggregate(..., layout=...)")
        bcast, residual, down_nnz = self.downlink.apply(
            cfg, self.wire, server_state.residual, bcast, union_nnz, layout)
        info = AggregateInfo(download_nnz=down_nnz, total_params=total, union_nnz=union_nnz)
        return bcast, ServerState(momentum=new_momentum, residual=residual), info

    def _server_mean(self, momentum, g_sum, num_clients, layout):
        """One dtype group's mean payload through the server fusion ->
        (broadcast, momentum, union nnz)."""
        gbar = g_sum / scalar(num_clients, g_sum.device, g_sum.dtype)
        if self.server_momentum:
            bcast, momentum = self.fusion.server(self.cfg, momentum, gbar)
        else:
            bcast = gbar
        return bcast, momentum, layout.nnz(bcast)

    def _sketch_server(self, server_state: ServerState, g_sum, num_clients, *, layout, lr):
        """FetchSGD's server: the averaged sketch into the sketch-space
        momentum, ``lr`` times that into the sketch-space error, the top
        k = max(1, ⌊sketch_k_frac·N⌋) heavy hitters of the error out as the
        ``[N]`` broadcast and their sketch taken back off the error. N is
        the whole model's size: over a layout cut across a group each rank
        broadcasts its piece of the hitters (``count_sketch.hitters_pieces``)."""
        cfg = self.cfg
        if lr is None or layout is None:
            raise ValueError("the fetchsgd scheme folds lr into the server-side sketch error "
                             "feedback and un-sketches into the params' layout: call "
                             "server_aggregate(..., layout=..., lr=...) (the round engine "
                             "does)")
        n_rows, n_cols = cfg.sketch_rows, cfg.sketch_cols
        n = layout.full_total
        k = max(1, int(cfg.sketch_k_frac * n))
        s_agg = g_sum.reshape(n_rows, n_cols) / scalar(num_clients, g_sum.device, g_sum.dtype)
        s_mom = cfg.sketch_momentum * server_state.momentum["s_mom"] + s_agg
        s_err = server_state.momentum["s_err"] + lr * s_mom
        if count_sketch.by_pieces(layout, n_rows):  # each rank its piece of the update
            delta = count_sketch.hitters_pieces(s_err, layout, k)
            rows = delta[None] if layout.groups is None else tuple(d[None] for d in delta)
            s_err = s_err - count_sketch.sketch_pieces(rows, layout, n_rows, n_cols)[0]
            if layout.groups is not None:  # each group's hitters in its dtype
                delta = tuple(d.to(sub.dtype) for d, sub in zip(delta, layout.groups,
                                                                strict=True))
        else:
            _, _, delta = count_sketch.heavy_hitters(s_err, n, k)
            s_err = s_err - count_sketch.sketch(delta, n_rows, n_cols)
        return (delta, {"s_mom": s_mom, "s_err": s_err},
                torch.full((), k, dtype=torch.int64, device=g_sum.device))


@functools.lru_cache(maxsize=None)
def resolve(cfg) -> Scheme:
    """CompressionConfig -> bound Scheme (cached per config)."""
    check_preset(cfg.scheme)
    spec = PRESETS[cfg.scheme]
    overrides = {}
    for kind in stages.STAGE_KINDS:
        name = getattr(cfg, f"{kind}_stage")
        if name is not None:
            overrides[kind] = name
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return Scheme(cfg, spec)


# ---------------------------------------------------------------------------
# Listing entry point: PYTHONPATH=src python -m repro_torch.core.registry
# ---------------------------------------------------------------------------


def resolve_tier(cfg) -> Scheme:
    """CompressionConfig -> the aggregator tier's Scheme under
    ``topology="hierarchical"``: the preset ``cfg.tier_scheme``, else the
    leaf preset's ``SchemeSpec.tier`` slot, bound to the leaf's
    hyper-parameters with ``rate=cfg.tier_rate`` and no stage overrides
    (those belong to the leaf composition)."""
    spec = PRESETS.get(cfg.scheme)
    name = cfg.tier_scheme
    if name is None:
        name = spec.tier if spec is not None else "none"
    if name not in PRESETS:
        raise ValueError(f"unknown tier scheme {name!r}; registered presets: "
                         f"{available_presets()}")
    overrides = {f"{kind}_stage": None for kind in stages.STAGE_KINDS}
    return resolve(dataclasses.replace(cfg, scheme=name, rate=cfg.tier_rate, tier_scheme=None,
                                       **overrides))


def describe() -> str:
    lines = ["Compression-scheme registry", "", "Stages:"]
    for kind in stages.STAGE_KINDS:
        lines.append(f"  {kind}:")
        for name, obj in stages.REGISTRY[kind].items():
            desc = getattr(obj, "description", "") or ""
            lines.append(f"    {name:12s} {desc}")
    lines += ["", "Presets (scheme -> selector / compensator / fusion / "
                  "wire / downlink / staleness):"]
    for name, spec in PRESETS.items():
        extras = ""
        if spec.rotation != "none":
            extras += f" / rot={spec.rotation}"
        if spec.rate_control != "fixed":
            extras += f" / rc={spec.rate_control}"
        if spec.tier != "none":
            extras += f" / tier={spec.tier}"
        lines.append(
            f"  {name:13s} {spec.selector:8s} / {spec.compensator:6s} / "
            f"{spec.fusion:9s} / {spec.wire:7s} / {spec.downlink:6s} / "
            f"{spec.staleness}{extras}")
        if PRESET_DOCS.get(name):
            lines.append(f"             {PRESET_DOCS[name]}")
    lines += ["",
              "Override stages per run: CompressionConfig(scheme=<preset>, "
              "selector_stage=..., compensator_stage=..., fusion_stage=..., "
              "wire_stage=..., rotation_stage=..., downlink_stage=..., "
              "staleness_stage=..., rate_control_stage=...)"]
    return "\n".join(lines)


def main() -> int:
    print(describe())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
