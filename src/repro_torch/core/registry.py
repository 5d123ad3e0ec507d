"""Scheme registry: named presets composing the compression stages.

``resolve(cfg)`` binds a preset's ``SchemeSpec`` (after any per-config
stage overrides) to a ``CompressionConfig`` and returns a ``Scheme``, the
object the round engine calls. The ported presets are the paper's scheme
family on the synchronous star round (``none``, ``dgc``, ``gmc``,
``dgcwgm``, ``dgcwgmf``), the ``topk`` ablation, ``dgcwgmf_dl`` (a top-k
downlink with a server residual) and ``adaptive_dgcwgmf`` (per-client
rates). The reference's other presets raise ``NotImplementedError``
naming the ROADMAP item that ports them.

The client axis is explicit and the state is flat: ``Scheme.client_compress``
takes the ``[k, N]`` state and gradient stacks of k clients
(``utils/flat.py``) with their layout and compresses them all at once (the
reference compresses one client's tree and is vmapped).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import rate_control as _rate_control  # noqa: F401  registers its stages
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
from repro_torch.utils.quant import roundtrip_q8_segments

OTHER_KINDS = stages.OTHER_KINDS
ENGINES = stages.ENGINES
NOT_PORTED_PRESETS = {
    "randomk": OTHER_KINDS,
    "fetchsgd": OTHER_KINDS,
    "async_dgcwgmf": ENGINES,
    "hier_dgcwgmf": ENGINES,
}


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """Eight stage names composing one scheme (``wire="auto"`` resolves to
    the config's ``wire_dtype``), plus the reference's aggregator-tier slot."""

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
        if self.tier != "none":
            raise NotImplementedError(f"aggregator tiers are not ported yet: {ENGINES}")


PRESETS: dict[str, SchemeSpec] = {}


def register_preset(name: str, spec: SchemeSpec) -> None:
    if name in PRESETS:
        raise ValueError(f"preset {name!r} is already registered ({PRESETS[name]})")
    PRESETS[name] = spec
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


# dense FedSGD (no compression; accounting baseline)
register_preset("none", SchemeSpec(selector="dense"))
# plain top-k sparsification, no compensation (ablation)
register_preset("topk", SchemeSpec(selector="topk"))
# Deep Gradient Compression (momentum correction + EF)
register_preset("dgc", SchemeSpec(selector="topk", compensator="dgc"))
# Global Momentum Compression (global momentum in the compensation)
register_preset("gmc", SchemeSpec(selector="topk", compensator="ef", fusion="gmc"))
# DGC + server-side global momentum (paper problem 2.1)
register_preset("dgcwgm", SchemeSpec(selector="topk", compensator="dgc", fusion="server_gm"))
# DGC + Global Momentum Fusion in the selection (the paper)
register_preset("dgcwgmf", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf"))
# DGCwGMF plus a top-k downlink with server-side error feedback
register_preset("dgcwgmf_dl", SchemeSpec(selector="topk", compensator="dgc", fusion="gmf",
                                         downlink="topk"))
# DGCwGMF with the adaptive per-client rate controller (core/rate_control.py)
register_preset("adaptive_dgcwgmf", SchemeSpec(selector="topk", compensator="dgc",
                                               fusion="gmf", rate_control="adaptive"))


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
        return self.fusion.server_momentum

    @property
    def downlink_residual(self) -> bool:
        return self.downlink.uses_residual

    @property
    def rate_adaptive(self) -> bool:
        """True when the rate controller varies per-client rates: the engine
        threads rates (and wire levels) into ``client_compress`` only then."""
        return self.rate_control.name != "fixed"

    def init_states(self, params) -> tuple[ClientState, ServerState]:
        """One client's zero state (flat ``[N]`` fields, no client axis) and
        the server state."""
        client = init_client_state(
            params, use_u=self.uses_u, use_v=self.uses_v, use_m=self.uses_m)
        server = init_server_state(
            params, use_momentum=self.server_momentum,
            use_residual=self.downlink_residual)
        return client, server

    def cost_model(self) -> CostModel:
        return CostModel(value_bytes=self.wire.value_bytes)

    def client_compress(self, state: ClientState, grad, gbar_prev, round_idx,
                        local_steps=1.0, mean_steps=1.0, tau_override=None, rates=None,
                        wire_levels=None, *, layout):
        """One compression step for a stack of k clients (paper Algorithm 1
        lines 6-13). ``state`` fields and ``grad`` are flat ``[k, N]``
        stacks of the params ``layout`` describes; ``gbar_prev`` is last
        round's broadcast, ``[N]``; ``local_steps`` / ``mean_steps`` are
        scalars or ``[k]``. ``rates`` (float32 ``[k]``) and ``wire_levels``
        (int ``[k]``, 1 = drop to int8) are the adaptive rate controller's,
        threaded only under it: per-client rates take the staged path with
        per-client keep counts, as the reference sends a traced rate.
        Returns the ``[k, N]`` payload stack, the new state stack and a
        ``CompressInfo`` whose ``upload_nnz`` is ``[k]``."""
        cfg = self.cfg
        ctx = StageCtx(round_idx=round_idx, gbar_prev=gbar_prev,
                       local_steps=local_steps, mean_steps=mean_steps,
                       tau_override=tau_override, layout=layout)
        ops = stages.elementwise_ops(cfg)
        total = layout.total

        m, extra = self.fusion.pre(cfg, state.m, gbar_prev)
        value, u, v = self.compensator.accumulate(cfg, ops, state.u, state.v, grad, extra)

        # The fused kernel implements exactly the topk + dgc + gmf
        # composition; any other composition takes the staged path.
        fused = getattr(self.fusion, "fused_compress", None)
        if (cfg.use_kernels and fused is not None and cfg.per_tensor and rates is None
                and self.selector.name == "topk"
                and self.compensator.uses_u and self.compensator.uses_v):
            g_out, u, v, m, masks = fused(cfg, u, v, m, ctx)
            nnz = tree_nnz(masks, client_axis=True)
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
            nnz = tree_nnz(masks, client_axis=True)

        g_out, new_state = self._encode_payload(cfg, g_out, ClientState(u=u, v=v, m=m),
                                                layout, wire_levels)
        return g_out, new_state, CompressInfo(upload_nnz=nnz, total_params=total)

    def _encode_payload(self, cfg, g_out, state: ClientState, layout, wire_levels):
        """Wire-encode the payload stack. Without wire levels this is the
        wire stage's own ``encode``; with them (the adaptive controller's
        int8 drop) the clients at level 1 take the int8 round trip instead
        of the scheme's codec, and every client's residual G − wire(G)
        folds into V, as the reference's per-client ``_encode_payload``
        does (rotation is the identity here)."""
        if wire_levels is None:
            return self.wire.encode(cfg, g_out, state, layout)
        g_wire = torch.where(rows(wire_levels, g_out) > 0, roundtrip_q8_segments(g_out, layout),
                             self.wire.roundtrip(g_out, layout))
        return g_wire, ClientState(u=state.u, v=stages.fold_residual(state.v, g_out, g_wire),
                                   m=state.m)

    def server_aggregate(self, server_state: ServerState, g_sum, num_clients, *, layout=None):
        """Average the summed ``[N]`` payloads, apply the fusion stage's
        server transform and the downlink stage; returns the ``[N]``
        broadcast. The ``topk`` downlink selects per leaf of ``layout``."""
        cfg = self.cfg
        # A divisor on the device: CUDA divides by a Python scalar as a
        # multiplication by its reciprocal, one rounding off x / n.
        gbar = g_sum / scalar(num_clients, g_sum.device, g_sum.dtype)
        total = gbar.numel()
        if self.server_momentum:
            bcast, new_momentum = self.fusion.server(cfg, server_state.momentum, gbar)
        else:
            bcast, new_momentum = gbar, server_state.momentum
        union_nnz = tree_nnz(bcast)
        if self.downlink.uses_residual and layout is None:
            raise ValueError(f"the {self.downlink.name} downlink needs the params' layout: "
                             f"server_aggregate(..., layout=...)")
        bcast, residual, down_nnz = self.downlink.apply(
            cfg, self.wire, server_state.residual, bcast, union_nnz, layout)
        info = AggregateInfo(download_nnz=down_nnz, total_params=total, union_nnz=union_nnz)
        return bcast, ServerState(momentum=new_momentum, residual=residual), info


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
