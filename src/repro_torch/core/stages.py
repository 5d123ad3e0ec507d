"""Composable compression-scheme stages.

A scheme is a composition of eight stage kinds, as in the JAX package's
``core/stages.py``:

``selector``     ``topk`` (exact or sampled threshold, per tensor or
                 global), ``randomk`` (a rate-sized random coordinate set,
                 one mask a round shared by every client), ``dense`` and
                 ``sketch`` (FetchSGD's count-sketch upload, which replaces
                 the mask pipeline; ``core/sketch.py``, ``Scheme``);
``compensator``  ``none``, ``ef`` (error feedback) and ``dgc`` (momentum
                 correction, then error feedback);
``fusion``       ``none``, ``gmc``, ``server_gm`` and ``gmf`` (the paper's
                 Global Momentum Fusion, with the fused kernel path);
``wire``         ``float32`` (identity), ``float16`` and ``bfloat16``
                 (casts), ``int8`` (per-leaf 256-entry blocks,
                 ``utils/quant.py``) and ``probquant`` (the unbiased
                 stochastic ternary codec in the same blocks), each
                 non-identity wire folding its rounding residual into V;
``rotation``     ``none`` and ``hadamard`` (a randomised Hadamard
                 transform per leaf ahead of the wire, inverted before the
                 fold);
``downlink``     ``none`` and ``topk`` (top-k of the broadcast against a
                 server-side residual, ``ServerState.residual``);
``rate_control`` ``fixed`` and ``adaptive`` (``core/rate_control.py``);
``staleness``    ``none`` (the identity), ``poly`` and ``gmf_damp``: how
                 the async buffered engine weighs a payload that arrives
                 ``gap`` ticks after the model it was computed on, over
                 the ``[B, W]`` buffer with a ``[B]`` weight vector.

The client axis is explicit and the state is flat (``utils/flat.py``):
every state, gradient and payload is one client-major ``[k, N]`` stack of
the params' leaves, the broadcast ``gbar_prev`` one ``[N]`` vector shared
by all rows. Elementwise steps are one op over the stack; the per-leaf
steps (norms, top-k, wire blocks, rotations) take the layout
(``StageCtx.layout``) and work per (client, leaf) segment. Per-client
scalars (τ, w) are ``[k]`` device tensors and per-segment ones (norms,
thresholds) ``[k, L]``, so each compression kernel launches once a round
for all clients and leaves.

The keyed stages (``randomk``, ``probquant``, ``hadamard``) draw their
bits from a counter-based hash of their key chain (``utils/draws.py``),
not from ``jax.random``: each draw is a pure function of (seed, round,
leaf, client, index), the same on the CPU and the card, and one set of
ops over the stack a round. Each draw is a method of its stage, the seam
the parity tests feed JAX's draws through.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import fusion as fusion_math
from repro_torch.core import sparsify
from repro_torch.core.state import ClientState
from repro_torch.utils import draws, scalar, tree_map, weak
from repro_torch.utils.flat import FlatLayout
from repro_torch.utils.quant import roundtrip_q8_segments, roundtrip_ternary_segments

STAGE_KINDS = ("selector", "compensator", "fusion", "wire", "rotation",
               "downlink", "staleness", "rate_control")

REGISTRY: dict[str, dict[str, Any]] = {kind: {} for kind in STAGE_KINDS}

# Stages of the reference not ported yet -> the ROADMAP item that ports them.
NOT_PORTED: dict[tuple[str, str], str] = {}


def register(kind: str, name: str, *, override: bool = False):
    """Class decorator: instantiate the stage and register the singleton.
    A name already registered raises unless ``override=True``: Schemes
    already resolved may be bound to the stage it would replace."""
    if kind not in REGISTRY:
        raise ValueError(f"unknown stage kind {kind!r}; choose from {STAGE_KINDS}")

    def deco(cls):
        if name in REGISTRY[kind] and not override:
            raise ValueError(
                f"{kind} stage {name!r} is already registered "
                f"({type(REGISTRY[kind][name]).__name__}); pass "
                f"register({kind!r}, {name!r}, override=True) to replace it")
        obj = cls()
        obj.name = name
        REGISTRY[kind][name] = obj
        return cls

    return deco


def get_stage(kind: str, name: str):
    try:
        return REGISTRY[kind][name]
    except KeyError:
        if (kind, name) in NOT_PORTED:
            raise NotImplementedError(
                f"{kind} stage {name!r} is not ported yet: "
                f"{NOT_PORTED[kind, name]}") from None
        raise ValueError(f"unknown {kind} stage {name!r}; registered {kind}s: "
                         f"{tuple(REGISTRY[kind])}") from None


def available(kind: str) -> tuple[str, ...]:
    return tuple(REGISTRY[kind])


class CompressInfo(NamedTuple):
    upload_nnz: torch.Tensor   # [k] int64: entries each client transmits
    total_params: int          # per-client element count


class AggregateInfo(NamedTuple):
    download_nnz: torch.Tensor  # int64 nnz of the broadcast (post-downlink)
    total_params: int
    union_nnz: Any = None       # pre-downlink union nnz (the adaptive-tau signal)


class StageCtx(NamedTuple):
    round_idx: Any
    gbar_prev: Any
    local_steps: Any
    mean_steps: Any
    tau_override: Any
    layout: Any  # the FlatLayout of the [k, N] stacks
    client_ids: Any = None  # int [k] global ids, threaded for a stochastic wire


def elementwise_ops(cfg):
    """The elementwise hot-path ops. Unlike the reference, this does not
    depend on ``cfg.use_kernels``: ``kernels.ops`` launches the CUDA kernels
    for tensors on the card and runs the plain versions on the CPU, so the
    plain versions never run on the card. ``use_kernels`` keeps its other
    meaning, the choice of the fused GMF path (``Scheme.client_compress``)."""
    from repro_torch.kernels import ops

    return ops


def effective_tau(cfg, round_idx, device) -> torch.Tensor:
    if cfg.tau_warmup_rounds > 0:
        return fusion_math.tau_schedule(round_idx, cfg.tau, cfg.tau_warmup_rounds, device)
    return scalar(cfg.tau, device)


# ---------------------------------------------------------------------------
# Selectors
# ---------------------------------------------------------------------------


class Selector:
    needs_scores = True
    dense = False
    sketch = False
    description = ""

    def select(self, cfg, ref, round_idx, layout, rates=None):
        """``rates=None`` selects at ``cfg.rate``; per-client rates ``[k]``
        (the adaptive controller's) take the dynamic-k path."""
        raise NotImplementedError


@register("selector", "topk")
class TopKSelector(Selector):
    description = ("magnitude top-k of the (fusion-shaped) score; threshold "
                   "estimator from cfg.selector (exact | sampled), per-tensor "
                   "or global via cfg.per_tensor")

    def select(self, cfg, scores, round_idx, layout, rates=None):
        if layout.groups is not None:  # a tree of mixed dtypes: one score stack a group
            if cfg.per_tensor:
                return tuple(self.select(cfg, z, round_idx, sub, rates)
                             for z, sub in zip(scores, layout.groups, strict=True))
            return sparsify.grouped_topk_masks(scores, layout, cfg.rate, rates)
        if rates is not None:
            return self._select_dynamic(cfg, scores, layout, rates)
        if not cfg.per_tensor:  # one exact threshold per client over all leaves
            return sparsify.topk_mask(scores, cfg.rate, "exact", layout)
        if cfg.selector == "exact":
            from repro_torch.kernels import ops

            return ops.topk_abs_select(scores, layout, cfg.rate)[1]
        return sparsify.segment_topk_mask(scores, layout, cfg.rate, cfg.selector)[1]

    @staticmethod
    def _select_dynamic(cfg, scores, layout, rates):
        """Per-client rates: every segment's keep count from its client's
        rate (``sparsify.keep_table``), one ``gmf_select`` launch in its
        |z| mode with the per-row table on the card; global top-k and the
        sampled selector sort per row, as the reference does."""
        if not cfg.per_tensor:
            return sparsify.topk_mask_dynamic(scores, rates, layout)
        if cfg.selector == "exact":
            from repro_torch.kernels import ops

            return ops.topk_abs_select(scores, layout,
                                       keep=sparsify.keep_table(layout, rates))[1]
        return sparsify.segment_topk_mask_dynamic(scores, layout, rates, cfg.selector)


@register("selector", "dense")
class DenseSelector(Selector):
    needs_scores = False
    dense = True
    description = "no sparsification — every entry is transmitted"

    def select(self, cfg, value, round_idx, layout, rates=None):
        return None


@register("selector", "randomk")
class RandomKSelector(Selector):
    needs_scores = False
    description = ("rate-sized random coordinate set per round (no magnitude "
                   "information — the ablation baseline)")

    def uniforms(self, cfg, round_idx, layout) -> torch.Tensor:
        """The round's float32 uniforms ``[N]``, keyed 17 → round → leaf →
        index: with no client in the chain, every client of a round gets
        the same mask, as the reference's vmapped ``PRNGKey(17)`` stream."""
        return draws.uniform(draws.element_hashes(
            layout, draws.leaf_keys(layout, 17, int(round_idx))))

    def select(self, cfg, value, round_idx, layout, rates=None):
        u = self.uniforms(cfg, round_idx, layout)
        if rates is None:  # one mask, shared by every client row
            return (u < cfg.rate).float().expand(value.shape[0], -1).contiguous()
        return (u[None, :] < rates[:, None]).float()


@register("selector", "sketch")
class SketchSelector(Selector):
    sketch = True
    needs_scores = False
    description = ("fixed-size count sketch of the whole gradient (FetchSGD "
                   "upload); server keeps momentum + error feedback in sketch "
                   "space and broadcasts k heavy hitters")

    def select(self, cfg, value, round_idx, layout, rates=None):
        raise RuntimeError("the sketch selector replaces the mask pipeline; "
                           "Scheme handles it directly")


# ---------------------------------------------------------------------------
# Compensators
# ---------------------------------------------------------------------------


class Compensator:
    uses_u = False
    uses_v = False
    description = ""

    def accumulate(self, cfg, ops, u, v, grad, extra):
        raise NotImplementedError

    def extract(self, cfg, ops, u, v, value, masks):
        raise NotImplementedError


@register("compensator", "none")
class NoCompensation(Compensator):
    description = "masked-out entries are dropped (plain top-k / FedSGD)"

    def accumulate(self, cfg, ops, u, v, grad, extra):
        value = grad if extra is None else tree_map(torch.add, grad, extra)
        return value, u, v

    def extract(self, cfg, ops, u, v, value, masks):
        g_out = value if masks is None else tree_map(torch.mul, value, masks)
        return g_out, u, v


@register("compensator", "ef")
class ErrorFeedback(Compensator):
    uses_v = True
    description = ("error feedback: V accumulates everything; masked-out "
                   "entries survive in V to the next round")

    def accumulate(self, cfg, ops, u, v, grad, extra):
        if extra is None:
            v = tree_map(torch.add, v, grad)
        else:
            v = tree_map(lambda vv, g, e: vv + g + e, v, grad, extra)
        return v, u, v

    def extract(self, cfg, ops, u, v, value, masks):
        if masks is None:
            return v, u, tree_map(lambda vv: vv * 0.0, v)
        g_out = tree_map(torch.mul, v, masks)
        v = tree_map(lambda vv, mk: vv * (1.0 - mk), v, masks)
        return g_out, u, v


@register("compensator", "dgc")
class MomentumCorrection(Compensator):
    uses_u = True
    uses_v = True
    description = "DGC momentum correction (U ← αU + g; V ← V + U) on top of error feedback"

    def accumulate(self, cfg, ops, u, v, grad, extra):
        g_eff = grad if extra is None else tree_map(torch.add, grad, extra)
        u, v = ops.momentum_correction(u, v, g_eff, cfg.alpha, state_dtype=cfg.use_kernels)
        return v, u, v

    def extract(self, cfg, ops, u, v, value, masks):
        if masks is None:
            zeros = lambda t: tree_map(lambda x: x * 0.0, t)
            return v, zeros(u), zeros(v)
        return ops.apply_mask_update(u, v, masks, state_dtype=cfg.use_kernels)


# ---------------------------------------------------------------------------
# Fusions
# ---------------------------------------------------------------------------


class Fusion:
    uses_m = False
    server_momentum = False
    description = ""

    def pre(self, cfg, m, gbar_prev):
        return m, None

    def scores(self, cfg, value, m, ctx: StageCtx):
        return tree_map(torch.abs, value), m

    def server(self, cfg, momentum, gbar):
        return gbar, momentum


@register("fusion", "none")
class NoFusion(Fusion):
    description = "no global momentum; score = |value|"


@register("fusion", "gmc")
class GlobalMomentumCompensation(Fusion):
    uses_m = True
    description = ("GMC: global momentum in the *compensation* — M ← µM + Ĝ "
                   "and V accumulates g + µM; score stays |V|")

    def pre(self, cfg, m, gbar_prev):
        m = tree_map(lambda mm, gb: weak(cfg.mu, mm.dtype) * mm + gb, m, gbar_prev)
        extra = tree_map(lambda mm: weak(cfg.mu, mm.dtype) * mm, m)
        return m, extra


@register("fusion", "server_gm")
class ServerGlobalMomentum(Fusion):
    server_momentum = True
    description = ("server-side global momentum on the broadcast (DGCwGM; "
                   "paper problem 2.1 — the download densifies)")

    def server(self, cfg, momentum, gbar):
        mom = tree_map(lambda mm, g: weak(cfg.beta_server, mm.dtype) * mm + g, momentum, gbar)
        return mom, mom


@register("fusion", "gmf")
class GlobalMomentumFusion(Fusion):
    uses_m = True
    description = ("the paper's GMF: M ← βM + Ĝ and the selection score is "
                   "|(1−τ)·w·N(V) + τ·N(M)| (τ schedule via "
                   "tau_warmup_rounds, w via fusion_weighting=fednova)")

    def _tau_w(self, cfg, ctx: StageCtx, device):
        if ctx.tau_override is not None:
            tau = scalar(ctx.tau_override, device)
        else:
            tau = effective_tau(cfg, ctx.round_idx, device)
        if cfg.fusion_weighting == "fednova":
            w = fusion_math.fednova_step_weight(ctx.local_steps, ctx.mean_steps, device)
        else:
            w = scalar(1.0, device)
        return tau, w

    def scores(self, cfg, value, m, ctx: StageCtx):
        m = weak(cfg.beta, m.dtype) * m + ctx.gbar_prev
        tau, w = self._tau_w(cfg, ctx, value.device)
        t = fusion_math.rows(tau, value)
        normalize = lambda x: fusion_math.segment_l2_normalize(x, ctx.layout, cfg.eps)
        return torch.abs((1.0 - t) * fusion_math.rows(w, value) * normalize(value)
                         + t * normalize(m)), m

    def fused_compress(self, cfg, u, v, m, ctx: StageCtx):
        """Score + mask + extract through the fused kernel over the flat
        ``[k, N]`` stacks: ``ops.gmf_select`` gives every (client, leaf)
        segment's inverse norms and exact top-k threshold ``[k, L]`` (one
        launch on the card), then one pass produces (G, U', V', mask).
        Returns (g, u, v, m, masks).

        Equivalent to ``scores`` + top-k + ``extract`` up to reciprocal vs
        division rounding in the normalisation (boundary ties in the mask
        can differ); selected only under ``use_kernels``. The sampled
        selector replaces the thresholds by its per-leaf estimates."""
        from repro_torch.kernels import ops

        m = weak(cfg.beta, m.dtype) * m + ctx.gbar_prev
        k = v.shape[0]
        tau, w = (x.expand(k).contiguous() for x in self._tau_w(cfg, ctx, v.device))
        # w folds into V's inverse norm: (1−τ)·w·N(V) = (1−τ)·V·(w/‖V‖)
        inv_nv, inv_nm, thr = ops.gmf_select(v, m, ctx.layout, cfg.rate, w=w, tau=tau,
                                             eps=cfg.eps)
        if cfg.selector != "exact":
            thr = self._sampled_thresholds(cfg, v, m, inv_nv, inv_nm, tau, ctx.layout)
        g, u, v, masks = ops.gmf_compress(u, v, m, layout=ctx.layout, inv_norm_v=inv_nv,
                                          inv_norm_m=inv_nm, tau=tau, threshold=thr)
        return g, u, v, m, masks

    @staticmethod
    def _sampled_thresholds(cfg, v, m, inv_nv, inv_nm, tau, layout):
        """DGC's sampled estimate of every segment's threshold: the score of
        a strided sample of the (whole) leaf in its shape -> ``[k, L]``; a
        cut leaf's points scored where they lie and gathered over the
        group."""
        from repro_torch.kernels import ref

        out = []
        for i, (vs, ms) in enumerate(zip(layout.segments(v), layout.segments(m), strict=True)):
            zs = ref.gmf_fusion_score(sparsify.segment_sample(vs, layout, i),
                                      sparsify.segment_sample(ms, layout, i),
                                      inv_norm_v=inv_nv[:, i], inv_norm_m=inv_nm[:, i], tau=tau)
            zs, count = sparsify.whole_sample(zs, layout, i)
            out.append(sparsify.exact_threshold(zs, sparsify.num_keep(count, cfg.rate)))
        return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Wire codecs
# ---------------------------------------------------------------------------


class WireCodec:
    """What a payload looks like after crossing the wire. ``roundtrip``
    takes a flat ``[..., N]`` stack of ``layout`` and is pure;
    ``roundtrip_ctx`` is the same with the round's context, which a
    stochastic codec keys its draws from; ``encode`` sends the ``[k, N]``
    payload stack through it and owns the error feedback."""

    value_bytes: float = 4
    dtype = "float32"
    stochastic = False
    description = ""

    def roundtrip(self, x, layout):
        return x

    def roundtrip_ctx(self, cfg, x, layout, ctx: StageCtx | None):
        return self.roundtrip(x, layout)

    def encode(self, cfg, g_out, state: ClientState, layout, ctx: StageCtx | None = None):
        return g_out, state


@register("wire", "float32")
class Float32Wire(WireCodec):
    description = "full-precision payload (identity)"


def fold_residual(v, g_out, g_wire):
    """V ← V + (G − wire(G)): the encoding residual back into the
    error-feedback state (one op over the stack); schemes without V keep
    their empty field."""
    return v + (g_out - g_wire) if isinstance(v, torch.Tensor) else v


class _RoundtripFoldWire(WireCodec):
    """Send the payload through ``roundtrip``; the encoding residual
    (G − wire(G)) folds back into the error-feedback state V so nothing is
    lost. Schemes without V transmit the plain round-tripped payload."""

    def encode(self, cfg, g_out, state: ClientState, layout, ctx: StageCtx | None = None):
        g_wire = self.roundtrip_ctx(cfg, g_out, layout, ctx)
        return g_wire, ClientState(u=state.u, v=fold_residual(state.v, g_out, g_wire),
                                   m=state.m)


class _CastFoldWire(_RoundtripFoldWire):
    value_bytes = 2
    torch_dtype = torch.float32

    def roundtrip(self, x, layout):
        return x.to(self.torch_dtype).to(x.dtype)


@register("wire", "float16")
class Float16Wire(_CastFoldWire):
    dtype = "float16"
    torch_dtype = torch.float16
    description = "fp16 payload; quantisation residual folds into V"


@register("wire", "bfloat16")
class BFloat16Wire(_CastFoldWire):
    dtype = "bfloat16"
    torch_dtype = torch.bfloat16
    description = "bf16 payload; quantisation residual folds into V"


@register("wire", "int8")
class Int8Wire(_RoundtripFoldWire):
    """Symmetric int8 with one fp32 scale per 256-entry block of each leaf
    (``utils/quant.py``); 1 byte a value on the ledger (the per-block scale
    adds 4/256 byte a value, under the 4-byte index). All-zero blocks decode
    to exact zeros, so sparsity (and the nnz accounting) survives."""

    dtype = "int8"
    value_bytes = 1
    description = ("int8 payload, per-256-block symmetric scales; "
                   "quantisation residual folds into V")

    def roundtrip(self, x, layout):
        return roundtrip_q8_segments(x, layout)


@register("wire", "probquant")
class ProbQuantWire(_RoundtripFoldWire):
    """Probabilistic ternary codec (Konečný et al., arXiv:1610.05492 §3): per
    256-entry block of each leaf, each value ships as ``sign(x)·s`` (``s``
    the block's max magnitude) with probability ``|x|/s`` and as 0
    otherwise, so the round trip is unbiased and its zero-mean noise folds
    into V. About 2 bits a value: ``value_bytes = 0.25``.

    The keep draws are keyed ``probquant_seed → round → leaf → client``
    (the engine threads the sampled clients' ids, ``StageCtx.client_ids``),
    so clients draw independent noise. Without a context (``roundtrip``,
    which the downlink reuses) the draw is a fixed one, the reference's
    ``PRNGKey(0)``: the same stream for every leaf."""

    dtype = "ternary"
    value_bytes = 0.25
    stochastic = True
    description = ("probabilistic ternary payload (unbiased stochastic "
                   "keep, ~2 bits/value, per-256-block scales); draws keyed "
                   "by round/leaf/client, rounding noise folds into V")

    def uniforms(self, cfg, layout, ctx: StageCtx | None) -> torch.Tensor:
        """The keep draws: float32 ``[N]``, or ``[k, N]`` with client ids."""
        if cfg is None:
            keys = torch.full((layout.num_leaves,), draws.key(0), dtype=torch.int64,
                              device=layout.device)
        elif ctx is None:
            keys = draws.leaf_keys(layout, cfg.probquant_seed)
        else:
            keys = draws.leaf_keys(layout, cfg.probquant_seed, int(ctx.round_idx),
                                   clients=ctx.client_ids)
        return draws.uniform(draws.element_hashes(layout, keys))

    def roundtrip(self, x, layout):
        return roundtrip_ternary_segments(x, layout, self.uniforms(None, layout, None))

    def roundtrip_ctx(self, cfg, x, layout, ctx: StageCtx | None):
        return roundtrip_ternary_segments(x, layout, self.uniforms(cfg, layout, ctx))


# ---------------------------------------------------------------------------
# Identity stages of the other kinds, and the downlink
# ---------------------------------------------------------------------------


class Rotation:
    """A linear, norm-preserving transform of each leaf ahead of the wire
    codec, inverted before the error-feedback fold. ``forward`` takes the
    ``[k, N]`` stack of ``layout`` and returns the rotated stack and its
    layout (Hadamard pads each leaf to a power of two); ``inverse`` undoes
    it. Both are keyed by the config and the round only, so client and
    server agree on R. ``wire_size(n)`` is the count of values that cross
    the wire for an n-element leaf (rotation densifies)."""

    identity = True

    def forward(self, cfg, x, round_idx, layout):
        return x, layout

    def inverse(self, cfg, y, round_idx, layout):
        return y

    def wire_size(self, n: int) -> int:
        return n

    def by_leaf(self, layout) -> bool:
        """Whether ``layout``'s payloads rotate one whole leaf at a time
        (``roundtrip_by_leaf``) instead of through ``forward``/``inverse``."""
        return False


@register("rotation", "none")
class NoRotation(Rotation):
    description = "identity — payloads hit the wire codec untransformed"


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised fast Walsh–Hadamard transform over the last axis (a
    power of two), in the reference's butterfly order: ``reshape(-1, 2,
    h)``, then ``[a + b, a − b]``, so the result is bitwise JAX's."""
    lead, m = x.shape[:-1], x.shape[-1]
    h = 1
    while h < m:
        x = x.reshape(*lead, -1, 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1)
        h *= 2
    return x.reshape(*lead, m)


class _HadamardGroup(NamedTuple):
    """The leaves of one padded length m: the columns of their padded
    elements in the flat stack extended by one zero column (``src``) and
    in the rotated stack (``dst``); which of those elements are real
    (``real``) and their columns in the flat stack (``cols``); √m on the
    device."""

    m: int
    src: torch.Tensor
    dst: torch.Tensor
    real: torch.Tensor
    cols: torch.Tensor
    sqrt_m: torch.Tensor


@register("rotation", "hadamard")
class HadamardRotation(Rotation):
    """R = H·D/√m per leaf (``rotation_seed → round → leaf`` keys the ±1
    diagonal D; leaves padded with zeros to m = 2^⌈log2 n⌉). The leaves are
    grouped by m, so a round is one batched transform per distinct m (11
    at ResNet-56's 169 leaves) over the ``[k, ·]`` stack, with the same
    float32 operations in the same order as the reference: the transform
    and its inverse are bitwise JAX's on the same diagonal."""

    identity = False
    description = ("randomised Hadamard transform R = H·D/√m per leaf "
                   "(pad to power of two, ±1 diagonal keyed by "
                   "rotation_seed/round/leaf); orthonormal, so R⁻¹ = "
                   "D·H/√m and norms are preserved")

    # Padded entries past which a layout rotates one leaf at a time: the
    # grouped plan holds four int64 index tensors of about that size.
    PLAN_LIMIT = 1 << 27

    def __init__(self):
        self._plans: dict = {}

    @staticmethod
    def _padded(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    def wire_size(self, n: int) -> int:
        return self._padded(n)

    def by_leaf(self, layout) -> bool:
        """Leaves cut over a group (the transform mixes the whole padded
        leaf), and layouts too large for the grouped plan, rotate one whole
        leaf at a time."""
        return layout.cut or sum(map(self._padded, layout.full_sizes)) > self.PLAN_LIMIT

    def roundtrip_by_leaf(self, cfg, x, round_idx, layout, wire):
        """``inverse(wire(forward(x)))`` one whole leaf at a time: each leaf
        of the ``[k, N]`` stack gathered whole in its flat order where it is
        cut (``FlatLayout.whole_leaf``), padded, rotated with its diagonal
        (keyed by the whole index), sent through ``wire(y, leaf_layout)`` as
        leaf i of the rotated layout (``FlatLayout.leaf``, made anew so that
        its index tensors are dropped with it), rotated back, and the rank's
        piece kept. The same float32 operations in the same order as the
        grouped path, so the same bits; one whole leaf is held at a time."""
        rotated = FlatLayout.of_sizes([self._padded(n) for n in layout.full_sizes],
                                      layout.device)
        k = x.shape[0]
        out = []
        for i, seg in enumerate(layout.segments(x)):
            whole = layout.whole_leaf(seg.float(), i)
            n, m = whole.shape[1], rotated.sizes[i]
            leaf = FlatLayout([torch.empty((m,), device="meta")], layout.device)
            leaf.leaf_ids = (layout.leaf_ids[i],)
            d = draws.rademacher(draws.element_hashes(
                leaf, draws.leaf_keys(leaf, cfg.rotation_seed, int(round_idx))))
            sqrt_m = torch.sqrt(scalar(float(m), x.device))
            z = d * torch.cat([whole, whole.new_zeros(k, m - n)], dim=1)
            del whole
            y = wire(_fwht(z) / sqrt_m, leaf)
            back = d * _fwht(y) / sqrt_m
            out.append(layout.piece(back[:, :n], i))
            del z, y, back
        return torch.cat(out, dim=1)

    def plan(self, layout):
        """(the rotated layout, its groups by padded length), once per layout."""
        if layout not in self._plans:
            sizes = [self._padded(n) for n in layout.sizes]
            rotated = FlatLayout.of_sizes(sizes, layout.device)
            groups = []
            dev = layout.device
            # the index columns on the host (numpy, from the layout's sizes
            # and offsets), then moved to the device: nothing read back
            on_dev = lambda a: torch.as_tensor(a, dtype=torch.int64).to(dev)  # noqa: E731
            for m in sorted(set(sizes)):
                leaves = [i for i, s in enumerate(sizes) if s == m]
                pos = np.arange(m, dtype=np.int64)[None, :]
                n = np.array([layout.sizes[i] for i in leaves], dtype=np.int64)[:, None]
                start = np.array([layout.offsets[i] for i in leaves], dtype=np.int64)[:, None]
                src = np.where(pos < n, start + pos, layout.total).reshape(-1)
                dst = (np.array([rotated.offsets[i] for i in leaves], dtype=np.int64)[:, None]
                       + pos).reshape(-1)
                real = np.flatnonzero(src < layout.total)
                groups.append(_HadamardGroup(m, on_dev(src), on_dev(dst), on_dev(real),
                                             on_dev(src[real]),
                                             torch.sqrt(scalar(float(m), dev))))
            self._plans[layout] = rotated, tuple(groups)
        return self._plans[layout]

    def diagonal(self, cfg, round_idx, layout) -> torch.Tensor:
        """D over the rotated layout: float32 ±1 ``[M]``, each padded leaf
        keyed by its leaf's number in the tree (``layout.leaf_ids``)."""
        rotated, _ = self.plan(layout)
        return draws.rademacher(draws.element_hashes(
            rotated, draws.leaf_keys(layout, cfg.rotation_seed, int(round_idx))))

    def forward(self, cfg, x, round_idx, layout):
        rotated, groups = self.plan(layout)
        d = self.diagonal(cfg, round_idx, layout)
        k = x.shape[0]
        ext = torch.cat([x.float(), x.new_zeros(k, 1, dtype=torch.float32)], dim=1)
        out = torch.empty(k, rotated.total, dtype=torch.float32, device=x.device)
        for g in groups:
            z = d[g.dst].view(-1, g.m) * ext[:, g.src].view(k, -1, g.m)
            out.index_copy_(1, g.dst, (_fwht(z) / g.sqrt_m).view(k, -1))
        return out, rotated

    def inverse(self, cfg, y, round_idx, layout):
        _, groups = self.plan(layout)
        d = self.diagonal(cfg, round_idx, layout)
        k = y.shape[0]
        out = torch.empty(k, layout.total, dtype=torch.float32, device=y.device)
        for g in groups:
            z = d[g.dst].view(-1, g.m) * _fwht(y[:, g.dst].view(k, -1, g.m)) / g.sqrt_m
            out.index_copy_(1, g.cols, z.view(k, -1)[:, g.real])
        return out


class Downlink:
    """Compression of the ``[N]`` broadcast: ``apply`` -> (broadcast out,
    new residual, download nnz); ``nnz`` is the pre-downlink nnz, which the
    identity reports unchanged."""

    uses_residual = False

    def apply(self, cfg, wire, residual, bcast, nnz, layout):
        return bcast, residual, nnz


@register("downlink", "none")
class NoDownlink(Downlink):
    description = "broadcast the raw aggregate (hub-and-spoke baseline)"


@register("downlink", "topk")
class TopKDownlink(Downlink):
    uses_residual = True
    description = ("top-k of the broadcast against a server-side residual "
                   "accumulator (error feedback on the downlink); rate from "
                   "cfg.downlink_rate, threshold estimator and per-tensor vs "
                   "global from the selector knobs, payload wire-encoded like "
                   "the uplink")

    def apply(self, cfg, wire, residual, bcast, nnz, layout):
        # the residual holds everything the clients have not seen yet
        if layout.groups is not None:  # a tree of mixed dtypes: one [N_g] a group
            r = tuple(res + b for res, b in zip(residual, bcast, strict=True))
            if cfg.per_tensor:
                masks = [self._masks(cfg, x[None], sub)[0]
                         for x, sub in zip(r, layout.groups, strict=True)]
            else:  # one threshold over the whole tree's broadcast
                masks = [mk[0] for mk in sparsify.grouped_topk_masks(
                    [x[None] for x in r], layout, cfg.downlink_rate)]
            outs = [self._send(wire, x, mk, sub)
                    for x, mk, sub in zip(r, masks, layout.groups, strict=True)]
            return (tuple(o[0] for o in outs), tuple(o[1] for o in outs),
                    sum(o[2] for o in outs))
        r = residual + bcast
        return self._send(wire, r, self._masks(cfg, r[None], layout)[0], layout)

    @staticmethod
    def _masks(cfg, rows, layout):
        if not cfg.per_tensor:
            return sparsify.topk_mask(rows, cfg.downlink_rate, "exact", layout)
        if cfg.selector == "exact":  # one gmf_select launch in its |z| mode
            from repro_torch.kernels import ops

            return ops.topk_abs_select(rows, layout, cfg.downlink_rate)[1]
        return sparsify.segment_topk_mask(rows, layout, cfg.downlink_rate, cfg.selector)[1]

    @staticmethod
    def _send(wire, r, masks, layout):
        # the accumulated broadcast is mostly exact zeros; a zero threshold
        # would select them all (|0| >= 0), so zeros never transmit
        masks = masks * (r != 0.0).float()
        # the payload ships through the scheme's wire codec; with masks in
        # {0, 1}, r·(1−mk) + (r·mk − wire(r·mk)) is r − wire(r·mk)
        out_w = wire.roundtrip(r * masks, layout)
        return out_w, r - out_w, layout.nnz(masks)


# ---------------------------------------------------------------------------
# Staleness (the async buffered engine's payload-age weighting)
# ---------------------------------------------------------------------------


class Staleness:
    """How the server weighs a payload that arrives ``gap`` ticks after the
    model it was computed against (``gap = t_apply − t_dispatch``).

    ``weight(cfg, gaps)`` maps the ``[B]`` gaps of a buffer to a ``[B]``
    float32 weight vector on their device; ``combine(cfg, buf, gaps,
    gmom)`` turns the ``[B, W]`` buffer into what enters the aggregate,
    ``gmom`` being the server-held global momentum (a flat ``[N]`` EMA of
    broadcasts the async engine keeps; ``{}`` for policies without it).
    Every policy is the identity at gap 0, which pins the async engine to
    the synchronous one at zero delay. Gaps are clipped to
    ``cfg.staleness_horizon`` first, so a weight never falls below
    ``(1 + horizon)^(−staleness_exponent)``."""

    uses_momentum = False
    description = ""

    def _gap(self, cfg, gaps):
        g = gaps.to(torch.float32)
        return torch.minimum(g, scalar(float(cfg.staleness_horizon), g.device))

    def weight(self, cfg, gaps):
        return torch.ones_like(gaps, dtype=torch.float32)

    def combine(self, cfg, buf, gaps, gmom):
        return self.weight(cfg, gaps)[:, None] * buf


@register("staleness", "none")
class NoStaleness(Staleness):
    description = "every payload weighs 1 (synchronous semantics; the identity)"

    def combine(self, cfg, buf, gaps, gmom):
        return buf  # the identity, bitwise


@register("staleness", "poly")
class PolyStaleness(Staleness):
    description = ("polynomial damping w(s) = (1+s)^(−staleness_exponent), gap clipped "
                   "to staleness_horizon (FedBuff-style); exponent 0 == none")

    def weight(self, cfg, gaps):
        s = self._gap(cfg, gaps)
        return (1.0 + s) ** (-scalar(cfg.staleness_exponent, s.device))


@register("staleness", "gmf_damp")
class GMFDampStaleness(PolyStaleness):
    uses_momentum = True
    description = ("GMF-native: the payload poly-damped by w(s) and the server-held "
                   "global momentum filling the gap, w(s)·g + staleness_tau·(1−w(s))·M; "
                   "the identity at s=0")

    def combine(self, cfg, buf, gaps, gmom):
        w = self.weight(cfg, gaps)
        if not isinstance(gmom, torch.Tensor):
            return w[:, None] * buf
        lam = scalar(cfg.staleness_tau, w.device) * (1.0 - w)
        return w[:, None] * buf + lam[:, None] * gmom
