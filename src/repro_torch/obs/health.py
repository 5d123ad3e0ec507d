"""Compensation-state health monitors, on the port's flat state.

The paper's claim — GMF holds accuracy while shrinking communication —
rests on quantities that live inside the compression state and are
invisible from loss curves alone:

* **EF residual mass** ``‖U‖ / ‖V‖`` — how much gradient signal is
  parked in the momentum-correction / error-feedback accumulators. A
  residual that grows without bound means compensation is falling
  behind the compression rate.
* **Global-momentum norm** ``‖M‖`` — the fusion direction's magnitude
  (client-side M, the server-side momentum, and the async engine's
  server-held EMA all reported separately).
* **Achieved vs target compression** — mean transmitted nnz over total
  params, against the configured ``rate``. Divergence means the
  selector (or a dense fallback) is not delivering the configured
  budget.
* **Broadcast finiteness** — one NaN/Inf broadcast poisons every
  client's next round; it must trip an ``anomaly`` event the moment it
  happens, not surface as a flat accuracy curve 50 rounds later.
* **Staleness percentiles** — the age distribution the async engine's
  damping actually saw (from the ledger's histogram).

Everything here computes from the existing state (``utils/flat.py``): U,
V and M are ``[K, N]`` float32 stacks, the server momentum, the async
engine's global momentum and the broadcast ``[N]`` vectors, and a field
a scheme does not use is an empty dict (it reports 0.0). The seven
values are computed on the state's device, stacked into one tensor and
copied to the host with one device read; callers only invoke it when
telemetry is enabled. The norms are float32 sums in another order than
XLA's, so they agree with the JAX package's within float32 rounding,
not bitwise.

Over a mesh each rank holds rows of the stacks (its clients) and pieces of
the leaves (tensor parallelism, FSDP). The reference's norms are of its
global arrays, the whole model's. ``spans`` (``dist.step.health_spans``)
says how each field lies over the ranks: its segments, the group they are
summed over and, per segment, whether it is cut and whether this rank's
piece counts (owner flags: a piece several ranks hold alike counts once).
The norm is then ``optim.sgd.global_norm`` of the segments: the same
once-counting as the optimiser's clip.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.sgd import global_norm
from repro_torch.utils import tree_any_nan, tree_l2_norm, tree_leaves


class NormSpan(NamedTuple):
    """How a flat state field lies over ranks: ``segments(field)`` its
    per-leaf segments, the ``group`` their squares are summed over, and per
    segment whether it is ``cut`` (summed over the group) and whether this
    rank's piece counts (``owner``)."""

    segments: Callable
    group: Any
    cut: tuple
    owner: tuple


def _norm(tree, device, span=None) -> torch.Tensor:
    """Global L2 norm of a state field (0.0 for an empty one), on ``device``:
    of the whole field over the ranks under ``span`` (a collective)."""
    if not tree_leaves(tree):
        return torch.zeros((), dtype=torch.float32, device=device)
    if span is None:
        return tree_l2_norm(tree)
    return global_norm(span.segments(tree), span.group, span.cut, span.owner)


def compensation_norms(cstates, sstate, bcast, gmom=None, spans=None) -> dict:
    """Norms of every compensation-state component, as python floats.

    ``cstates`` may be the per-client stacked state (the norm is then
    over the whole stack) or a single client's state; empty-dict fields
    (schemes that don't use them) report 0.0. ``broadcast_finite`` is the
    NaN/Inf check on the broadcast. With ``spans`` (``{"client": NormSpan,
    "server": NormSpan}``, the trainer's state over a mesh) the client
    state's norms and the server momentum's and the broadcast's are the
    whole model's over every rank's rows and pieces, and ``broadcast_finite``
    is False on every rank where any rank's piece of the broadcast is not
    finite (collectives: every rank calls it)."""
    gmom = {} if gmom is None else gmom
    spans = spans or {}
    device = tree_leaves(bcast)[0].device
    client = [_norm(x, device, spans.get("client")) for x in (cstates.u, cstates.v, cstates.m)]
    server = [_norm(x, device, spans.get("server")) for x in (sstate.momentum, bcast)]
    parts = client + [server[0], _norm(gmom, device), server[1]]
    bad = tree_any_nan(bcast).to(device=device, dtype=torch.float32).reshape(1)
    if "server" in spans:  # a NaN in any rank's piece of the broadcast
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=spans["server"].group)
    parts.append(bad[0])
    u, v, m, sm, gm, b, bad = torch.stack(parts).cpu().tolist()  # the one device read
    return {
        "residual_u_norm": float(u),
        "residual_v_norm": float(v),
        "momentum_m_norm": float(m),
        "server_momentum_norm": float(sm),
        "global_momentum_norm": float(gm),
        "broadcast_norm": float(b),
        "broadcast_finite": not bool(bad),
    }


def compression_ratio(upload_nnz_mean: float, total_params: float,
                      target_rate: float) -> dict:
    """Achieved payload density vs the configured selector rate."""
    achieved = float(upload_nnz_mean) / float(total_params) if total_params else 0.0
    return {
        "compression_achieved_rate": achieved,
        "compression_target_rate": float(target_rate),
        # >1: selector transmitting more than budgeted (e.g. dense
        # fallback); <1: under-budget (e.g. exact-zero scores dropped).
        "compression_rate_ratio": achieved / target_rate if target_rate else 0.0,
    }


def staleness_percentiles(staleness_counts: dict) -> dict:
    """p50/p90/p99 + moments of a gap→count histogram (the ledger's
    ``staleness_counts``); empty dict in → empty dict out."""
    if not staleness_counts:
        return {}
    gaps = np.asarray(sorted(staleness_counts), np.float64)
    counts = np.asarray([staleness_counts[g] for g in sorted(staleness_counts)],
                        np.float64)
    total = counts.sum()
    cdf = np.cumsum(counts) / total
    pick = lambda q: float(gaps[int(np.searchsorted(cdf, q))])
    return {
        "staleness_p50": pick(0.50),
        "staleness_p90": pick(0.90),
        "staleness_p99": pick(0.99),
        "staleness_mean": float((gaps * counts).sum() / total),
        "staleness_max": float(gaps[-1]),
    }


def record_round_health(rec, *, round_idx: int, cstates, sstate, bcast,
                        gmom=None, upload_nnz_mean: float = 0.0,
                        total_params: float = 0.0,
                        target_rate: float = 0.0,
                        tier: str | None = None, spans=None) -> dict:
    """Compute the per-round health block, push it through the recorder
    (gauges + one ``health`` event), and trip an ``anomaly`` event when
    the broadcast carries NaN/Inf. Returns the block.

    ``tier`` namespaces the gauges (``health.<tier>.*``) and tags the
    ``health`` event — the hierarchical topology records the aggregator
    tier's compensation state alongside the leaf tier's default block.
    ``spans`` as in ``compensation_norms``."""
    block = compensation_norms(cstates, sstate, bcast, gmom=gmom, spans=spans)
    block.update(compression_ratio(upload_nnz_mean, total_params, target_rate))
    prefix = f"health.{tier}." if tier else "health."
    for key, val in block.items():
        if key == "broadcast_finite":
            continue
        rec.gauge_set(f"{prefix}{key}", val)
    if tier:
        rec.event("health", round=int(round_idx), tier=tier, **block)
    else:
        rec.event("health", round=int(round_idx), **block)
    if not block["broadcast_finite"]:
        rec.counter_add("health.anomalies")
        rec.event("anomaly", round=int(round_idx),
                  what="non-finite broadcast",
                  broadcast_norm=block["broadcast_norm"])
    return block
