"""How the sampled cohort maps onto the wire graph (the JAX package's
``topo/layout.py``, numpy only). Both layouts reorder the engines' client
axis (the sorted sampled ids) so the degenerate cases reduce in the star
engine's order:

* ``RingLayout`` splits the cohort into ``segments`` runs of ``hops + 1``
  consecutive positions; position ``p`` of segment ``j`` is cohort index
  ``j * (hops + 1) + p``, so ``hops=0`` gathers nothing.
* ``HierarchicalLayout`` splits the cohort into ``groups`` contiguous
  groups of ``cohort / groups`` clients (``core.state.group_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

TOPOLOGIES = ("star", "ring", "hierarchical")


@dataclasses.dataclass(frozen=True)
class RingLayout:
    """Segmented ring over the sorted cohort: ``segments`` chains of
    ``hops + 1`` clients each; only the chain tails upload to the
    server."""

    cohort: int
    hops: int

    def __post_init__(self):
        if self.hops < 0:
            raise ValueError(f"ring_hops must be >= 0, got {self.hops}")
        if self.cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {self.cohort}")
        if self.cohort % (self.hops + 1) != 0:
            raise ValueError(
                f"ring topology needs the cohort ({self.cohort}) divisible "
                f"by ring_hops + 1 ({self.hops + 1}) so every segment has a "
                f"full chain")

    @property
    def segments(self) -> int:
        return self.cohort // (self.hops + 1)

    def position_indices(self, p: int) -> np.ndarray:
        """Cohort indices of the clients sitting at ring position ``p``
        (one per segment, segment-major)."""
        if not 0 <= p <= self.hops:
            raise ValueError(f"position {p} outside [0, {self.hops}]")
        return np.arange(self.segments) * (self.hops + 1) + p


@dataclasses.dataclass(frozen=True)
class HierarchicalLayout:
    """Two-tier grouping: ``groups`` contiguous groups of
    ``cohort / groups`` leaves, one edge aggregator per group."""

    cohort: int
    groups: int

    def __post_init__(self):
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {self.cohort}")
        if self.cohort % self.groups != 0:
            raise ValueError(
                f"hierarchical topology needs the cohort ({self.cohort}) "
                f"divisible by groups ({self.groups})")

    @property
    def group_size(self) -> int:
        return self.cohort // self.groups


class TopoRoundInfo(NamedTuple):
    """Host-side record of one topology round's wire movement.

    ``ingress_nnz`` are the payloads that actually hit the server (ring
    segment tails / hierarchical aggregator uploads); ``peer_nnz`` the
    payloads that moved client→client (ring hop handoffs / leaf→
    aggregator uploads). ``synced`` says whether the broadcast reached
    the tier below this round (``(t + 1) % sync_every == 0``); on sync
    the server unicasts to ``down_recipients`` and — hierarchical only —
    the aggregators relay to ``relay_recipients`` leaves as peer
    traffic."""

    topology: str
    ingress_nnz: np.ndarray
    peer_nnz: np.ndarray
    down_nnz: float
    union_nnz: float
    synced: bool
    down_recipients: int
    relay_recipients: int


def validate_fl_topology(fl_cfg) -> None:
    """Cross-field FLConfig validation for the topology axis (cohort
    divisibility is checked later, by the engine, once the sampled
    cohort size is known)."""
    topology = getattr(fl_cfg, "topology", "star")
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; choose from {TOPOLOGIES}")
    hops = getattr(fl_cfg, "ring_hops", 0)
    groups = getattr(fl_cfg, "groups", 1)
    sync_every = getattr(fl_cfg, "sync_every", 1)
    if hops < 0:
        raise ValueError(f"ring_hops must be >= 0, got {hops}")
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if topology == "star":
        if hops or groups != 1 or sync_every != 1:
            raise ValueError(
                "ring_hops/groups/sync_every only apply to non-star "
                "topologies — star is the plain hub-and-spoke round")
    elif topology == "ring":
        if groups != 1:
            raise ValueError("groups applies to topology='hierarchical'")
    elif topology == "hierarchical":
        if hops:
            raise ValueError("ring_hops applies to topology='ring'")
    if topology != "star" and getattr(fl_cfg, "backend", "vmap") == "async":
        raise ValueError(
            "the async buffered engine is star-only; use backend='vmap' or "
            "'shard' with non-star topologies")
