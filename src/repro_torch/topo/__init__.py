"""The wire-graph topologies of the FL round engines (the JAX package's
``repro.topo``), beside ``backend`` and ``scheme``:

* ``star``: every sampled client uploads straight to the server (the vmap,
  shard and async engines).
* ``ring``: RingFed-style (arXiv:2107.08873) client→client passing. The
  sorted cohort splits into segments of ``ring_hops + 1`` consecutive
  clients; each client injects the payload it received into its own
  compression (``inject_incoming``) and passes the result on; only each
  segment's last client uploads. Hops are peer traffic, and the broadcast
  reaches the clients every ``sync_every`` rounds. ``ring_hops=0`` is the
  star, bitwise.
* ``hierarchical``: two-tier edge aggregation. The cohort splits into
  ``groups`` contiguous groups whose payloads an edge aggregator sums and
  re-compresses with the tier scheme (``core.registry.resolve_tier``),
  which keeps its own GMF momentum and EF residual per aggregator.
  ``groups=1`` with the dense tier is the star, bitwise.

This package holds the layouts, the validation and the injection; the
``TopologyEngine`` in ``fl/engine.py`` binds them to the round.
"""

from repro_torch.topo.inject import inject_incoming
from repro_torch.topo.layout import (
    TOPOLOGIES,
    HierarchicalLayout,
    RingLayout,
    TopoRoundInfo,
    validate_fl_topology,
)

__all__ = [
    "TOPOLOGIES",
    "HierarchicalLayout",
    "RingLayout",
    "TopoRoundInfo",
    "inject_incoming",
    "validate_fl_topology",
]
