"""Backend-pluggable FL round engines.

One FL round = local gradients on every sampled client, the compression
scheme, aggregation, the server update. ``RoundEngine`` owns the round
function for a (FLConfig, CompressionConfig, loss) triple; the simulator
drives it and keeps the host-side bookkeeping (ledger, sampling, adaptive
tau). Every backend and topology runs the same ``_client_update`` /
``_compress_stack`` / ``_server_update``, as in the JAX package:

``vmap``   all sampled clients as one stack on one device.
``shard``  the sampled cohort split into contiguous slices over the ranks
           of a ``torch.distributed`` process group; each rank runs its
           slice, the payload sum is an ``all_reduce``, the new state rows
           and the upload counts are ``all_gather``-ed into cohort order,
           and the server step runs replicated. One rank is the vmap
           engine, bitwise.
``async``  buffered asynchronous aggregation (FedBuff-style): each tick
           dispatches the cohort against the current model, payloads spend
           a sampled delay in flight (``fl/availability.py``), and the
           server flushes whenever ``buffer_size`` payloads wait, each
           weighted by the scheme's ``staleness`` stage. With zero delays
           and a cohort-sized buffer a tick is the vmap round, bitwise.

``FLConfig.topology`` ``ring`` and ``hierarchical`` route to
``TopologyEngine`` (``repro_torch.topo``), over a ``vmap`` or ``shard`` leaf
backend; ``ring(0)`` and ``hierarchical(1)`` are the star, bitwise.

Every backend and topology takes a model of mixed leaf dtypes (a bfloat16
model's float32 routers, ``GroupedLayout``): each flat stack is then a
tuple of one stack per dtype group, and every sum, gather, hop and record
goes group by group, the counts summed over the groups.

Round function signature of the star engines (the JAX package's, eager
here):

    round_fn(params, cstates, sstate, gbar_prev, client_idx, batches,
             round_idx, lr, tau_now[, rates, wire_levels])
      -> (params, cstates, sstate, bcast, upload_nnz[k], download_nnz,
          union_nnz)

The trailing ``rates`` (float32 ``[k]``) and ``wire_levels`` (int32
``[k]``) are the adaptive rate controller's per-client outputs, passed
only under it (``rate_adaptive``; levels only when ``use_levels``).
Under a stochastic wire (``probquant``) the sampled ``client_idx`` rides
into the compression, so each client draws its own noise. A scheme that
``owns_lr`` (FetchSGD) applies the learning rate in its server step, and
its broadcast is the finished update.

Client gradients are ``torch.func.vmap`` of ``torch.func.grad`` over the
client axis; their tree is flattened with one ``torch.cat`` into a
``[k, N]`` stack of the params' ``FlatLayout`` (``utils/flat.py``), the
layout of the compression state. The compression then runs on the flat
stacks with the client axis written out (``Scheme.client_compress``), so
each compression kernel launches once per call for the whole stack: once
a round on the star, once per hop on the ring, once per tier under the
hierarchy. The sampled clients' states move with one op per field (none
under a sketch, whose client state is empty); the payloads (``[k, N]``,
or ``[k, rows·cols]`` sketches) are summed with one ``sum(0)`` and the
server step turns the sum into the ``[N]`` broadcast, which updates the
params through views. Nothing in a synchronous round reads a device
value on the host; the counts come back as device tensors.

The round's phases run inside ``obs.trace.annotate_scope`` ranges with
the reference's names (``round.client_grads``, ``round.client_compress``,
``round.server_aggregate``, ``round.apply_update``; ``topo.ring_hop{p}``
and ``topo.tier_compress``), so a ``torch.profiler`` trace splits a round
by phase whether or not telemetry is on; the async engine's dispatch and
flushes are ``obs.trace.span``s (``tick/dispatch``, ``tick/flush``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (
    gather_client_states,
    group_sum,
    interleave_position_stacks,
    resolve,
    resolve_tier,
    scatter_client_states,
    stack_client_states,
)
from repro_torch.fl import availability
from repro_torch.obs import trace
from repro_torch.topo import (
    TOPOLOGIES,
    HierarchicalLayout,
    RingLayout,
    TopoRoundInfo,
    inject_incoming,
)
from repro_torch.utils import to_device, tree_map

BACKENDS = ("vmap", "shard", "async")
# The process-group backend each device type's collectives need.
GROUP_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def apply_update(w, g, lr, owns_lr: bool = False):
    """The server's SGD step on one param leaf: ``w - lr * g.astype(w.dtype)``
    taken in float32, as the reference takes it (its lr is a float32
    array), and stored in ``w``'s dtype. The reference keeps the float32
    result, so a bfloat16 model's params turn float32 after its first round
    (ROADMAP R13); the port rounds them back to bfloat16, as both packages'
    one-device trainers do (``optim.sgd.apply_updates``), and an
    all-float32 tree steps exactly as before. A scheme that owns lr applied
    it in its server step: the same step at lr 1."""
    if owns_lr:
        lr = 1.0
    return (w.float() - lr * g.to(w.dtype).float()).to(w.dtype)


class RoundEngine:
    """Owns the round step for one backend; consumes the compression
    scheme as a protocol object (``repro_torch.core.resolve(comp_cfg)``)."""

    name = "base"

    def __init__(self, fl_cfg, comp_cfg, loss_fn: Callable, sampled_per_round: int, layout):
        self.fl = fl_cfg
        self.comp = comp_cfg
        self.scheme = resolve(comp_cfg)
        self.loss_fn = loss_fn
        self.sampled_per_round = sampled_per_round
        self.layout = layout  # the params' FlatLayout
        # whether the simulator threads per-client rates, and wire levels
        self.rate_adaptive = self.scheme.rate_adaptive
        self.use_levels = self.rate_adaptive and float(comp_cfg.rate_wire_threshold) > 0.0
        # whether the wire codec keys its draws by client
        self.thread_client_ids = self.scheme.wire.stochastic
        self.round_fn = self._build()

    def _grads(self, params, batches):
        """Local gradients for a stack of clients (leading axis)."""
        with trace.annotate_scope("round.client_grads"):
            grad_fn = torch.func.grad(self.loss_fn)
            return torch.func.vmap(grad_fn, in_dims=(None, 0))(params, batches)

    def _compress_stack(self, states, grads, gbar_prev, round_idx, tau_now, client_ids=None,
                        rates=None, levels=None):
        """``client_compress`` over the whole ``[k, N]`` stack at once."""
        tau_kw = {"tau_override": tau_now} if self.fl.adaptive_tau else {}
        with trace.annotate_scope("round.client_compress"):
            return self.scheme.client_compress(states, grads, gbar_prev, round_idx,
                                               rates=rates, wire_levels=levels,
                                               client_ids=client_ids, layout=self.layout,
                                               **tau_kw)

    def _client_update(self, params, states, batches, gbar_prev, round_idx, tau_now,
                       client_ids=None, rates=None, levels=None):
        grads = self.layout.flatten(self._grads(params, batches))
        return self._compress_stack(states, grads, gbar_prev, round_idx, tau_now, client_ids,
                                    rates, levels)

    def _server_update(self, params, sstate, g_sum, lr, num_contributors=None):
        n = float(self.sampled_per_round if num_contributors is None else num_contributors)
        with trace.annotate_scope("round.server_aggregate"):
            bcast, sstate, ainfo = self.scheme.server_aggregate(sstate, g_sum, n,
                                                                layout=self.layout, lr=lr)
        with trace.annotate_scope("round.apply_update"):
            params = tree_map(lambda w, g: apply_update(w, g, lr, self.scheme.owns_lr), params,
                              self.layout.unflatten(bcast))
        return params, sstate, bcast, ainfo

    def _build(self):
        raise NotImplementedError


class VmapEngine(RoundEngine):
    """Single-device path: all sampled clients as one stack."""

    name = "vmap"

    def _build(self):
        @torch.no_grad()
        def round_fn(params, cstates, sstate, gbar_prev, client_idx, batches,
                     round_idx, lr, tau_now, rates=None, wire_levels=None):
            sampled = gather_client_states(cstates, client_idx)
            G, new_states, infos = self._client_update(
                params, sampled, batches, gbar_prev, round_idx, tau_now,
                client_idx if self.thread_client_ids else None, rates, wire_levels)
            cstates = scatter_client_states(cstates, client_idx, new_states)
            g_sum = tree_map(lambda x: torch.sum(x, dim=0), G)  # one sum per dtype group
            params, sstate, bcast, ainfo = self._server_update(params, sstate, g_sum, lr)
            return (params, cstates, sstate, bcast, infos.upload_nnz,
                    ainfo.download_nnz, ainfo.union_nnz)

        return round_fn


# ---------------------------------------------------------------------------
# shard: the cohort over the ranks of a torch.distributed process group
# ---------------------------------------------------------------------------


def check_group_backend(backend: str, device_type: str) -> None:
    """Raise unless a process group of ``backend`` can carry the
    collectives of tensors on ``device_type``: NCCL for ``cuda``, gloo for
    ``cpu``; a fake one (``launch/dryrun.py``'s, which moves nothing) for
    either."""
    want = GROUP_BACKENDS.get(device_type)
    if want is None:
        raise ValueError(f"the shard backend runs on {tuple(GROUP_BACKENDS)}, "
                         f"not {device_type!r}")
    if str(backend).lower() not in (want, "fake"):
        raise ValueError(f"the shard backend on {device_type!r} needs a {want!r} process "
                         f"group, got {backend!r}")


class ClientShards:
    """This rank's contiguous slice of the sampled cohort over a process
    group (the default one unless ``group`` is given; a 1-D client mesh
    gives its group, as the reference's engine takes the mesh), and the
    collectives that put the slices back together."""

    def __init__(self, fl_cfg, sampled_per_round: int, device, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the shard backend needs an initialised torch.distributed process group: "
                "call torch.distributed.init_process_group(...) on every rank first")
        group = group if group is not None else dist.group.WORLD
        if hasattr(group, "get_group"):  # a client mesh (launch.mesh.make_client_mesh)
            group = group.get_group()
        self.group = group
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        shards = getattr(fl_cfg, "shards", 0)
        if shards not in (0, self.world):
            raise ValueError(f"FLConfig.shards={shards} but the process group has "
                             f"{self.world} ranks (0 means the group's size)")
        if sampled_per_round % self.world != 0:
            raise ValueError(
                f"shard backend needs clients_per_round ({sampled_per_round}) divisible by "
                f"the number of ranks ({self.world})")
        check_group_backend(dist.get_backend(self.group), torch.device(device).type)
        self.per_rank = sampled_per_round // self.world
        self.lo = self.rank * self.per_rank

    def local(self, tree):
        """This rank's rows of a tree of ``[k, ...]`` tensors (None stays None)."""
        if tree is None:
            return None
        return tree_map(lambda x: x[self.lo:self.lo + self.per_rank], tree)

    def gather(self, tree):
        """Every rank's ``[k / world, ...]`` rows, in rank order: ``[k, ...]``."""
        def one(x):
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts)

        return tree_map(one, tree)

    def sum(self, x):
        """The sum of ``x`` over the ranks (``x`` is summed into in place)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


class ShardMapEngine(RoundEngine):
    """The sampled cohort over the ranks of a process group: each rank
    gathers, updates and compresses its contiguous slice of the clients;
    the payload sum is an ``all_reduce`` and the new state rows and upload
    counts are gathered into cohort order, so every rank holds the whole
    state and runs the server step replicated."""

    name = "shard"

    def __init__(self, fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout, group=None):
        self.shards = ClientShards(fl_cfg, sampled_per_round, layout.device, group)
        super().__init__(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)

    def _build(self):
        sh = self.shards

        @torch.no_grad()
        def round_fn(params, cstates, sstate, gbar_prev, client_idx, batches,
                     round_idx, lr, tau_now, rates=None, wire_levels=None):
            ids = sh.local(client_idx)
            G, new_states, infos = self._client_update(
                params, gather_client_states(cstates, ids), sh.local(batches), gbar_prev,
                round_idx, tau_now, ids if self.thread_client_ids else None, sh.local(rates),
                sh.local(wire_levels))
            g_sum = tree_map(lambda x: sh.sum(torch.sum(x, dim=0)), G)
            cstates = scatter_client_states(cstates, client_idx, sh.gather(new_states))
            params, sstate, bcast, ainfo = self._server_update(params, sstate, g_sum, lr)
            return (params, cstates, sstate, bcast, sh.gather(infos.upload_nnz),
                    ainfo.download_nnz, ainfo.union_nnz)

        return round_fn


# ---------------------------------------------------------------------------
# ring and hierarchical topologies
# ---------------------------------------------------------------------------


class TopologyEngine(RoundEngine):
    """Non-star wire graphs (``FLConfig.topology``, ``repro_torch.topo``).
    The per-client numerics are the star engines'; this class rewires who
    talks to whom:

    ``ring``          every client computes its gradient; then a hop loop
                      threads the accumulated payload through each segment
                      (``inject_incoming``), one ``_compress_stack`` over
                      the ``[segments, N]`` stack per position; segment
                      tails upload, earlier hops are peer traffic. The
                      broadcast reaches the clients every ``sync_every``
                      rounds.
    ``hierarchical``  the leaf update is the star's; ``group_sum`` sums each
                      group's payloads and the tier scheme
                      (``resolve_tier``) re-compresses the ``[G, N]`` stack
                      with its own per-aggregator state; the cloud divides
                      by the cohort size once.

    ``backend`` lays out the leaf work: ``vmap``, or ``shard`` over a process
    group (the hierarchy shards the whole leaf update; the ring shards the
    gradients, since its hop loop crosses the ranks' slices)."""

    name = "topo"

    def __init__(self, fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout, group=None):
        self.topology = fl_cfg.topology
        if self.topology not in ("ring", "hierarchical"):
            raise ValueError(f"TopologyEngine handles ring/hierarchical, got "
                             f"{self.topology!r} (star routes to the vmap/shard engines)")
        if resolve(comp_cfg).rate_adaptive:
            raise ValueError(
                "adaptive rate control is star-only: ring hop payloads and hierarchical "
                "tier re-compression have no per-client server-ingress rate to control; "
                "use topology='star' (or the fixed rate_control stage)")
        self.leaf_backend = fl_cfg.backend
        if self.leaf_backend not in ("vmap", "shard"):
            raise ValueError(f"topology={self.topology!r} needs backend 'vmap' or 'shard', "
                             f"got {self.leaf_backend!r}")
        self.shards = (ClientShards(fl_cfg, sampled_per_round, layout.device, group)
                       if self.leaf_backend == "shard" else None)
        self.sync_every = int(fl_cfg.sync_every)
        if self.topology == "ring":
            self.topo = RingLayout(sampled_per_round, int(fl_cfg.ring_hops))
        else:
            self.topo = HierarchicalLayout(sampled_per_round, int(fl_cfg.groups))
            self.tier_scheme = resolve_tier(comp_cfg)
            if self.tier_scheme.is_sketch:
                raise ValueError(
                    "sketch tier schemes are unsupported: the aggregator payload must stay "
                    "model-shaped so the cloud's server_aggregate can consume it")
            self.tier_cstates = None  # made at the first round, from the params
        super().__init__(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)

    def _build(self):
        dev = self.layout.device
        if self.topology == "ring":
            self._positions = [to_device(self.topo.position_indices(p), dev)
                               for p in range(self.topo.hops + 1)]
            return self._ring_round
        self._tier_ids = torch.arange(self.topo.groups, dtype=torch.int64, device=dev)
        return self._hier_round

    @torch.no_grad()
    def _ring_round(self, params, cstates, sstate, gbar_prev, client_idx, batches, round_idx,
                    lr, tau_now):
        hops = self.topo.hops
        sampled = gather_client_states(cstates, client_idx)
        if self.shards is None:
            grads = self.layout.flatten(self._grads(params, batches))
        else:
            sh = self.shards
            grads = sh.gather(self.layout.flatten(self._grads(params, sh.local(batches))))
        incoming = None
        stacks, peer_nnz = [], []
        for p in range(hops + 1):
            if hops == 0:
                st_p, g_p, ids_p = sampled, grads, client_idx
            else:
                take = lambda x, p=p: x.index_select(0, self._positions[p])
                st_p, g_p, ids_p = tree_map(take, sampled), tree_map(take, grads), take(client_idx)
            st_p, g_p, add_after = inject_incoming(self.scheme, st_p, g_p, incoming)
            with trace.annotate_scope(f"topo.ring_hop{p}"):
                G_p, new_p, infos_p = self._compress_stack(
                    st_p, g_p, gbar_prev, round_idx, tau_now,
                    ids_p if self.thread_client_ids else None)
            incoming = tree_map(torch.add, G_p, incoming) if add_after else G_p
            stacks.append(new_p)
            if p < hops:
                peer_nnz.append(infos_p.upload_nnz)
        cstates = scatter_client_states(cstates, client_idx, interleave_position_stacks(stacks))
        params, sstate, bcast, ainfo = self._server_update(
            params, sstate, tree_map(lambda x: torch.sum(x, dim=0), incoming), lr)
        peer = (torch.cat(peer_nnz) if peer_nnz
                else infos_p.upload_nnz.new_zeros((0,)))
        return (params, cstates, sstate, bcast, infos_p.upload_nnz, peer,
                ainfo.download_nnz, ainfo.union_nnz)

    @torch.no_grad()
    def _hier_round(self, params, cstates, sstate, gbar_prev, client_idx, batches, round_idx,
                    lr, tau_now):
        thread = self.thread_client_ids
        if self.shards is None:
            G, new_states, infos = self._client_update(
                params, gather_client_states(cstates, client_idx), batches, gbar_prev,
                round_idx, tau_now, client_idx if thread else None)
            leaf_nnz = infos.upload_nnz
        else:
            sh = self.shards
            ids = sh.local(client_idx)
            G, new_states, infos = self._client_update(
                params, gather_client_states(cstates, ids), sh.local(batches), gbar_prev,
                round_idx, tau_now, ids if thread else None)
            G, new_states, leaf_nnz = sh.gather((G, new_states, infos.upload_nnz))
        cstates = scatter_client_states(cstates, client_idx, new_states)
        gsum = group_sum(G, self.topo.groups)
        with trace.annotate_scope("topo.tier_compress"):
            # the aggregator index is the tier's "client" id for a stochastic wire
            T, self.tier_cstates, tier_infos = self.tier_scheme.client_compress(
                self.tier_cstates, gsum, gbar_prev, round_idx,
                client_ids=self._tier_ids if self.tier_scheme.wire.stochastic else None,
                layout=self.layout)
        params, sstate, bcast, ainfo = self._server_update(
            params, sstate, tree_map(lambda x: torch.sum(x, dim=0), T), lr)
        return (params, cstates, sstate, bcast, tier_infos.upload_nnz, leaf_nnz,
                ainfo.download_nnz, ainfo.union_nnz)

    def topo_round(self, params, cstates, sstate, gbar_prev, client_idx, batches,
                   round_idx: int, lr, tau_now):
        """One topology round. Returns ``(params, cstates, sstate, bcast,
        info)`` with a ``TopoRoundInfo`` of what hit which link; the caller
        gates ``gbar_prev`` and the download charges on ``info.synced``. The
        counts are read from the device once."""
        t = int(round_idx)
        synced = (t + 1) % self.sync_every == 0
        n = self.sampled_per_round
        if self.topology == "hierarchical" and self.tier_cstates is None:
            tier_client, _ = self.tier_scheme.init_states(params)
            self.tier_cstates = stack_client_states(tier_client, self.topo.groups)
        params, cstates, sstate, bcast, ingress, peer, down, union = self.round_fn(
            params, cstates, sstate, gbar_prev, client_idx, batches, t, lr, tau_now)
        host = torch.cat([ingress.double(), peer.double(), down.reshape(1).double(),
                          union.reshape(1).double()]).cpu().numpy()
        ni, npeer = ingress.shape[0], peer.shape[0]
        hier = self.topology == "hierarchical"
        info = TopoRoundInfo(
            topology=self.topology,
            ingress_nnz=host[:ni], peer_nnz=host[ni:ni + npeer],
            down_nnz=float(host[-2]), union_nnz=float(host[-1]), synced=synced,
            down_recipients=(self.topo.groups if hier else n) if synced else 0,
            relay_recipients=n if hier and synced else 0)
        return params, cstates, sstate, bcast, info


# ---------------------------------------------------------------------------
# async: buffered asynchronous aggregation
# ---------------------------------------------------------------------------


class AsyncApply(NamedTuple):
    """Host-side record of one buffered server update (one flush)."""

    down_nnz: float      # post-downlink broadcast nnz (ledger download term)
    union_nnz: float     # pre-downlink union (adaptive-tau signal)
    gaps: np.ndarray     # [B] staleness gap per buffered payload
    up_nnz_mean: float   # mean upload nnz of the buffered payloads
    num: int             # buffer size (number of contributors)


class AsyncBufferedEngine(RoundEngine):
    """Asynchronous buffered aggregation (FedBuff semantics, GMF-aware).

    Every tick the sampled cohort is dispatched: local gradients and
    ``client_compress`` against the current params and broadcast (the vmap
    engine's ``_client_update``), and each payload draws a delay and a
    dropout (``fl/availability.py``, the reference's numpy calls). A
    payload sits in flight until its arrival tick, then queues at the
    server in (arrival, dispatch order); whenever ``buffer_size`` payloads
    wait the server flushes them: the scheme's ``staleness`` stage weighs
    the ``[B, W]`` buffer by each payload's gap (apply tick − dispatch
    tick), one ``sum(0)``, and ``_server_update`` with B contributors.
    Under ``gmf_damp`` the engine keeps the server-held global momentum, a
    flat ``[N]`` EMA of broadcasts ``M ← β·M + (1−β)·Ĝ`` on the broadcast's
    own scale, which the stage blends into stale payloads. A dropped
    payload's client still did the work, so its state is kept; the payload
    never arrives and is never charged.

    With the ``none`` delay model and ``buffer_size`` the cohort, every tick
    dispatches, buffers and flushes the synchronous cohort in order, so
    params, states, broadcast and ledger are the vmap engine's, bitwise.

    The queue holds one record per payload, each one flat row (one per
    dtype group of a tree of mixed dtypes), on the payloads' device: a row
    at 50 % density or more whole, a sparser row as its nonzero values and
    their int32 indices, found for the whole dispatch stack by one sort.
    Values are stored in float16 or bfloat16 under those wires when the
    wire's rounding is the payload's last step (no rotation, no adaptive
    wire levels), so the narrowing is exact, and in the payload's own dtype
    otherwise; a flush decodes each row into a zero row of its payload's
    dtype, as the reference decodes a leaf into its own dtype: the decoded
    buffer is the dense one, bitwise (``encode_queue = False`` keeps dense
    rows, the reference the tests compare against). A dispatch reads the
    device once (upload nnz, each row's nonzero count and the wire levels)
    and a tick's flushes once more (their broadcast counts). The server-held
    global momentum is one ``[N_g]`` per group of such a tree."""

    name = "async"

    def __init__(self, fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout):
        self.buffer_size = int(fl_cfg.buffer_size or sampled_per_round)
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        super().__init__(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)
        self.availability = availability.from_fl_config(fl_cfg)
        self._rng = np.random.default_rng(fl_cfg.seed + 2)
        self._inflight: list[dict] = []   # dispatched, not yet arrived
        self._pending: list[dict] = []    # arrived, waiting for a flush
        self._gmom = None                 # the server-held global momentum, made at tick 0
        self._seq = 0                     # dispatch order, the arrival tiebreaker
        # per-arrival value bytes of the last tick, aligned with its arrived
        # nnz: the ledger's per-payload cost under adaptive wire levels
        self.last_arrived_value_bytes = np.zeros(0, np.float64)
        self.encode_queue = True
        # A 16-bit wire leaves 16-bit values only when nothing follows its
        # rounding: a rotation's inverse, or an int8 drop under adaptive
        # wire levels, leaves float32 values, which are stored as such.
        # Otherwise values are stored in the payload's own dtype (a bfloat16
        # group's payload is bfloat16): None.
        narrow = self.scheme.rotation.identity and not self.use_levels
        self._store_dtype = {"float16": torch.float16, "bfloat16": torch.bfloat16}.get(
            self.scheme.wire.name if narrow else "")

    def _build(self):
        @torch.no_grad()
        def dispatch_fn(params, cstates, gbar_prev, client_idx, batches, round_idx, tau_now,
                        rates=None, wire_levels=None):
            sampled = gather_client_states(cstates, client_idx)
            G, new_states, infos = self._client_update(
                params, sampled, batches, gbar_prev, round_idx, tau_now,
                client_idx if self.thread_client_ids else None, rates, wire_levels)
            cstates = scatter_client_states(cstates, client_idx, new_states)
            return G, cstates, infos.upload_nnz

        return dispatch_fn

    @torch.no_grad()
    def _apply(self, params, sstate, buf, gaps, lr):
        buf = self.scheme.apply_staleness(buf, gaps, self._gmom)
        params, sstate, bcast, ainfo = self._server_update(
            params, sstate, tree_map(lambda x: torch.sum(x, dim=0), buf), lr,
            num_contributors=self.buffer_size)
        if self.scheme.staleness_momentum:
            # on the broadcast's scale: gmf_damp adds M to payloads raw, and
            # the unnormalised form (~1/(1−β) larger) destabilises flushes
            beta = self.comp.beta
            self._gmom = tree_map(lambda mm, b: beta * mm + (1.0 - beta) * b, self._gmom, bcast)
        return params, sstate, bcast, ainfo

    # -- the queue's records -------------------------------------------

    def _encode(self, G, nonzero, rows):
        """Records of the dispatch stack ``G``'s rows ``rows``, exact: whole
        rows at 50 % density or more, else (int32 indices, values)."""
        width = G.shape[1]
        store = self._store_dtype or G.dtype
        records, sparse = {}, []
        for i in rows:
            if 2 * nonzero[i] >= width:
                records[i] = ("dense", G[i].to(store, copy=True))
            else:
                sparse.append(i)
        if sparse:
            # each row's nonzero columns first, in ascending order
            c = int(max(nonzero[i] for i in sparse))
            cols = torch.argsort((G == 0).to(torch.uint8), dim=1, stable=True)[:, :c]
            vals = torch.gather(G, 1, cols).to(store)
            cols = cols.to(torch.int32)
            for i in sparse:
                n = int(nonzero[i])
                records[i] = ("sparse", cols[i, :n], vals[i, :n])
        return records

    @staticmethod
    def _decode(rec, out):
        """Write a record into ``out``, a zero row of the payload's dtype."""
        if rec[0] == "dense":
            out.copy_(rec[1])
        else:
            _, cols, vals = rec
            out.index_copy_(0, cols.long(), vals.to(out.dtype))

    # ------------------------------------------------------------------

    def async_round(self, params, cstates, sstate, gbar_prev, client_idx, batches,
                    round_idx: int, lr, tau_now, rates=None, wire_levels=None):
        """One server tick: dispatch the cohort, land arrivals, flush full
        buffers. Returns ``(params, cstates, sstate, gbar_prev, arrived_nnz,
        applies)``: the host float64 upload nnz that hit the wire this tick
        (the ledger's upload term) and one ``AsyncApply`` per flush.
        ``rates`` / ``wire_levels`` are the adaptive controller's for this
        dispatch; a payload's wire level is fixed at dispatch and rides its
        record, so the ledger charges its bytes when it arrives
        (``last_arrived_value_bytes``)."""
        t = int(round_idx)
        k = client_idx.shape[0]
        if self._gmom is None:
            self._gmom = self.layout.zeros() if self.scheme.staleness_momentum else {}

        with trace.span("tick/dispatch"):
            G, cstates, up_nnz = self.round_fn(params, cstates, gbar_prev, client_idx, batches,
                                               t, tau_now, rates, wire_levels)
        delays = self.availability.sample_delays(self._rng, k)
        drops = self.availability.sample_dropout(self._rng, k)
        # one payload stack, or one per dtype group of a tree of mixed dtypes
        stacks = G if isinstance(G, tuple) else (G,)
        parts = [up_nnz, *(torch.count_nonzero(x, dim=1) for x in stacks)]
        if wire_levels is not None:
            parts.append(wire_levels)
        host = torch.cat([x.double() for x in parts]).cpu().numpy()  # the dispatch's one read
        up_host = host[:k]
        nonzero = [host[(j + 1) * k:(j + 2) * k].astype(np.int64) for j in range(len(stacks))]
        base_vb = float(self.scheme.wire.value_bytes)
        vb_host = (np.where(host[-k:] > 0, 1.0, base_vb) if wire_levels is not None
                   else np.full(k, base_vb))
        sent = [i for i in range(k) if not drops[i]]
        if self.encode_queue:
            enc = [self._encode(x, nz, sent) for x, nz in zip(stacks, nonzero, strict=True)]
        else:
            enc = [{i: ("dense", x[i]) for i in sent} for x in stacks]
        # a record per payload: one per group of a tree of mixed dtypes
        payloads = {i: tuple(e[i] for e in enc) if isinstance(G, tuple) else enc[0][i]
                    for i in sent}
        for i in sent:
            self._inflight.append({"arrival": t + int(delays[i]), "dispatch": t,
                                   "seq": self._seq, "payload": payloads[i],
                                   "nnz": float(up_host[i]), "vb": float(vb_host[i])})
            self._seq += 1

        # arrivals, in (arrival tick, dispatch order)
        landed = sorted((r for r in self._inflight if r["arrival"] <= t),
                        key=lambda r: (r["arrival"], r["seq"]))
        self._inflight = [r for r in self._inflight if r["arrival"] > t]
        self._pending.extend(landed)
        arrived_nnz = np.asarray([r["nnz"] for r in landed], np.float64)
        self.last_arrived_value_bytes = np.asarray([r["vb"] for r in landed], np.float64)

        # flush every full buffer
        flushes = []
        while len(self._pending) >= self.buffer_size:
            chunk = self._pending[:self.buffer_size]
            self._pending = self._pending[self.buffer_size:]
            with trace.span("tick/flush"):
                # decoded in the payloads' dtypes, as the reference decodes a
                # leaf into its own dtype
                bufs = [x.new_zeros((self.buffer_size, x.shape[1])) for x in stacks]
                for b, r in enumerate(chunk):
                    recs = r["payload"] if isinstance(G, tuple) else (r["payload"],)
                    for buf_g, rec in zip(bufs, recs, strict=True):
                        self._decode(rec, buf_g[b])
                buf = tuple(bufs) if isinstance(G, tuple) else bufs[0]
                gaps = np.asarray([t - r["dispatch"] for r in chunk], np.float64)
                dev = up_nnz.device
                params, sstate, bcast, ainfo = self._apply(
                    params, sstate, buf, to_device(gaps.astype(np.float32), dev), lr)
            gbar_prev = bcast
            flushes.append((ainfo, gaps, float(np.mean([r["nnz"] for r in chunk]))))
        applies = []
        if flushes:  # the tick's flushes read their counts from the device once
            counts = torch.stack([torch.stack([a.download_nnz.reshape(()).double(),
                                               a.union_nnz.reshape(()).double()])
                                  for a, _, _ in flushes]).cpu().numpy()
            applies = [AsyncApply(down_nnz=float(c[0]), union_nnz=float(c[1]), gaps=gaps,
                                  up_nnz_mean=mean, num=self.buffer_size)
                       for c, (_, gaps, mean) in zip(counts, flushes, strict=True)]
        return params, cstates, sstate, gbar_prev, arrived_nnz, applies

    @property
    def pending(self) -> int:
        """Arrived payloads waiting for a flush."""
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        """Dispatched payloads still in the network."""
        return len(self._inflight)


def make_engine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout, *,
                group=None) -> RoundEngine:
    """Factory keyed on ``fl_cfg.backend`` and ``fl_cfg.topology``;
    ``layout`` is the params' ``FlatLayout``, ``group`` the process group of
    the shard backend (default: the default group)."""
    backend, topology = fl_cfg.backend, fl_cfg.topology
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; choose from {TOPOLOGIES}")
    if topology != "star":
        if backend == "async":
            raise ValueError("the async buffered engine is star-only; use backend='vmap' "
                             "or 'shard' with non-star topologies")
        return TopologyEngine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout, group)
    if backend == "vmap":
        return VmapEngine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)
    if backend == "shard":
        return ShardMapEngine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout, group)
    if backend == "async":
        return AsyncBufferedEngine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)
    raise ValueError(f"unknown FL backend {backend!r}; choose from {BACKENDS}")


__all__ = [
    "BACKENDS",
    "GROUP_BACKENDS",
    "TOPOLOGIES",
    "AsyncApply",
    "AsyncBufferedEngine",
    "ClientShards",
    "RoundEngine",
    "ShardMapEngine",
    "TopologyEngine",
    "VmapEngine",
    "apply_update",
    "check_group_backend",
    "make_engine",
]
