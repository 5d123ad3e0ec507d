"""Federated-learning simulator (paper §4 experiments).

One process simulates K clients + server on one device (or, under the
``shard`` backend, each rank of a process group runs one simulator over
its slice of the cohort). The per-round compute lives in the
``RoundEngine`` (fl/engine.py): the synchronous ``vmap`` and ``shard``
rounds, the ``async`` engine's ticks (``_run_async``: uploads charged on
arrival, downloads per flush, each flush's staleness gaps into the
ledger's histogram) and the ``ring`` and ``hierarchical`` topologies'
rounds (``_run_topo``: hops and leaf uploads charged as peer bytes, the
broadcast only on sync rounds). The simulator keeps
the host-side bookkeeping: cohort sampling and batch draws from
``np.random.default_rng(seed + 1)`` (the JAX package's stream, call for
call), the ``CommLedger`` (its upload term through
``CostModel.upload_payload_bytes``: a sketch is value bytes only), the
learning-rate decay, the adaptive-τ controller and, under an adaptive
rate controller, its per-round step:
the signal ``‖V_k‖ / (‖Ĝ_prev‖ + eps)`` as one norm per row of the flat
stacks, the bandwidth budget from ``np.random.default_rng(seed + 3)``
(drawn only then, so the sampling and batch streams stay the
reference's), and the controller update, all on the device. The
per-round counts, and the rates and wire levels with them, are read from
the device once per round.

Partial participation: sampled clients' states are gathered, compressed
and scattered back; non-participants keep V/U/M untouched. The states are
flat ``[K, N]`` stacks and the last broadcast ``gbar_prev`` a flat ``[N]``
vector, both of the params' ``FlatLayout`` (``utils/flat.py``); the params
stay a tree.

Telemetry (``repro_torch.obs``) hooks in as in the JAX package: a
``round`` (``tick``) span around each round's work, and, only when
``obs.configure()`` has turned it on, a ``round`` event per round
(``wall_ms`` is the record's ``round_ms``), the ``fl.round_ms`` series,
the ``fl.tau`` gauge, the rate controller's series from the round's one
read, the async loop's ``flush`` events and ``fl.pending`` /
``fl.in_flight`` gauges, the topology loop's ``topo_round`` event, and the
health block (``obs/health.py``), which adds one device read a round. With
telemetry off the recorder is the shared no-op object: nothing is read,
launched or written.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import CommLedger, CompressionConfig, init_states
from repro_torch.core import adaptive, stack_client_states
from repro_torch.fl import availability
from repro_torch.fl.engine import BACKENDS, make_engine
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.topo import validate_fl_topology
from repro_torch.utils import resolve_device, scalar, to_device, tree_map
from repro_torch.utils.flat import FlatLayout


@dataclasses.dataclass
class FLConfig:
    """The JAX package's ``FLConfig``: the backend (``vmap``, ``shard`` or
    ``async``), the async engine's buffer and availability model, the
    adaptive-τ controller and the wire-graph topology."""

    num_clients: int
    rounds: int
    clients_per_round: int = 0  # 0 → all
    batch_size: int = 64
    learning_rate: float = 0.1
    lr_decay_rounds: int = 0    # halve lr every N rounds (0 = constant)
    seed: int = 0
    eval_every: int = 10
    backend: str = "vmap"
    shards: int = 0
    buffer_size: int = 0
    delay_model: str = "none"
    delay_mean: float = 0.0
    delay_max: int = 0
    dropout_rate: float = 0.0
    # closed-loop fusion-ratio control (core/adaptive.py)
    adaptive_tau: bool = False
    tau_target_overlap: float = 0.8
    tau_eta: float = 0.15
    tau_max: float = 0.9
    topology: str = "star"
    ring_hops: int = 0
    sync_every: int = 1
    groups: int = 1

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; choose from {BACKENDS}")
        if self.buffer_size < 0:
            raise ValueError(f"buffer_size must be >= 0, got {self.buffer_size}")
        validate_fl_topology(self)
        availability.from_fl_config(self)  # the availability fields, checked now


class FLSimulator:
    """Generic over (model params, loss_fn(params, batch) -> scalar).

    ``init_fn(generator)`` returns the initial params; the generator is a
    CPU ``torch.Generator`` seeded with ``fl_cfg.seed``. Everything runs on
    ``device`` (default ``cuda``, which must exist). ``group`` is the
    shard backend's process group (default: the default group), or a
    client mesh (``launch.mesh.make_client_mesh``) whose group it takes."""

    def __init__(
        self,
        fl_cfg: FLConfig,
        comp_cfg: CompressionConfig,
        init_fn: Callable[[torch.Generator], dict],
        loss_fn: Callable[[dict, tuple], torch.Tensor],
        eval_fn: Callable[[dict], float] | None = None,
        *,
        device="cuda",
        group=None,
    ):
        self.device = resolve_device(device)
        self.fl = fl_cfg
        self.comp = comp_cfg
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        gen = torch.Generator().manual_seed(fl_cfg.seed)
        self.params = tree_map(lambda x: x.to(self.device), init_fn(gen))
        self.layout = FlatLayout.of(self.params)
        self.total_params = self.layout.total
        k = fl_cfg.clients_per_round or fl_cfg.num_clients
        self.sampled_per_round = k
        # Per-client compression state, stacked over ALL clients.
        cstate1, self.sstate = init_states(comp_cfg, self.params)
        self.cstates = stack_client_states(cstate1, fl_cfg.num_clients)
        self.gbar_prev = self.layout.zeros()
        self.history: list[dict] = []
        self.tau_ctl = adaptive.init(comp_cfg.tau if not fl_cfg.adaptive_tau else 0.0)
        self.engine = make_engine(fl_cfg, comp_cfg, loss_fn, k, self.layout, group=group)
        self.ledger = CommLedger(self.engine.scheme.cost_model())
        self._round_fn = self.engine.round_fn
        self._rng = np.random.default_rng(fl_cfg.seed + 1)
        # adaptive per-client rate control: nothing is allocated or drawn
        # under the fixed controller
        self.rate_adaptive = self.engine.rate_adaptive
        if self.rate_adaptive:
            self.rate_state = self.engine.scheme.rate_control.init(
                comp_cfg, fl_cfg.num_clients, self.device)
            self._bw_rng = np.random.default_rng(fl_cfg.seed + 3)
            self._avail = availability.from_fl_config(fl_cfg)
            self._last_gap = 0.0  # async: the previous tick's mean applied gap

    def _signal(self, ids: torch.Tensor) -> torch.Tensor:
        """Each sampled client's EF-residual mass over the global delta
        norm, ``‖V_k‖ / (‖Ĝ_prev‖ + eps)``, float32 ``[k]`` (zeros for
        schemes without V: a flat signal); over the whole tree, every dtype
        group's squares summed in float32, as the reference sums its
        leaves'."""
        v = self.cstates.v
        if isinstance(v, tuple):  # a tree of mixed dtypes: float32 sums over its groups
            vsq = sum(torch.sum(torch.square(x.index_select(0, ids).float()), dim=1) for x in v)
            gsq = sum(torch.sum(torch.square(x.float())) for x in self.gbar_prev)
            return torch.sqrt(vsq) / (torch.sqrt(gsq) + self.comp.eps)
        if not isinstance(v, torch.Tensor):
            return torch.zeros(ids.shape[0], dtype=torch.float32, device=self.device)
        vsq = torch.sum(torch.square(v.index_select(0, ids)), dim=1)
        gsq = torch.sum(torch.square(self.gbar_prev))
        return torch.sqrt(vsq) / (torch.sqrt(gsq) + self.comp.eps)

    def _rate_inputs(self, ids: torch.Tensor, gap: float):
        """One controller step at staleness ``gap`` (0.0 in a synchronous
        round): the signal, the bandwidth budget, the update -> (rates [k],
        wire levels [k] or None), on the device."""
        bw = self._avail.sample_bandwidth(self._bw_rng, ids.shape[0]).astype(np.float32)
        self.rate_state, rates, levels = self.engine.scheme.rate_control.update(
            self.comp, self.rate_state, ids, self._signal(ids), to_device(bw, self.device),
            scalar(gap, self.device))
        return rates, (levels if self.engine.use_levels else None)

    def _sample_ids(self, t: int) -> np.ndarray:
        fl = self.fl
        if self.sampled_per_round < fl.num_clients:
            ids = self._rng.choice(fl.num_clients, self.sampled_per_round, replace=False)
        else:
            ids = np.arange(fl.num_clients)
        return np.sort(ids)

    def _lr_at(self, t: int) -> float:
        fl = self.fl
        lr = fl.learning_rate
        if fl.lr_decay_rounds:
            lr = lr * (0.5 ** (t // fl.lr_decay_rounds))
        return lr

    def run(self, batch_provider, *, log_every: int = 0, on_round=None):
        """batch_provider(round, client_ids, rng) -> stacked batch with
        leading axis len(client_ids). Each history record carries the
        JAX package's keys plus ``upload_nnz`` (per client),
        ``download_nnz`` and ``round_ms`` (host clock, round start to the
        counts' arrival);
        under an adaptive rate controller also ``rates`` and, with wire
        levels, ``wire_levels`` (per client). The async and topology loops
        (``_run_async``, ``_run_topo``) keep the JAX package's keys plus
        ``round_ms``."""
        if self.engine.name == "async":
            return self._run_async(batch_provider, log_every=log_every, on_round=on_round)
        if self.engine.name == "topo":
            return self._run_topo(batch_provider, log_every=log_every, on_round=on_round)
        fl = self.fl
        obs = obs_metrics.get()
        for t in range(fl.rounds):
            t0 = time.perf_counter()
            up_before, down_before = self.ledger.upload_bytes, self.ledger.download_bytes
            ids = self._sample_ids(t)
            batches = batch_provider(t, ids, self._rng)
            lr = self._lr_at(t)
            tau_now = scalar(float(self.tau_ctl.tau), self.device) if fl.adaptive_tau else None
            ids_dev = to_device(ids, self.device)
            rates = levels = None
            if self.rate_adaptive:
                rates, levels = self._rate_inputs(ids_dev, 0.0)
            with trace.span("round"):
                (
                    self.params,
                    self.cstates,
                    self.sstate,
                    self.gbar_prev,
                    up_nnz,
                    down_nnz,
                    union_nnz,
                ) = self._round_fn(
                    self.params,
                    self.cstates,
                    self.sstate,
                    self.gbar_prev,
                    ids_dev,
                    batches,
                    t,
                    lr,
                    tau_now,
                    rates,
                    levels,
                )
                # The round's one device read: per-client upload nnz, download
                # nnz and union nnz (and the rates and levels) in one float64
                # copy, exact for counts below 2**53.
                parts = [up_nnz, down_nnz.reshape(1), union_nnz.reshape(1)]
                parts += [x for x in (rates, levels) if x is not None]
                host = torch.cat([x.double() for x in parts]).cpu()  # repro-noqa: REP004 (the round's one read: the span and round_ms end at the counts' arrival)
            wall_ms = (time.perf_counter() - t0) * 1e3
            k = len(ids)
            host = host.numpy()
            up_host = host[:k].astype(np.int64)
            down, union = float(host[k]), float(host[k + 1])
            value_bytes = rates_host = levels_host = None
            if levels is not None:
                levels_host = host[-k:].astype(np.int32)
                value_bytes = np.where(levels_host > 0, 1.0,
                                       float(self.engine.scheme.wire.value_bytes))
            self.ledger.record_round(up_host, down, self.total_params, k, value_bytes)
            if fl.adaptive_tau:
                self._tau_update(float(np.mean(up_host)), union)
            rec = {"round": t, "comm_gb": self.ledger.total_gb,
                   "tau": float(self.tau_ctl.tau),
                   "upload_nnz": [int(x) for x in up_host], "download_nnz": int(down),
                   "round_ms": wall_ms}
            if rates is not None:
                rates_host = host[k + 2:2 * k + 2].astype(np.float32)
                rec["rate_mean"] = float(rates_host.mean())
                rec["rates"] = rates_host.tolist()
                if levels is not None:
                    rec["wire_levels"] = levels_host.tolist()
            self._evaluate(t, rec)
            if obs.enabled:
                extra = (self._rate_obs(obs, rates_host, levels_host)
                         if self.rate_adaptive else None)
                self._record_round_obs(obs, t, rec, up_before, down_before,
                                       float(np.mean(up_host)), down, union, extra=extra)
            self._finish(t, rec, log_every, on_round,
                         f"[round {t:4d}] comm={self.ledger.total_gb:.4f} GB")
        return self.history

    def _tau_update(self, up_nnz_mean: float, union_nnz: float) -> None:
        fl = self.fl
        self.tau_ctl = adaptive.update(self.tau_ctl, up_nnz_mean, union_nnz,
                                       target_overlap=fl.tau_target_overlap, eta=fl.tau_eta,
                                       tau_max=fl.tau_max)

    def _evaluate(self, t, rec):
        """Evaluation (every ``eval_every`` rounds and the last) and history
        of round or tick ``t``."""
        fl = self.fl
        if self.eval_fn and (t % fl.eval_every == 0 or t == fl.rounds - 1):
            rec["accuracy"] = float(self.eval_fn(self.params))
        self.history.append(rec)

    def _finish(self, t, rec, log_every, on_round, log_line):
        """Log line and callback of round or tick ``t``."""
        if log_every and t % log_every == 0:
            acc = rec.get("accuracy")
            acc_s = f" acc={acc:.4f}" if acc is not None else ""
            print(f"{log_line}{acc_s}", flush=True)
        if on_round:
            on_round(t, self)

    def _rate_obs(self, obs, rates, levels):
        """Publish the controller's decisions from the host copies of this
        round's ``rates`` (and wire ``levels``, or None): the
        ``rate.effective`` series (one observation per sampled client), the
        ``fl.rate_mean`` gauge and the round event's extras."""
        r = np.asarray(rates, np.float64)
        for x in r:
            obs.observe("rate.effective", float(x))
        obs.gauge_set("fl.rate_mean", float(r.mean()))
        extra = {"rate_mean": float(r.mean()), "rate_min": float(r.min()),
                 "rate_max": float(r.max())}
        if levels is not None:
            extra["int8_drops"] = int(np.asarray(levels).sum())
        return extra

    def _record_round_obs(self, obs, t, rec, up_before, down_before, up_nnz_mean, down_nnz,
                          union_nnz, extra=None):
        """Telemetry for one finished round or tick, called only when
        telemetry is enabled: the ``round`` event (``wall_ms`` is the
        record's ``round_ms``, and this round's wire bytes), the
        ``fl.round_ms`` series, the ``fl.tau`` gauge and the health block
        (``obs/health.py``: one device read of the state's norms)."""
        obs.observe("fl.round_ms", rec["round_ms"])
        obs.gauge_set("fl.tau", rec["tau"])
        ev = {"round": t, "wall_ms": rec["round_ms"],
              "upload_bytes": self.ledger.upload_bytes - up_before,
              "download_bytes": self.ledger.download_bytes - down_before,
              "upload_nnz_mean": up_nnz_mean, "download_nnz": down_nnz,
              "union_nnz": union_nnz, "tau": rec["tau"]}
        if "accuracy" in rec:
            ev["accuracy"] = rec["accuracy"]
        if extra:
            ev.update(extra)
        obs.event("round", **ev)
        obs_health.record_round_health(
            obs, round_idx=t, cstates=self.cstates, sstate=self.sstate, bcast=self.gbar_prev,
            gmom=getattr(self.engine, "_gmom", None), upload_nnz_mean=up_nnz_mean,
            total_params=self.total_params, target_rate=self.comp.rate)

    def _run_async(self, batch_provider, *, log_every: int = 0, on_round=None):
        """The asynchronous buffered loop (``backend="async"``). One
        iteration is one server tick: the cohort is dispatched against the
        current model, in-flight payloads land and the engine flushes zero
        or more buffers. The ledger charges uploads on arrival (a dropped
        payload never hit the wire) and downloads per flush (the fresh
        broadcast unicast to that flush's contributors), and takes each
        flush's gaps into its histogram. With zero delays and a cohort-sized
        buffer a tick charges what ``record_round`` would."""
        fl = self.fl
        obs = obs_metrics.get()
        for t in range(fl.rounds):
            t0 = time.perf_counter()
            up_before, down_before = self.ledger.upload_bytes, self.ledger.download_bytes
            ids = self._sample_ids(t)
            batches = batch_provider(t, ids, self._rng)
            lr = self._lr_at(t)
            tau_now = scalar(float(self.tau_ctl.tau), self.device) if fl.adaptive_tau else None
            ids_dev = to_device(ids, self.device)
            rates = levels = None
            if self.rate_adaptive:
                # the staleness input: the previous tick's mean applied gap
                # (0.0 at tick 0 and throughout a zero-delay run)
                rates, levels = self._rate_inputs(ids_dev, self._last_gap)
            with trace.span("tick"):
                (self.params, self.cstates, self.sstate, self.gbar_prev, arrived_nnz,
                 applies) = self.engine.async_round(
                    self.params, self.cstates, self.sstate, self.gbar_prev, ids_dev, batches,
                    t, lr, tau_now, rates, levels)
                if arrived_nnz.size:
                    # each arrival at the wire level it was dispatched with
                    vb = self.engine.last_arrived_value_bytes if self.rate_adaptive else None
                    self.ledger.record_upload(arrived_nnz, self.total_params, vb)
                for ap in applies:
                    self.ledger.record_download(ap.down_nnz, self.total_params, ap.num)
                    self.ledger.record_staleness(ap.gaps)
                    obs.event("flush", round=t, staleness_gaps=[int(g) for g in ap.gaps],  # repro-noqa: REP004 (ap.gaps is a host array)
                              down_nnz=ap.down_nnz, union_nnz=ap.union_nnz,
                              up_nnz_mean=ap.up_nnz_mean, num=ap.num)
                    if fl.adaptive_tau:  # per flush: the buffer's mean upload vs its union
                        self._tau_update(ap.up_nnz_mean, ap.union_nnz)
                self.ledger.tick()
            wall_ms = (time.perf_counter() - t0) * 1e3
            rec = {"round": t, "comm_gb": self.ledger.total_gb, "tau": float(self.tau_ctl.tau),
                   "applies": len(applies), "pending": self.engine.pending,
                   "in_flight": self.engine.in_flight, "round_ms": wall_ms}
            rates_host = levels_host = None
            if self.rate_adaptive:
                # the controller's outputs in one read (float32 rates exact in float64)
                host = torch.cat([x.double() for x in (rates, levels) if x is not None])
                host = host.cpu().numpy()
                rates_host = host[:len(ids)].astype(np.float32)
                if levels is not None:
                    levels_host = host[len(ids):].astype(np.int32)
                rec["rate_mean"] = float(rates_host.mean())
            if applies:
                gaps = np.concatenate([ap.gaps for ap in applies])
                rec["staleness_mean"] = float(gaps.mean())
                if self.rate_adaptive:
                    self._last_gap = float(gaps.mean())
            self._evaluate(t, rec)
            if obs.enabled:
                up_mean = (float(np.mean([ap.up_nnz_mean for ap in applies]))
                           if applies else 0.0)
                down_last = float(applies[-1].down_nnz) if applies else 0.0
                union_last = float(applies[-1].union_nnz) if applies else 0.0
                obs.gauge_set("fl.pending", self.engine.pending)
                obs.gauge_set("fl.in_flight", self.engine.in_flight)
                extra = {"applies": len(applies), "pending": self.engine.pending,
                         "in_flight": self.engine.in_flight}
                if self.rate_adaptive:
                    extra.update(self._rate_obs(obs, rates_host, levels_host))
                self._record_round_obs(obs, t, rec, up_before, down_before, up_mean,
                                       down_last, union_last, extra=extra)
            self._finish(t, rec, log_every, on_round,
                         f"[tick {t:4d}] comm={self.ledger.total_gb:.4f} GB "
                         f"applies={len(applies)} pending={self.engine.pending}")
        return self.history

    def _run_topo(self, batch_provider, *, log_every: int = 0, on_round=None):
        """The non-star loop (``topology="ring" | "hierarchical"``). The
        ledger splits the wire per link: ring hops and hierarchical
        leaf→aggregator uploads are peer bytes, only what reaches the
        server is upload (server-ingress) bytes, and the broadcast is
        charged, server→clients on the ring, server→aggregators plus the
        aggregators' peer relay to the leaves in the hierarchy, only on
        sync rounds (``sync_every``), when the clients also see it
        (``gbar_prev`` stays stale in between)."""
        fl = self.fl
        eng = self.engine
        obs = obs_metrics.get()
        for t in range(fl.rounds):
            t0 = time.perf_counter()
            up_before, down_before = self.ledger.upload_bytes, self.ledger.download_bytes
            peer_before = self.ledger.peer_bytes
            ids = self._sample_ids(t)
            batches = batch_provider(t, ids, self._rng)
            lr = self._lr_at(t)
            tau_now = scalar(float(self.tau_ctl.tau), self.device) if fl.adaptive_tau else None
            with trace.span("round"):
                self.params, self.cstates, self.sstate, bcast, info = eng.topo_round(
                    self.params, self.cstates, self.sstate, self.gbar_prev,
                    to_device(ids, self.device), batches, t, lr, tau_now)
                if info.synced:
                    self.gbar_prev = bcast
                if info.peer_nnz.size:
                    self.ledger.record_peer(info.peer_nnz, self.total_params)
                self.ledger.record_upload(info.ingress_nnz, self.total_params)
                if info.synced:
                    self.ledger.record_download(info.down_nnz, self.total_params,
                                                info.down_recipients)
                    if info.relay_recipients:
                        self.ledger.record_peer_download(info.down_nnz, self.total_params,
                                                         info.relay_recipients)
                self.ledger.tick()
            wall_ms = (time.perf_counter() - t0) * 1e3
            ingress_mean = float(np.mean(info.ingress_nnz))
            if fl.adaptive_tau:
                self._tau_update(ingress_mean, float(info.union_nnz))
            rec = {"round": t, "comm_gb": self.ledger.total_gb, "tau": float(self.tau_ctl.tau),
                   "topology": info.topology, "synced": info.synced,
                   "server_ingress_gb": self.ledger.upload_bytes / 1e9,
                   "peer_gb": self.ledger.peer_bytes / 1e9, "round_ms": wall_ms}
            self._evaluate(t, rec)
            if obs.enabled:
                peer = self.ledger.peer_bytes - peer_before
                obs.event("topo_round", round=t, topology=info.topology,
                          server_ingress_bytes=self.ledger.upload_bytes - up_before,
                          peer_bytes=peer, synced=info.synced, down_nnz=info.down_nnz)
                self._record_round_obs(
                    obs, t, rec, up_before, down_before, ingress_mean, float(info.down_nnz),
                    float(info.union_nnz),
                    extra={"topology": info.topology, "synced": info.synced, "peer_bytes": peer})
                if info.topology == "hierarchical":
                    # the aggregator tier's block, under its own gauge prefix:
                    # the tier scheme's state is where the hierarchy's
                    # compression error lives
                    obs_health.record_round_health(
                        obs, round_idx=t, cstates=eng.tier_cstates, sstate=self.sstate,
                        bcast=bcast, upload_nnz_mean=ingress_mean,
                        total_params=self.total_params, target_rate=self.comp.tier_rate,
                        tier="aggregator")
            self._finish(t, rec, log_every, on_round,
                         f"[round {t:4d}] {info.topology} "
                         f"ingress={self.ledger.upload_bytes / 1e9:.4f} GB "
                         f"total={self.ledger.total_gb:.4f} GB"
                         f"{' sync' if info.synced else ''}")
        return self.history

    def final_accuracy(self) -> float | None:
        for rec in reversed(self.history):
            if "accuracy" in rec:
                return rec["accuracy"]
        return None
