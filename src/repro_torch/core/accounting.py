"""Communication-overhead accounting (paper §2.1, Tables 3/4).

* A **sparse payload** of ``nnz`` entries costs ``nnz * (value_bytes +
  index_bytes)`` on the wire (4-byte fp32 value + 4-byte int32 index).
* A **dense payload** costs ``n * value_bytes``. A payload is charged dense
  whenever that is cheaper.
* Per round: upload = Σ_k payload(G_k); download = K · payload(Ĝ) — the
  server unicasts the aggregate to each client (hub-and-spoke).
* Non-star topologies also move **peer** traffic that never touches the
  server: ring hop payloads (client→client) and the hierarchical
  leaf→aggregator uploads and aggregator→leaf relays. The ledger keeps it
  in ``peer_bytes``, so ``upload_bytes`` stays the server-ingress link.

* A **sketch upload** (FetchSGD) is a fixed-shape dense buffer: its nnz
  values are charged value bytes only, never indices, never the dense
  fallback (``CostModel.upload_dense_values``).

All byte arithmetic happens on the host in float64, as in the JAX package:
round byte counts exceed float32's exact-integer range at ≥1e9 params.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import metrics as _obs


@dataclasses.dataclass(frozen=True)
class CostModel:
    value_bytes: float = 4  # a float: the probquant wire charges 0.25 byte a value
    index_bytes: int = 4
    unicast_download: bool = True  # server sends aggregate to each of K clients
    upload_dense_values: bool = False  # sketch uploads: value bytes only

    def payload_bytes(self, nnz, total, value_bytes=None):
        """Cheaper of sparse (value+index per nnz) and dense (value per elem).
        ``value_bytes`` (a scalar or one per payload) overrides the model's
        per-value cost: the adaptive rate controller charges a client it
        dropped to the int8 wire 1 byte a value for that round."""
        vb = np.asarray(self.value_bytes if value_bytes is None else value_bytes, np.float64)
        sparse = np.asarray(nnz, np.float64) * (vb + self.index_bytes)
        dense = np.float64(total) * vb
        return np.minimum(sparse, dense)

    def upload_payload_bytes(self, nnz, total, value_bytes=None):
        """Upload cost of the clients' payloads (sketches are value-only)."""
        if self.upload_dense_values:
            vb = np.asarray(self.value_bytes if value_bytes is None else value_bytes,
                            np.float64)
            return np.asarray(nnz, np.float64) * vb
        return self.payload_bytes(nnz, total, value_bytes)

    def round_bytes(self, upload_nnz_per_client, download_nnz, total, num_clients,
                    value_bytes=None):
        """(upload, download) bytes moved in one FL round; ``value_bytes``
        overrides the upload payloads' per-value cost, one per client."""
        up = np.sum(self.upload_payload_bytes(upload_nnz_per_client, total, value_bytes))
        down = self.payload_bytes(download_nnz, total)
        if self.unicast_download:
            down = down * num_clients
        return up, down


class CommLedger:
    """Accumulates upload, download and peer bytes across rounds (host-side).

    Synchronous engines call ``record_round`` once a round. The async
    buffered engine decomposes the same arithmetic: ``record_upload`` when
    payloads hit the wire (on arrival), ``record_download`` per flush (the
    fresh broadcast unicast to that flush's contributors),
    ``record_staleness`` with the flush's per-payload gaps, and ``tick``.
    The topology engines charge hop and leaf payloads with ``record_peer``
    and the aggregators' relay with ``record_peer_download``.

    Every ``record_*`` and ``tick`` also publishes through the
    ``repro_torch.obs`` registry, as the JAX package's ledger does: the
    ``comm.upload_bytes``, ``comm.download_bytes``, ``comm.peer_bytes``
    and ``comm.rounds`` counters and one ``comm.staleness_gap``
    observation per gap. That is the shared no-op recorder until
    ``repro_torch.obs.configure()`` turns telemetry on, and it leaves the
    ledger's own totals bitwise as they are either way."""

    def __init__(self, cost_model: CostModel | None = None):
        self.cost = cost_model or CostModel()
        self.upload_bytes = 0.0
        self.download_bytes = 0.0
        self.peer_bytes = 0.0
        self.rounds = 0
        self.staleness_counts: dict[int, int] = {}

    def record_round(self, upload_nnz_per_client, download_nnz, total, num_clients,
                     value_bytes=None):
        self.record_upload(upload_nnz_per_client, total, value_bytes)
        self.record_download(download_nnz, total, num_clients)
        self.tick()

    def _uploads(self, nnz, total, value_bytes=None) -> float:
        return float(np.sum(self.cost.upload_payload_bytes(np.asarray(nnz, np.float64), total,
                                                           value_bytes)))

    def _unicasts(self, download_nnz, total, recipients) -> float:
        down = self.cost.payload_bytes(download_nnz, total)
        return float(down * recipients if self.cost.unicast_download else down)

    def record_upload(self, upload_nnz_per_client, total, value_bytes=None):
        """Charge client→server payloads that hit the wire; ``value_bytes``
        overrides the per-value cost, a scalar or one per payload."""
        up = self._uploads(upload_nnz_per_client, total, value_bytes)
        self.upload_bytes += up
        _obs.get().counter_add("comm.upload_bytes", up)

    def record_download(self, download_nnz, total, num_clients):
        """Charge one broadcast unicast to ``num_clients`` recipients."""
        down = self._unicasts(download_nnz, total, num_clients)
        self.download_bytes += down
        _obs.get().counter_add("comm.download_bytes", down)

    def record_peer(self, nnz_per_payload, total):
        """Charge payloads that never touch the server (ring hops,
        hierarchical leaf→aggregator uploads), priced as uploads."""
        p = self._uploads(nnz_per_payload, total)
        self.peer_bytes += p
        _obs.get().counter_add("comm.peer_bytes", p)

    def record_peer_download(self, download_nnz, total, num_recipients):
        """Charge the aggregators' relay of the broadcast to
        ``num_recipients`` leaves as peer traffic."""
        down = self._unicasts(download_nnz, total, num_recipients)
        self.peer_bytes += down
        _obs.get().counter_add("comm.peer_bytes", down)

    def record_staleness(self, gaps):
        """Count per-payload staleness gaps (whole ticks) into the histogram."""
        rec = _obs.get()
        for g in np.asarray(gaps).astype(np.int64).reshape(-1):
            g = int(g)
            self.staleness_counts[g] = self.staleness_counts.get(g, 0) + 1
            rec.observe("comm.staleness_gap", g)

    def tick(self):
        self.rounds += 1
        _obs.get().counter_add("comm.rounds")

    @property
    def total_bytes(self) -> float:
        return self.upload_bytes + self.download_bytes + self.peer_bytes

    @property
    def total_gb(self) -> float:
        return self.total_bytes / 1e9

    def staleness_summary(self) -> dict:
        """Histogram and moments of the recorded gaps ({} when none was
        recorded: synchronous runs)."""
        if not self.staleness_counts:
            return {}
        gaps = np.asarray(sorted(self.staleness_counts), np.int64)
        counts = np.asarray([self.staleness_counts[int(g)] for g in gaps], np.int64)
        n = int(counts.sum())
        return {
            "staleness_hist": {int(g): int(c) for g, c in zip(gaps, counts, strict=True)},
            "staleness_mean": float((gaps * counts).sum() / n),
            "staleness_max": int(gaps[-1]),
            "staleness_updates": n,
        }

    def summary(self) -> dict:
        out = {
            "rounds": self.rounds,
            "upload_gb": self.upload_bytes / 1e9,
            "server_ingress_gb": self.upload_bytes / 1e9,  # upload is the server-ingress link
            "download_gb": self.download_bytes / 1e9,
            "peer_gb": self.peer_bytes / 1e9,
            "total_gb": self.total_gb,
        }
        out.update(self.staleness_summary())
        return out


def dense_round_gb(total_params: int, num_clients: int, value_bytes: int = 4) -> float:
    """Analytic cost of one uncompressed round (a sanity bound for tests)."""
    up = num_clients * total_params * value_bytes
    down = num_clients * total_params * value_bytes
    return (up + down) / 1e9
