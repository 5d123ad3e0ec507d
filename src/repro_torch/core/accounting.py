"""Communication-overhead accounting (paper §2.1, Tables 3/4).

* A **sparse payload** of ``nnz`` entries costs ``nnz * (value_bytes +
  index_bytes)`` on the wire (4-byte fp32 value + 4-byte int32 index).
* A **dense payload** costs ``n * value_bytes``. A payload is charged dense
  whenever that is cheaper.
* Per round: upload = Σ_k payload(G_k); download = K · payload(Ĝ) — the
  server unicasts the aggregate to each client (hub-and-spoke).

* A **sketch upload** (FetchSGD) is a fixed-shape dense buffer: its nnz
  values are charged value bytes only, never indices, never the dense
  fallback (``CostModel.upload_dense_values``).

All byte arithmetic happens on the host in float64, as in the JAX package:
round byte counts exceed float32's exact-integer range at ≥1e9 params.
The ported ledger is the synchronous star subset (no peer or staleness
buckets, no telemetry hooks).
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
    """Accumulates upload/download bytes across rounds (host-side)."""

    def __init__(self, cost_model: CostModel | None = None):
        self.cost = cost_model or CostModel()
        self.upload_bytes = 0.0
        self.download_bytes = 0.0
        self.rounds = 0

    def record_round(self, upload_nnz_per_client, download_nnz, total, num_clients,
                     value_bytes=None):
        up, down = self.cost.round_bytes(
            np.asarray(upload_nnz_per_client, np.float64), download_nnz, total,
            num_clients, value_bytes)
        self.upload_bytes += float(up)
        self.download_bytes += float(down)
        self.rounds += 1

    @property
    def total_bytes(self) -> float:
        return self.upload_bytes + self.download_bytes

    @property
    def total_gb(self) -> float:
        return self.total_bytes / 1e9

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "upload_gb": self.upload_bytes / 1e9,
            "download_gb": self.download_bytes / 1e9,
            "total_gb": self.total_gb,
        }


def dense_round_gb(total_params: int, num_clients: int, value_bytes: int = 4) -> float:
    """Analytic cost of one uncompressed round (a sanity bound for tests)."""
    up = num_clients * total_params * value_bytes
    down = num_clients * total_params * value_bytes
    return (up + down) / 1e9
