"""Gradient-compression scheme API (paper Table 2): ``CompressionConfig``
and the functional delegations to the resolved ``Scheme``.

``CompressionConfig`` keeps every field name and default of the JAX
package's, so one config reads the same in both packages.

  init_states(cfg, params)                  -> (ClientState, ServerState)
  client_compress(cfg, state, grad, gbar_prev, round_idx, ..., layout=...)
      -> (payload, new_state, CompressInfo)     # flat [k, N] client stacks
  server_aggregate(cfg, server_state, g_sum, num_clients, layout=..., lr=...)
      -> (broadcast, new_server_state, AggregateInfo)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import registry as _registry
from repro_torch.core.registry import resolve
from repro_torch.core.stages import AggregateInfo, CompressInfo, get_stage
from repro_torch.core.state import ClientState, ServerState

SCHEMES = _registry.available_presets()


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Hyper-parameters for a compression scheme (paper §3/§4 defaults)."""

    scheme: str = "dgcwgmf"
    rate: float = 0.1              # compression rate r: fraction of entries kept
    alpha: float = 0.9             # local momentum factor (momentum correction)
    beta: float = 0.9              # client global momentum factor (M update)
    tau: float = 0.3               # fusion ratio (max value if warmup > 0)
    tau_warmup_rounds: int = 0     # >0: staircase 0 -> tau in 10 steps (paper §4.1)
    beta_server: float = 0.9       # server momentum factor (dgcwgm)
    mu: float = 0.9                # GMC global momentum coefficient
    selector: str = "exact"        # topk threshold estimator: exact | sampled
    per_tensor: bool = True        # per-tensor masks (DGC practice) vs global topk
    eps: float = 1e-16
    fusion_weighting: str = "none"  # none | fednova
    use_kernels: bool = False      # take the fused GMF kernel path
    wire_dtype: str = "float32"    # dtype of the transmitted masked values

    # Per-config stage overrides on top of the preset (None = preset stage).
    selector_stage: str | None = None
    compensator_stage: str | None = None
    fusion_stage: str | None = None
    wire_stage: str | None = None
    rotation_stage: str | None = None
    downlink_stage: str | None = None
    staleness_stage: str | None = None
    rate_control_stage: str | None = None

    # Aggregator-tier re-compression (topology=hierarchical): the preset the
    # edge aggregators re-compress their group sums with (None = the leaf
    # preset's SchemeSpec.tier slot) and its rate.
    tier_scheme: str | None = None
    tier_rate: float = 0.1

    # Downlink compression rate (downlink=topk).
    downlink_rate: float = 0.1

    # Staleness weighting (the async buffered engine).
    staleness_exponent: float = 0.5
    staleness_tau: float = 0.3
    staleness_horizon: int = 32

    # Adaptive per-client rate control (rate_control=adaptive).
    rate_min: float = 0.01
    rate_max: float = 1.0
    rate_gain: float = 0.5
    rate_ema: float = 0.9
    rate_wire_threshold: float = 0.0
    rate_staleness_gamma: float = 0.5

    # Seeds of the keyed stages (hadamard rotation, probquant wire).
    rotation_seed: int = 23
    probquant_seed: int = 29

    # FetchSGD (sketch selector).
    sketch_rows: int = 5
    sketch_cols: int = 10_000
    sketch_k_frac: float = 0.01
    sketch_momentum: float = 0.9

    WIRE_DTYPES = ("float32", "float16", "bfloat16", "int8", "probquant")

    def __post_init__(self):
        _registry.check_preset(self.scheme)
        if self.selector not in ("exact", "sampled"):
            raise ValueError(f"unknown selector {self.selector!r}")
        if not 0.0 <= self.tau <= 1.0:
            raise ValueError(f"tau must be in [0,1], got {self.tau}")
        if self.fusion_weighting not in ("none", "fednova"):
            raise ValueError(f"unknown fusion_weighting {self.fusion_weighting!r}")
        if self.wire_dtype not in self.WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; choose from {self.WIRE_DTYPES}")
        get_stage("wire", self.wire_dtype)
        for kind in ("selector", "compensator", "fusion", "wire", "rotation",
                     "downlink", "staleness", "rate_control"):
            name = getattr(self, f"{kind}_stage")
            if name is not None:
                get_stage(kind, name)  # raises with the registered names
        if self.tier_scheme is not None and self.tier_scheme not in _registry.PRESETS:
            raise ValueError(f"unknown tier_scheme {self.tier_scheme!r}; registered presets: "
                             f"{_registry.available_presets()}")
        if not 0.0 < self.tier_rate <= 1.0:
            raise ValueError(f"tier_rate must be in (0, 1], got {self.tier_rate}")
        if not 0.0 < self.downlink_rate <= 1.0:
            raise ValueError(f"downlink_rate must be in (0, 1], got {self.downlink_rate}")
        if not 0.0 < self.rate_min <= self.rate_max <= 1.0:
            raise ValueError(
                f"rate clamp must satisfy 0 < rate_min <= rate_max <= 1, "
                f"got [{self.rate_min}, {self.rate_max}]")
        if self.rate_gain < 0.0:
            raise ValueError(f"rate_gain must be >= 0, got {self.rate_gain}")
        if not 0.0 <= self.rate_ema < 1.0:
            raise ValueError(f"rate_ema must be in [0, 1), got {self.rate_ema}")
        if self.rate_wire_threshold < 0.0:
            raise ValueError(
                f"rate_wire_threshold must be >= 0, got {self.rate_wire_threshold}")


def init_states(cfg: CompressionConfig, params) -> tuple[ClientState, ServerState]:
    return resolve(cfg).init_states(params)


def client_compress(cfg: CompressionConfig, state: ClientState, grad, gbar_prev, round_idx,
                    local_steps=1.0, mean_steps=1.0, tau_override=None, rates=None,
                    wire_levels=None, client_ids=None, *, layout):
    """One client-side compression step for a flat ``[k, N]`` stack of
    clients of the params ``layout`` describes."""
    return resolve(cfg).client_compress(
        state, grad, gbar_prev, round_idx, local_steps=local_steps,
        mean_steps=mean_steps, tau_override=tau_override, rates=rates,
        wire_levels=wire_levels, client_ids=client_ids, layout=layout)


def server_aggregate(cfg: CompressionConfig, server_state: ServerState, g_sum, num_clients, *,
                     layout=None, lr=None):
    """Server step: average, fusion-stage server transform, downlink (a
    sketch scheme needs ``layout`` and ``lr``)."""
    return resolve(cfg).server_aggregate(server_state, g_sum, num_clients, layout=layout,
                                         lr=lr)


__all__ = [
    "SCHEMES",
    "AggregateInfo",
    "CompressInfo",
    "CompressionConfig",
    "client_compress",
    "init_states",
    "resolve",
    "server_aggregate",
]
