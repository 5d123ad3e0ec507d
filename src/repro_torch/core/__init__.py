"""Core: the paper's gradient compression schemes with Global Momentum
Fusion, composed from registry-registered stages, plus accounting."""

from repro_torch.core.rate_control import (
    AdaptiveRateController,
    FixedRateController,
    RateController,
    RateControlState,
)
from repro_torch.core.schemes import (
    SCHEMES,
    AggregateInfo,
    CompressInfo,
    CompressionConfig,
    client_compress,
    init_states,
    resolve,
    server_aggregate,
)
from repro_torch.core.registry import (
    PRESETS,
    Scheme,
    SchemeSpec,
    available_presets,
    register_preset,
    resolve_tier,
)
from repro_torch.core.state import (
    ClientState,
    ServerState,
    gather_client_states,
    group_sum,
    interleave_position_stacks,
    scatter_client_states,
    stack_client_states,
)
from repro_torch.core.accounting import CommLedger, CostModel

__all__ = [
    "SCHEMES",
    "AggregateInfo",
    "CompressInfo",
    "CompressionConfig",
    "client_compress",
    "init_states",
    "resolve",
    "server_aggregate",
    "PRESETS",
    "Scheme",
    "SchemeSpec",
    "available_presets",
    "register_preset",
    "resolve_tier",
    "ClientState",
    "ServerState",
    "stack_client_states",
    "gather_client_states",
    "scatter_client_states",
    "group_sum",
    "interleave_position_stacks",
    "CommLedger",
    "CostModel",
    "AdaptiveRateController",
    "FixedRateController",
    "RateControlState",
    "RateController",
]
