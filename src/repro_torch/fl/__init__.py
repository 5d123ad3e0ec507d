from repro_torch.fl.availability import DELAY_MODELS, Availability
from repro_torch.fl.engine import (
    BACKENDS,
    AsyncBufferedEngine,
    RoundEngine,
    ShardMapEngine,
    TopologyEngine,
    VmapEngine,
    make_engine,
)
from repro_torch.fl.simulator import FLConfig, FLSimulator
from repro_torch.fl.tasks import CifarTask, LMTask, ShakespeareTask
from repro_torch.topo import TOPOLOGIES

__all__ = [
    "BACKENDS",
    "DELAY_MODELS",
    "TOPOLOGIES",
    "Availability",
    "RoundEngine",
    "VmapEngine",
    "ShardMapEngine",
    "AsyncBufferedEngine",
    "TopologyEngine",
    "make_engine",
    "FLConfig",
    "FLSimulator",
    "CifarTask",
    "LMTask",
    "ShakespeareTask",
]
