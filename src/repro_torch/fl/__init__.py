from repro_torch.fl.engine import BACKENDS, TOPOLOGIES, RoundEngine, VmapEngine, make_engine
from repro_torch.fl.simulator import FLConfig, FLSimulator
from repro_torch.fl.tasks import CifarTask, ShakespeareTask

__all__ = [
    "BACKENDS",
    "TOPOLOGIES",
    "RoundEngine",
    "VmapEngine",
    "make_engine",
    "FLConfig",
    "FLSimulator",
    "CifarTask",
    "ShakespeareTask",
]
