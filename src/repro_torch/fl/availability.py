"""Client availability models (the JAX package's ``fl/availability.py``),
numpy only: per dispatched payload of the async buffered engine a delay
(server ticks in flight) and a dropout (the payload never arrives: the
client went offline after its local work), and the per-client bandwidth
budget the adaptive rate controller scales rates by.

The delay models (``FLConfig.delay_model``; means are in server ticks):
``none`` (every payload on time), ``uniform`` on [0, 2·delay_mean],
``geometric`` with mean ``delay_mean`` and ``lognormal`` (heavy-tailed,
pre-floor mean ``delay_mean``); ``delay_max > 0`` clips every draw, and
``dropout_rate`` drops each payload independently. A client whose link
delays payloads by ``d`` ticks gets budget ``1/(1+d)``. Under ``none``
every budget is exactly 1.0 and nothing is drawn, so the rate
controller's flat-signal fixed point stays bitwise and the sampling
streams are untouched. The draws are the reference's, call for call, so
the async schedule (arrivals, drops, flushes) is the reference's too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

DELAY_MODELS = ("none", "uniform", "geometric", "lognormal")


@dataclasses.dataclass(frozen=True)
class Availability:
    """Bound delay and dropout sampler, and the bandwidth budget derived
    from the delays."""

    model: str = "none"
    mean: float = 0.0
    max_delay: int = 0      # 0 = uncapped
    dropout: float = 0.0

    def __post_init__(self):
        if self.model not in DELAY_MODELS:
            raise ValueError(
                f"unknown delay model {self.model!r}; choose from {DELAY_MODELS}")
        if self.mean < 0.0:
            raise ValueError(f"delay_mean must be >= 0, got {self.mean}")
        if self.max_delay < 0:
            raise ValueError(f"delay_max must be >= 0, got {self.max_delay}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout}")

    def sample_delays(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """Per-payload in-flight delay in whole server ticks, shape [k]."""
        if self.model == "none" or self.mean == 0.0:
            d = np.zeros(k, dtype=np.int64)
        elif self.model == "uniform":
            hi = int(round(2.0 * self.mean))
            d = rng.integers(0, hi + 1, size=k)
        elif self.model == "geometric":
            # geometric(p) on {1, 2, ...} shifted to {0, 1, ...}: mean (1-p)/p
            d = rng.geometric(1.0 / (1.0 + self.mean), size=k) - 1
        else:  # lognormal, s = 1 and mu so that the pre-floor mean is delay_mean
            mu = math.log(self.mean) - 0.5
            d = np.floor(rng.lognormal(mean=mu, sigma=1.0, size=k)).astype(np.int64)
        if self.max_delay > 0:
            d = np.minimum(d, self.max_delay)
        return d.astype(np.int64)

    def sample_dropout(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """Boolean [k]: True = this payload never arrives."""
        if self.dropout == 0.0:
            return np.zeros(k, dtype=bool)
        return rng.random(k) < self.dropout

    def sample_bandwidth(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """Per-client bandwidth budget in (0, 1], shape [k] float64."""
        if self.model == "none" or self.mean == 0.0:
            return np.ones(k, dtype=np.float64)
        return 1.0 / (1.0 + self.sample_delays(rng, k).astype(np.float64))


def from_fl_config(fl_cfg) -> Availability:
    """Bind the availability model declared in an ``FLConfig``."""
    return Availability(
        model=getattr(fl_cfg, "delay_model", "none"),
        mean=getattr(fl_cfg, "delay_mean", 0.0),
        max_delay=getattr(fl_cfg, "delay_max", 0),
        dropout=getattr(fl_cfg, "dropout_rate", 0.0),
    )
