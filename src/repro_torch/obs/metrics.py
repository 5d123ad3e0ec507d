"""Process-local metrics registry: counters / gauges / histograms.

The spine of ``repro_torch.obs``, a copy of the JAX package's module:
every subsystem (FL round engines, the ``CommLedger``, the serving
launcher) records into one process-local :class:`Registry` through the
module-level *recorder*.
Design constraints, in order:

* **Zero cost when disabled.** ``get()`` returns the shared
  :data:`NOOP` recorder until ``configure()`` is called — every method
  is a plain ``pass``, no locks, no string formatting, no file handles.
  Instrument points therefore never need an ``if obs_enabled`` guard of
  their own; they call ``get().counter_add(...)`` unconditionally.
* **Host-side only.** Recording happens on python scalars and numpy
  values already read from the device — nothing here reads a tensor, so
  nothing here synchronises with the card. (Profiler and NVTX ranges for
  the round's phases live in ``obs/trace.py``.)
* **Labeled series.** Every metric name holds a family of series keyed
  by a (sorted) label tuple, Prometheus-style:
  ``registry.counter("comm.upload_bytes").inc(512, wire="float16")``.

``Registry.snapshot()`` freezes everything into plain dicts for the
exporters (``obs/export.py``).
"""

from __future__ import annotations

import math
from typing import ClassVar


def _label_key(labels: dict) -> tuple:
    """Canonical hashable key for a label set (sorted item tuple)."""
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class Counter:
    """Monotone accumulator per label set."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {"kind": self.kind,
                "series": {k: v for k, v in self._series.items()}}


class Gauge:
    """Last-value metric per label set; tracks the high-water mark.

    The high-water mark is what turns a gauge into the single source of
    truth for "peak" quantities (peak active serve slots, allocator peak
    pages) — callers just ``set()`` the current value and read
    ``high_water()`` at the end instead of keeping their own ad-hoc
    ``peak = max(peak, x)`` bookkeeping.
    """

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}
        self._hwm: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        self._series[key] = v
        if v > self._hwm.get(key, -math.inf):
            self._hwm[key] = v

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def high_water(self, **labels) -> float:
        return self._hwm.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {"kind": self.kind,
                "series": {k: v for k, v in self._series.items()},
                "high_water": {k: v for k, v in self._hwm.items()}}


class Histogram:
    """Streaming distribution per label set.

    Keeps exact count/sum/min/max plus a bounded reservoir of recent
    values for percentile estimates — per-round wall-clock and staleness
    series are thousands of points at most, so the reservoir is simply
    "all of them" until ``max_samples``, then a cyclic overwrite (the
    summary stays exact, the percentiles become recent-window).
    """

    kind = "histogram"

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self.max_samples = max_samples
        self._series: dict[tuple, dict] = {}

    def _cell(self, key: tuple) -> dict:
        cell = self._series.get(key)
        if cell is None:
            cell = {"count": 0, "sum": 0.0, "min": math.inf,
                    "max": -math.inf, "samples": []}
            self._series[key] = cell
        return cell

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        cell = self._cell(_label_key(labels))
        cell["count"] += 1
        cell["sum"] += v
        if v < cell["min"]:
            cell["min"] = v
        if v > cell["max"]:
            cell["max"] = v
        samples = cell["samples"]
        if len(samples) < self.max_samples:
            samples.append(v)
        else:
            samples[cell["count"] % self.max_samples] = v

    def percentile(self, q: float, **labels) -> float:
        """q in [0, 100] over the retained sample window (0.0 if empty)."""
        cell = self._series.get(_label_key(labels))
        if not cell or not cell["samples"]:
            return 0.0
        s = sorted(cell["samples"])
        idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
        return s[idx]

    def summary(self, **labels) -> dict:
        cell = self._series.get(_label_key(labels))
        if not cell or cell["count"] == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": cell["count"], "sum": cell["sum"],
                "mean": cell["sum"] / cell["count"],
                "min": cell["min"], "max": cell["max"],
                "p50": self.percentile(50, **dict(_label_key(labels))),
                "p90": self.percentile(90, **dict(_label_key(labels))),
                "p99": self.percentile(99, **dict(_label_key(labels)))}

    def snapshot(self) -> dict:
        out = {}
        for key, cell in self._series.items():
            out[key] = {"count": cell["count"], "sum": cell["sum"],
                        "mean": cell["sum"] / max(cell["count"], 1),
                        "min": cell["min"] if cell["count"] else 0.0,
                        "max": cell["max"] if cell["count"] else 0.0,
                        "p50": self.percentile(50, **dict(key)),
                        "p90": self.percentile(90, **dict(key)),
                        "p99": self.percentile(99, **dict(key))}
        return {"kind": self.kind, "series": out}


class Registry:
    """Name → metric map. Creating is idempotent; kinds must not clash."""

    _CLASSES: ClassVar[dict] = {
        "counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, kind: str, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._CLASSES[kind](name)
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._metrics))

    def snapshot(self) -> dict:
        """Plain-dict freeze of every metric (exporter input)."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


# ---------------------------------------------------------------------------
# Recorders: the facade instrument points talk to.
# ---------------------------------------------------------------------------


class NoopRecorder:
    """The disabled recorder: every operation is a no-op.

    This object (one shared instance, :data:`NOOP`) is the whole
    "zero-cost when disabled" story — hot paths hold no conditional
    logic, they call these empty methods. ``tests/test_torch_obs.py`` asserts
    a run through it emits no events and perturbs nothing.
    """

    enabled = False

    def counter_add(self, name, value=1.0, **labels):
        pass

    def gauge_set(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def event(self, kind, **data):
        pass

    def flush(self):
        pass


class Recorder(NoopRecorder):
    """Active recorder: a :class:`Registry` plus an optional event sink
    (``obs/events.py`` JSONL log). Created by ``configure()``."""

    enabled = True

    def __init__(self, registry: Registry | None = None, event_log=None):
        self.registry = registry if registry is not None else Registry()
        self.event_log = event_log

    def counter_add(self, name, value=1.0, **labels):
        self.registry.counter(name).inc(value, **labels)

    def gauge_set(self, name, value, **labels):
        self.registry.gauge(name).set(value, **labels)

    def observe(self, name, value, **labels):
        self.registry.histogram(name).observe(value, **labels)

    def event(self, kind, **data):
        if self.event_log is not None:
            self.event_log.emit(kind, **data)

    def flush(self):
        if self.event_log is not None:
            self.event_log.flush()


NOOP = NoopRecorder()
_recorder: NoopRecorder = NOOP


def get() -> NoopRecorder:
    """The process-wide recorder (the shared NOOP until configured)."""
    return _recorder


def enabled() -> bool:
    return _recorder.enabled


def configure(out_dir: str | None = None, *, registry: Registry | None = None
              ) -> Recorder:
    """Turn telemetry on for this process.

    ``out_dir`` (optional) attaches a versioned JSONL event sink at
    ``<out_dir>/events.jsonl``; without it, metrics accumulate in-memory
    only. Returns the active recorder (also reachable via ``get()``).
    """
    global _recorder
    event_log = None
    if out_dir is not None:
        from repro_torch.obs.events import EventLog

        event_log = EventLog(out_dir)
    _recorder = Recorder(registry=registry, event_log=event_log)
    return _recorder


def shutdown() -> None:
    """Flush + close any event sink and drop back to the NOOP recorder."""
    global _recorder
    rec = _recorder
    _recorder = NOOP
    if getattr(rec, "event_log", None) is not None:
        rec.event_log.close()
