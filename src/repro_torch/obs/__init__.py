"""``repro_torch.obs`` — telemetry: metrics, tracing, events, health.

The JAX package's ``repro.obs``, module for module, on the port's flat
state:

* ``obs.metrics`` — process-local registry of counters / gauges /
  histograms with labeled series; a shared **no-op recorder** until
  ``obs.configure()`` turns it on, so instrument points cost nothing in
  the default (disabled) state.
* ``obs.trace`` — nestable host-side spans (``with span("round")``)
  that land in the ``trace.span_ms`` histogram and run inside
  ``torch.profiler.record_function`` (plus an NVTX range on a card);
  ``annotate_scope`` names the round's phases in profiles.
* ``obs.events`` / ``obs.export`` — versioned JSONL event sink plus
  Prometheus-textfile and JSON-summary exporters; a file either package
  writes validates under the other's reader.
* ``obs.health`` — compensation-state monitors computed from the flat
  state: EF residual mass, global-momentum norms, achieved vs target
  compression, broadcast NaN/Inf anomalies, staleness percentiles.
* ``python -m repro_torch.obs.report <events.jsonl>`` — run-report renderer.

Typical launcher wiring (what ``--obs`` does)::

    import repro_torch.obs as obs
    obs.configure("runs/exp1")            # events -> runs/exp1/events.jsonl
    ...                                   # instrumented code records
    obs.export.write_all("runs/exp1")     # metrics.prom + summary.json
    obs.shutdown()
"""

from repro_torch.obs import events, export, health, metrics, trace
from repro_torch.obs.metrics import (
    NOOP,
    Recorder,
    Registry,
    configure,
    enabled,
    get,
    shutdown,
)
from repro_torch.obs.trace import annotate_scope, span

__all__ = [
    "NOOP",
    "Recorder",
    "Registry",
    "annotate_scope",
    "configure",
    "enabled",
    "events",
    "export",
    "get",
    "health",
    "metrics",
    "shutdown",
    "span",
    "trace",
]
