"""Exporters: Prometheus textfile + JSON summary from a Registry.

Two write-at-end formats (this is a simulator/trainer, not a daemon —
the textfile-collector convention fits: write the file, let node
exporter or the CI job pick it up):

* ``prometheus_text(registry)`` — the Prometheus exposition format.
  Counters/gauges map directly; histograms export ``_count`` / ``_sum``
  plus ``{quantile=...}`` sample lines (summary-style). Gauges also
  export a ``_peak`` series from their high-water marks.
* ``json_summary(registry)`` — the same snapshot as nested JSON (the
  launchers embed it in their final summary and write it to
  ``<obs-dir>/summary.json``).

``write_all(out_dir)`` drops both files for the current recorder.
"""

from __future__ import annotations

import json
import os
import re

from repro_torch.obs import metrics as _metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    # the reference's prefix, so both packages' textfiles carry one family
    return "repro_" + _NAME_RE.sub("_", name)


def _prom_labels(key: tuple, extra: dict | None = None) -> str:
    pairs = list(key) + sorted((extra or {}).items())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


def prometheus_text(registry: "_metrics.Registry") -> str:
    lines = []
    for name, snap in registry.snapshot().items():
        pname = _prom_name(name)
        kind = snap["kind"]
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            for key, value in snap["series"].items():
                lines.append(f"{pname}{_prom_labels(key)} {value:.17g}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            for key, value in snap["series"].items():
                lines.append(f"{pname}{_prom_labels(key)} {value:.17g}")
            lines.append(f"# TYPE {pname}_peak gauge")
            for key, value in snap["high_water"].items():
                lines.append(f"{pname}_peak{_prom_labels(key)} {value:.17g}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for key, cell in snap["series"].items():
                for q, field in (("0.5", "p50"), ("0.9", "p90"),
                                 ("0.99", "p99")):
                    lines.append(
                        f"{pname}{_prom_labels(key, {'quantile': q})} "
                        f"{cell[field]:.17g}")
                lines.append(f"{pname}_sum{_prom_labels(key)} {cell['sum']:.17g}")
                lines.append(f"{pname}_count{_prom_labels(key)} {cell['count']}")
    return "\n".join(lines) + "\n"


def json_summary(registry: "_metrics.Registry") -> dict:
    """Registry snapshot with JSON-friendly label encoding."""
    out = {}
    for name, snap in registry.snapshot().items():
        entry = {"kind": snap["kind"], "series": []}
        for key, value in snap["series"].items():
            row = {"labels": dict(key)}
            if snap["kind"] == "histogram":
                row.update(value)
            else:
                row["value"] = value
            if snap["kind"] == "gauge":
                row["peak"] = snap["high_water"].get(key, value)
            entry["series"].append(row)
        out[name] = entry
    return out


def write_all(out_dir: str, registry: "_metrics.Registry | None" = None) -> dict:
    """Write ``metrics.prom`` + ``summary.json`` for the given registry
    (default: the active recorder's). Returns {format: path}; no-op
    (empty dict) when telemetry is disabled and no registry is given."""
    if registry is None:
        rec = _metrics.get()
        if not rec.enabled:
            return {}
        registry = rec.registry
    os.makedirs(out_dir, exist_ok=True)
    prom_path = os.path.join(out_dir, "metrics.prom")
    with open(prom_path, "w", encoding="utf-8") as fh:
        fh.write(prometheus_text(registry))
    json_path = os.path.join(out_dir, "summary.json")
    with open(json_path, "w", encoding="utf-8") as fh:
        json.dump(json_summary(registry), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return {"prometheus": prom_path, "json": json_path}
