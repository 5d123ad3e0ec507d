"""Versioned JSONL event sink + schema validation.

One event per line::

    {"v": 1, "ts": 1723190400.123, "kind": "round", "data": {...}}

* ``v`` — schema version (:data:`SCHEMA_VERSION`). Readers reject
  events from a future major version instead of mis-parsing them.
* ``ts`` — host wall-clock (``time.time()``), seconds.
* ``kind`` — event type; the known kinds and their required ``data``
  fields live in :data:`KINDS`. Unknown kinds are allowed (forward
  compatibility for user-registered instrument points) but known kinds
  must carry their required fields — ``validate_event`` enforces both.
* ``data`` — flat JSON object of the event's payload.

``EventLog`` is the writer (line-buffered append, one file per run at
``<out_dir>/events.jsonl``); ``read_events`` / ``validate_file`` are the
readers the report CLI and the CI schema gate share.
"""

from __future__ import annotations

import json
import os
import time

SCHEMA_VERSION = 1

# kind -> required data fields. Extra fields are always allowed.
KINDS: dict[str, tuple[str, ...]] = {
    "run_start": ("run", "argv"),
    "round": ("round", "wall_ms", "upload_bytes", "download_bytes"),
    "flush": ("round", "staleness_gaps"),
    # non-star topology rounds (repro_torch.topo): the per-link split the
    # plain "round" event cannot express — what reached the server vs
    # what moved client→client, and whether the broadcast synced
    "topo_round": ("round", "topology", "server_ingress_bytes",
                   "peer_bytes"),
    "health": ("round",),
    "anomaly": ("round", "what"),
    "serve_request": ("rid", "wait_ticks", "latency_s"),
    "serve_summary": ("requests", "tokens_per_s"),
    "summary": (),
}


def make_event(kind: str, **data) -> dict:
    return {"v": SCHEMA_VERSION, "ts": time.time(), "kind": kind,
            "data": data}


def validate_event(ev: dict) -> list[str]:
    """Schema errors for one decoded event (empty list = valid)."""
    errors = []
    if not isinstance(ev, dict):
        return ["event is not an object"]
    v = ev.get("v")
    if not isinstance(v, int):
        errors.append("missing/invalid schema version 'v'")
    elif v > SCHEMA_VERSION:
        errors.append(f"event schema v{v} is newer than reader "
                      f"v{SCHEMA_VERSION}")
    if not isinstance(ev.get("ts"), (int, float)):
        errors.append("missing/invalid timestamp 'ts'")
    kind = ev.get("kind")
    if not isinstance(kind, str) or not kind:
        errors.append("missing/invalid 'kind'")
        return errors
    data = ev.get("data")
    if not isinstance(data, dict):
        errors.append("missing/invalid 'data' object")
        return errors
    for field in KINDS.get(kind, ()):
        if field not in data:
            errors.append(f"kind {kind!r} missing required field {field!r}")
    return errors


class EventLog:
    """Append-only JSONL writer for one run's events."""

    def __init__(self, out_dir: str, filename: str = "events.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._fh = open(self.path, "w", encoding="utf-8")
        self.emitted = 0

    def emit(self, kind: str, **data) -> None:
        ev = make_event(kind, **data)
        self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
        self.emitted += 1

    def flush(self) -> None:
        if not self._fh.closed:
            self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def read_events(path: str) -> list[dict]:
    """Decode every event line; raises ValueError on malformed JSON."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: malformed JSON: {e}") from None
    return events


def validate_file(path: str) -> list[str]:
    """All schema errors in one JSONL file (empty list = valid)."""
    errors = []
    try:
        events = read_events(path)
    except ValueError as e:
        return [str(e)]
    for i, ev in enumerate(events):
        for err in validate_event(ev):
            errors.append(f"{path}: event {i}: {err}")
    return errors
