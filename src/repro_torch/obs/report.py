"""Run-report renderer for obs JSONL event logs.

    PYTHONPATH=src python -m repro_torch.obs.report <events.jsonl> [--strict]

Renders, from any run's event log: the run header, a per-round table
(wall-clock, loss, bytes), communication totals, the compensation-state
health trajectories (EF residual mass, momentum norms, achieved vs
target compression), and the staleness histogram for async runs.

``--strict`` (the CI gate) exits non-zero on schema errors or
missing-series warnings — a run that claims to be instrumented must
actually have produced every series its backend implies.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs import events as _events


def _fmt_bytes(b: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(b) >= div:
            return f"{b / div:.2f} {unit}"
    return f"{b:.0f} B"


def _table(headers: list[str], rows: list[list[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:>{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*row) for row in rows]
    return "\n".join(lines)


def _sample_rows(items: list, max_rows: int = 24) -> list:
    """First/last-heavy sample of a long list (keeps the trajectory's
    ends, thins the middle)."""
    if len(items) <= max_rows:
        return items
    head = items[: max_rows // 2]
    tail = items[-(max_rows - len(head) - 1):]
    return [*head, None, *tail]  # None renders as an ellipsis row


def analyze(events: list[dict]) -> tuple[str, list[str]]:
    """(rendered report, warnings). Schema errors are NOT checked here —
    run ``events.validate_file`` first (main() does)."""
    warnings: list[str] = []
    by_kind: dict[str, list[dict]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev.get("data", {}))

    out: list[str] = []

    # -- header -------------------------------------------------------------
    start = (by_kind.get("run_start") or [{}])[0]
    run = start.get("run", "unknown")
    out.append(f"== obs report: {run} run ==")
    if start.get("argv"):
        out.append(f"argv: {' '.join(start['argv'])}")
    for k in sorted(start):
        if k not in ("run", "argv"):
            out.append(f"{k}: {start[k]}")
    if not by_kind.get("run_start"):
        warnings.append("missing series: no run_start event")

    # Serve runs have no rounds/health/summary by construction — the
    # request/pool series stand in for them (no false "missing" warnings).
    is_serve = start.get("backend") == "serve"

    # -- round table --------------------------------------------------------
    rounds = by_kind.get("round", [])
    if not rounds:
        if not is_serve:
            warnings.append("missing series: no round events")
    else:
        has_loss = any("loss" in r for r in rounds)
        has_acc = any("accuracy" in r for r in rounds)
        has_flush = any(r.get("applies") is not None for r in rounds)
        headers = ["round", "wall_ms", "up", "down"]
        headers += ["loss"] if has_loss else []
        headers += ["acc"] if has_acc else []
        headers += ["applies", "pending"] if has_flush else []
        table_rows = []
        for r in _sample_rows(rounds):
            if r is None:
                table_rows.append(["..."] * len(headers))
                continue
            row = [str(r.get("round", "?")), f"{r.get('wall_ms', 0.0):.1f}",
                   _fmt_bytes(r.get("upload_bytes", 0.0)),
                   _fmt_bytes(r.get("download_bytes", 0.0))]
            if has_loss:
                row.append(f"{r['loss']:.4f}" if "loss" in r else "-")
            if has_acc:
                row.append(f"{r['accuracy']:.4f}" if "accuracy" in r else "-")
            if has_flush:
                row.append(str(r.get("applies", "-")))
                row.append(str(r.get("pending", "-")))
            table_rows.append(row)
        out.append("")
        out.append(_table(headers, table_rows))

        # -- totals ---------------------------------------------------------
        up = sum(r.get("upload_bytes", 0.0) for r in rounds)
        down = sum(r.get("download_bytes", 0.0) for r in rounds)
        walls = [r.get("wall_ms", 0.0) for r in rounds]
        out.append("")
        out.append(f"rounds: {len(rounds)}   upload: {_fmt_bytes(up)}   "
                   f"download: {_fmt_bytes(down)}   total: {_fmt_bytes(up + down)}")
        steady = walls[1:] if len(walls) > 1 else walls
        out.append(f"round wall-clock: first {walls[0]:.1f} ms (includes "
                   f"compile), steady mean {sum(steady) / len(steady):.1f} ms, "
                   f"max {max(steady):.1f} ms")

    # -- health trajectories ------------------------------------------------
    health = by_kind.get("health", [])
    if not health:
        if not is_serve:
            warnings.append("missing series: no health events "
                            "(compensation-state monitors)")
    else:
        series = ["residual_u_norm", "residual_v_norm", "momentum_m_norm",
                  "server_momentum_norm", "global_momentum_norm",
                  "broadcast_norm", "compression_achieved_rate"]
        present = [s for s in series if any(s in h for h in health)]
        headers = ["round", *(s.replace("_norm", "").replace("compression_", "")
                              for s in present)]
        rows = []
        for h in _sample_rows(health):
            if h is None:
                rows.append(["..."] * len(headers))
                continue
            rows.append([str(h.get("round", "?")),
                         *(f"{h[s]:.4g}" if s in h else "-" for s in present)])
        out.append("")
        out.append("compensation-state health (residual/momentum trajectories):")
        out.append(_table(headers, rows))
        target = next((h["compression_target_rate"] for h in health
                       if "compression_target_rate" in h), None)
        if target is not None:
            last = next((h["compression_achieved_rate"]
                         for h in reversed(health)
                         if "compression_achieved_rate" in h), 0.0)
            out.append(f"compression: achieved {last:.4f} vs target "
                       f"{target:.4f} (ratio {last / target if target else 0:.2f})")
        bad = by_kind.get("anomaly", [])
        if bad:
            out.append(f"!! {len(bad)} anomaly event(s): " +
                       "; ".join(f"round {a.get('round')}: {a.get('what')}"
                                 for a in bad[:5]))

    # -- staleness histogram (async runs) ------------------------------------
    gaps: dict[int, int] = {}
    for f in by_kind.get("flush", []):
        for g in f.get("staleness_gaps", []):
            gaps[int(g)] = gaps.get(int(g), 0) + 1
    is_async = start.get("backend") == "async"
    if gaps:
        out.append("")
        out.append("staleness histogram (gap ticks -> payloads):")
        peak = max(gaps.values())
        for g in sorted(gaps):
            bar = "#" * max(1, int(40 * gaps[g] / peak))
            out.append(f"  {g:>4d}  {gaps[g]:>6d}  {bar}")
        total = sum(gaps.values())
        mean = sum(g * c for g, c in gaps.items()) / total
        out.append(f"  payloads: {total}  mean gap: {mean:.2f}  "
                   f"max: {max(gaps)}")
    elif is_async:
        warnings.append("missing series: async run without flush/staleness "
                        "events")

    # -- final summary -------------------------------------------------------
    summaries = by_kind.get("summary", [])
    serve = by_kind.get("serve_summary", [])
    if summaries:
        out.append("")
        out.append("final summary:")
        for k, v in sorted(summaries[-1].items()):
            if isinstance(v, float):
                out.append(f"  {k}: {v:.6g}")
            elif not isinstance(v, (dict, list)):
                out.append(f"  {k}: {v}")
    elif not (is_serve and serve):
        warnings.append("missing series: no summary event")

    if serve:
        s = serve[-1]
        reqs = by_kind.get("serve_request", [])
        out.append("")
        out.append(f"serve: {s.get('requests')} requests, "
                   f"{s.get('tokens_per_s', 0.0):.1f} tok/s, "
                   f"peak {s.get('peak_active_slots', '-')} slots, "
                   f"pool peak {s.get('peak_pages', '-')} pages "
                   f"({s.get('page_pool_occupancy', 0.0):.0%} of pool)")
        if reqs:
            waits = sorted(r.get("wait_ticks", 0) for r in reqs)
            lats = sorted(r.get("latency_s", 0.0) for r in reqs)
            out.append(f"  admission wait: p50 {waits[len(waits) // 2]} "
                       f"ticks, max {waits[-1]} ticks; latency p50 "
                       f"{lats[len(lats) // 2] * 1e3:.1f} ms")
    elif is_serve:
        warnings.append("missing series: serve run without serve_summary")

    return "\n".join(out), warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a run report from an obs events.jsonl")
    ap.add_argument("events", help="path to the JSONL event log")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on schema errors or missing-series "
                         "warnings (the CI gate)")
    args = ap.parse_args(argv)

    schema_errors = _events.validate_file(args.events)
    for err in schema_errors:
        print(f"SCHEMA ERROR: {err}", file=sys.stderr)
    if schema_errors:
        return 1

    events = _events.read_events(args.events)
    report, warnings = analyze(events)
    print(report)
    for w in warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    return 1 if (warnings and args.strict) else 0


if __name__ == "__main__":
    raise SystemExit(main())
