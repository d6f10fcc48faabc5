"""Schema validation for exported traces and metrics dumps (CI gate).

``python -m repro_torch.obs.validate TRACE.json [METRICS.json]`` exits
non-zero with a reason when a file does not meet the contract:

* **Trace** — a Chrome trace-event object (``traceEvents`` list,
  loadable by Perfetto); every event carries ``name``/``ph``/``ts``/
  ``pid``/``tid``; at least one complete (``"X"``) ``level`` span (one
  per mining level on a host-planned run) and at least one
  plan-provenance event (``plan.*``).
* **Metrics** — a :func:`repro_torch.obs.metrics.snapshot` dump with
  ``counters``/``gauges``/``histograms`` sections and at least one
  per-level ``mine.cap_utilization`` gauge.

The same contract as ``repro.obs.validate``, so either validator accepts
the other package's files.  ``chip_smoke.py`` checks the mining CLI's
exports with it; import :func:`validate_trace` / :func:`validate_metrics`
directly for the programmatic form (they raise ``ValueError``).
"""
from __future__ import annotations

import json
import sys


def validate_trace(doc: dict) -> dict:
    """Raise ValueError unless ``doc`` is a valid exported trace.

    Returns ``{"events": n, "level_spans": n, "plan_events": n}``.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace: not a Chrome trace object "
                         "(missing traceEvents)")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("trace: traceEvents empty")
    level_spans = plan_events = 0
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"trace: event {i} missing {field!r}")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"trace: X event {i} bad dur")
            if ev["name"] == "level":
                level_spans += 1
        if str(ev["name"]).startswith("plan."):
            plan_events += 1
    if level_spans == 0:
        raise ValueError("trace: no per-level 'level' spans")
    if plan_events == 0:
        raise ValueError("trace: no plan-provenance events (plan.*)")
    return {"events": len(events), "level_spans": level_spans,
            "plan_events": plan_events}


def validate_metrics(doc: dict) -> dict:
    """Raise ValueError unless ``doc`` is a valid metrics snapshot.

    Returns ``{"counters": n, "gauges": n, "histograms": n}``.
    """
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            raise ValueError(f"metrics: missing {section!r} section")
    if not any(doc[s] for s in ("counters", "gauges", "histograms")):
        raise ValueError("metrics: snapshot vacuously empty — the run "
                         "recorded nothing (metrics.on off, or the "
                         "dump was taken before any work)")
    util = [k for k in doc["gauges"] if k.startswith("mine.cap_utilization")]
    if not util:
        raise ValueError("metrics: no mine.cap_utilization gauges")
    for k in util:
        v = doc["gauges"][k]
        if not (0.0 <= v <= 1.0):
            raise ValueError(f"metrics: {k} = {v} outside [0, 1]")
    for k, h in doc["histograms"].items():
        for field in ("count", "sum", "p50", "p99", "buckets"):
            if field not in h:
                raise ValueError(f"metrics: histogram {k} missing "
                                 f"{field!r}")
    return {"counters": len(doc["counters"]),
            "gauges": len(doc["gauges"]),
            "histograms": len(doc["histograms"])}


def _load(path: str, kind: str) -> dict:
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise ValueError(f"{kind}: cannot read {path}: {e}") from e
    if not text.strip():
        raise ValueError(f"{kind}: {path} is empty (zero bytes is not "
                         f"a valid export — the run produced nothing)")
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"{kind}: {path} is not JSON: {e}") from e


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: python -m repro_torch.obs.validate "
                         "TRACE.json [METRICS.json]")
    try:
        info = validate_trace(_load(argv[0], "trace"))
        print(f"[obs.validate] trace ok: {info}")
        if len(argv) > 1:
            info = validate_metrics(_load(argv[1], "metrics"))
            print(f"[obs.validate] metrics ok: {info}")
    except ValueError as e:
        # loud, single-line, exit 1 — the CI job gates on this
        raise SystemExit(f"[obs.validate] FAIL: {e}")


if __name__ == "__main__":
    main()
