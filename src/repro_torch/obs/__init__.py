"""Lightweight, dependency-free observability: tracing + metrics
(counterpart of ``repro.obs``, the same behaviour and file schemas).

* :mod:`repro_torch.obs.trace` — span-based host tracer with Chrome-trace
  JSON export (Perfetto); module-level no-op fast path when disabled.
* :mod:`repro_torch.obs.metrics` — process-global registry of counters,
  gauges, and log-bucketed histograms with text/JSON dumps.
* :mod:`repro_torch.obs.report` — structured plain-text reporters (per-level
  mining table, plan provenance, latency summaries).
* :mod:`repro_torch.obs.validate` — schema validation for exported trace and
  metrics files (the CI check, ``python -m repro_torch.obs.validate``).

The package imports nothing from the rest of repro_torch (nor torch, nor
any other third-party package), so every layer — engine, plan, blocks, phase backends, launch
CLIs, benchmarks — can instrument through it without import cycles.
"""
from repro_torch.obs import metrics, report, trace

__all__ = ["metrics", "report", "trace"]
