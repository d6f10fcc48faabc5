"""Span-based host tracer with Chrome-trace-event (Perfetto) export.

One process-global tracer, off by default.  When enabled
(:func:`enable` / ``--trace out.json`` on the launch CLIs) every
:func:`span` brackets a host-side phase as a Chrome ``"X"`` (complete)
event — wall-clock ``ts``/``dur`` in microseconds plus a ``cpu_us``
process-time figure in ``args`` — and every :func:`instant` drops a
point event (plan provenance, overflow warnings, cache hits).  Spans on
the same thread nest naturally in the Perfetto timeline by interval
containment; the exported JSON (:meth:`Tracer.to_chrome` /
:func:`save`) loads directly in https://ui.perfetto.dev.

**Disabled fast path.**  The module-level :data:`on` flag is the
contract: hot call sites guard with ``if trace.on:`` (one module
attribute read) and pay nothing else when tracing is off.
Cold call sites may call :func:`span` unguarded; it returns a shared
no-op context manager without allocating.

**Device work.**  The tracer never forces a device sync: a span around
CUDA work measures the host time to *queue* it (kernel launches return
before the card finishes).  Phases whose results are read on the host
anyway (host inspection ``int()`` reads, the executor's one read of its
results and overflow flag) are exact for free; for exact attribution of
the rest, :func:`enable` with ``sync=True`` (``--trace-sync``) makes
instrumented call sites block until the card is idle — callers check
:func:`sync_enabled` and call ``torch.cuda.synchronize()`` themselves, so
this module stays dependency-free (no torch import).

This module is intentionally free of any repro_torch.* (or third-party)
imports so every layer of the stack can use it without cycles.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

# Module-level fast-path flag: hot call sites guard on `trace.on` and
# skip all span machinery when tracing is disabled.  enable()/disable()
# rebind it together with the tracer.
on: bool = False

_tracer: Optional["Tracer"] = None


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:                                   # numpy / torch scalars
        return v.item()
    except (AttributeError, ValueError, RuntimeError):
        return str(v)                      # not a scalar: its text


class _NullSpan:
    """Shared no-op span for the disabled path (never allocates)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


_NULL = _NullSpan()


class Span:
    """One live ``"X"`` event; use as a context manager (or begin/end)."""

    __slots__ = ("_tr", "name", "cat", "args", "_ts", "_cpu0", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._ts = 0
        self._cpu0 = 0
        self._done = False

    def set(self, **args) -> None:
        """Attach args discovered while the span is open (e.g. counts)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._ts = time.perf_counter_ns()
        self._cpu0 = time.process_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur_ns = time.perf_counter_ns() - self._ts
        cpu_ns = time.process_time_ns() - self._cpu0
        tr = self._tr
        args = {k: _jsonable(v) for k, v in self.args.items()}
        args["cpu_us"] = cpu_ns / 1e3
        tr.events.append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": (self._ts - tr.t0) / 1e3, "dur": dur_ns / 1e3,
            "pid": tr.pid, "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args})


class Tracer:
    """Event sink for one trace (see :func:`enable`)."""

    def __init__(self, sync: bool = False):
        self.events: list[dict] = []
        self.t0 = time.perf_counter_ns()
        self.pid = os.getpid()
        self.sync = bool(sync)

    def span(self, name: str, cat: str, args: dict) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str, args: dict) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self.t0) / 1e3,
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": {k: _jsonable(v) for k, v in args.items()}})

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (loads in Perfetto)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"tool": "repro_torch.obs.trace",
                              "sync": self.sync}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------------
# Module API (the process-global tracer)


def enable(sync: bool = False) -> Tracer:
    """Start a fresh trace; returns the live :class:`Tracer`.

    ``sync=True`` is the ``--trace-sync`` mode: instrumented call sites
    that dispatch device work (see :func:`sync_enabled`) block until
    their results are ready so device-side phases are attributed
    exactly, at the cost of serializing dispatch.
    """
    global _tracer, on
    _tracer = Tracer(sync=sync)
    on = True
    return _tracer


def disable() -> None:
    global _tracer, on
    _tracer = None
    on = False


def active() -> bool:
    return _tracer is not None


def sync_enabled() -> bool:
    """True when the tracer wants exact (blocking) device attribution."""
    t = _tracer
    return t is not None and t.sync


def get() -> Optional[Tracer]:
    return _tracer


def span(name: str, cat: str = "mine", **args):
    """A span context manager; the shared no-op when tracing is off."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat, args)


def instant(name: str, cat: str = "event", **args) -> None:
    """A point event (plan provenance, warnings); no-op when off."""
    t = _tracer
    if t is not None:
        t.instant(name, cat, args)


def save(path: str) -> Optional[str]:
    """Write the current trace's Chrome trace JSON; None when off."""
    t = _tracer
    if t is None:
        return None
    return t.save(path)
