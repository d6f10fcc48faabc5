"""In-process metrics registry: counters, gauges, log-bucketed histograms.

One process-global :class:`Registry` (module-level convenience
functions), dependency-free and on by default — recording is a couple
of dict operations, and every instrumented site sits next to a host
sync that costs orders of magnitude more.  The module-level ``on``
flag (mirroring ``trace.on``) gates the convenience recorders so
instrumented call sites outside obvious host guards can stay
contract-clean (``if metrics.on: ...``) and overhead-sensitive runs
can switch recording off wholesale.  Consumers are the launch CLIs
(``--metrics`` plain-text / JSON dump, the serve ``/metrics``-style
endpoint shape) and the bench (``cap_utilization`` / ``stage_overlap``
columns read from this registry instead of bespoke bench-side timing).

Metric identity is ``(name, labels)`` — labels are keyword arguments,
rendered Prometheus-style (``mine.cap_utilization{level=2}``).  The
three types:

* **Counter** — monotone accumulator (:func:`inc`); also used for
  accumulated seconds (``executor.replay_s``).
* **Gauge** — last-write-wins value (:func:`set_gauge`).
* **Histogram** — power-of-two log buckets (:func:`observe`): value
  ``v > 0`` lands in bucket ``i = ceil(log2(v))`` covering
  ``(2**(i-1), 2**i]``; non-positive values count in a dedicated zero
  bucket.  Tracks count/sum/min/max; :meth:`Histogram.percentile`
  returns the upper edge of the bucket holding the q-quantile — an
  upper bound with bounded relative error (a factor of 2), which is
  what latency p50/p99 reporting needs without storing samples.

Not thread-safe by design: the mining stack is host-single-threaded
(CUDA's asynchronous launches do the overlapping), and the registry is
read at reporting boundaries only.
"""
from __future__ import annotations

import json
import math
from typing import Optional

# Module-level fast-path flag, same idiom as ``trace.on``: call sites
# guard on it (or rely on the convenience recorders below, which check
# it) and recording becomes a no-op when flipped off.
on: bool = True


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _render_key(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log2-bucketed histogram; see the module docstring for bucket math."""

    __slots__ = ("buckets", "zero", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets: dict[int, int] = {}    # ceil(log2(v)) -> count
        self.zero = 0                        # values <= 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @staticmethod
    def bucket_of(v: float) -> Optional[int]:
        """Bucket index for ``v`` (None = the zero bucket)."""
        if v <= 0:
            return None
        return max(math.ceil(math.log2(v)), -64)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        i = self.bucket_of(v)
        if i is None:
            self.zero += 1
        else:
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Upper bucket edge of the q-quantile (q in [0, 1])."""
        if self.count == 0:
            return 0.0
        target = max(q, 0.0) * self.count
        cum = self.zero
        if cum >= target and self.zero:
            return 0.0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= target:
                return float(2.0 ** i)
        return float(self.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "mean": self.mean,
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99),
                "buckets": {str(k): v
                            for k, v in sorted(self.buckets.items())},
                "zero": self.zero}


class Registry:
    """Typed get-or-create metric store keyed by (name, labels)."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls()
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {_render_key(key)} is "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def find(self, name: str) -> dict[tuple, object]:
        """All metrics with this name, keyed by their label tuples."""
        return {key[1]: m for key, m in self._metrics.items()
                if key[0] == name}

    def value(self, name: str, **labels) -> Optional[float]:
        m = self._metrics.get(_key(name, labels))
        return None if m is None or isinstance(m, Histogram) else m.value

    def reset(self) -> None:
        self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-serializable dump (the ``--metrics out.json`` schema)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in sorted(self._metrics.items()):
            rk = _render_key(key)
            if isinstance(m, Counter):
                out["counters"][rk] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][rk] = m.value
            else:
                out["histograms"][rk] = m.summary()
        return out

    def render(self) -> str:
        """Plain-text dump (the ``--metrics`` / serve endpoint shape)."""
        lines = []
        for key, m in sorted(self._metrics.items()):
            rk = _render_key(key)
            if isinstance(m, Counter):
                lines.append(f"counter   {rk} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"gauge     {rk} {m.value:g}")
            else:
                s = m.summary()
                lines.append(
                    f"histogram {rk} count={s['count']} mean={s['mean']:g}"
                    f" min={s['min']:g} max={s['max']:g}"
                    f" p50={s['p50']:g} p99={s['p99']:g}")
        return "\n".join(lines)


REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def inc(name: str, value: float = 1.0, **labels) -> None:
    if on:
        REGISTRY.counter(name, **labels).inc(value)


def set_gauge(name: str, value: float, **labels) -> None:
    if on:
        REGISTRY.gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    if on:
        REGISTRY.histogram(name, **labels).observe(value)


def find(name: str) -> dict[tuple, object]:
    return REGISTRY.find(name)


def value(name: str, **labels) -> Optional[float]:
    return REGISTRY.value(name, **labels)


def reset() -> None:
    REGISTRY.reset()


def snapshot() -> dict:
    return REGISTRY.snapshot()


def render() -> str:
    return REGISTRY.render()


def dump(path: Optional[str]) -> str:
    """Write the registry to ``path`` (JSON for ``*.json``, text
    otherwise); ``None``/``"-"`` returns the text render instead."""
    if path is None or path == "-":
        return render()
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(snapshot(), f, indent=2)
    else:
        with open(path, "w") as f:
            f.write(render() + "\n")
    return path
