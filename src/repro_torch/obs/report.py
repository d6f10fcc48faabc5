"""Structured plain-text reporters for CLI output.

Duck-typed over the engine's ``LevelStats`` (``level``,
``n_candidates``, ``n_embeddings``, ``capacity``, ``seconds``,
``live_bytes``) so this module needs no repro_torch.core import — the obs
package stays leaf-level and cycle-free.
"""
from __future__ import annotations

from typing import Iterable, Sequence


def _fmt_row(cols: Sequence[str], widths: Sequence[int]) -> str:
    return "  ".join(str(c).rjust(w) for c, w in zip(cols, widths))


def level_table(stats: Iterable) -> str:
    """Per-level mining table: candidates, survivors, cap, utilization.

    ``utilization`` is the cap-utilization ratio — survivors over the
    planned output capacity — the quantity that tells you whether the
    capacity planner's buffers are tight (≈100%) or padded air.
    """
    header = ("level", "candidates", "survivors", "cap", "util%",
              "time_ms", "live_MB")
    rows = [header]
    for s in stats:
        util = (100.0 * s.n_embeddings / s.capacity) if s.capacity else 0.0
        rows.append((str(s.level), str(s.n_candidates),
                     str(s.n_embeddings), str(s.capacity),
                     f"{util:.1f}", f"{s.seconds * 1e3:.2f}",
                     f"{getattr(s, 'live_bytes', 0) / 1e6:.2f}"))
    widths = [max(len(str(r[i])) for r in rows)
              for i in range(len(header))]
    return "\n".join(_fmt_row(r, widths) for r in rows)


def plan_table(reports: Iterable[dict]) -> str:
    """One line per executor plan (provenance, caps, executions).  A
    report with a ``compiles`` count (the JAX package's) prints it too."""
    lines = []
    for rep in reports:
        compiles = (f"compiles={rep['compiles']} " if "compiles" in rep
                    else "")
        lines.append(
            f"plan cap0={rep['cap0']} source={rep['source']} "
            f"caps={rep['caps']} out_cap_total={rep['out_cap_total']} "
            f"{compiles}executions={rep['executions']} "
            f"replans={rep['replans']}")
    return "\n".join(lines)


def latency_summary(name: str, hist) -> str:
    """p50/p99 line for a latency histogram (ms values)."""
    s = hist.summary()
    return (f"{name}: n={s['count']} mean={s['mean']:.2f}ms "
            f"p50={s['p50']:.2f}ms p99={s['p99']:.2f}ms "
            f"max={s['max']:.2f}ms")
