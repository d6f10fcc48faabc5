"""Triangle counting (paper §3.3; counterpart of ``repro.core.apps.tc``).

TC is 3-clique finding through the engine.  The hand-optimised path of the
JAX package (``triangle_count_fused``, a per-edge sorted intersection on the
``intersect`` Pallas kernel) waits for a later slice of the port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import MiningApp
from repro_torch.core.apps.cf import make_cf_app


def make_tc_app(use_dag: bool = True, eager_prune: bool = True) -> MiningApp:
    app = make_cf_app(3, use_dag=use_dag, eager_prune=eager_prune)
    return dataclasses.replace(app, name="tc")
