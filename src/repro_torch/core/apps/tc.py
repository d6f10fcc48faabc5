"""Triangle counting (paper §3.3; counterpart of ``repro.core.apps.tc``).

TC is 3-clique finding; the engine path reuses the CF app.  The fused path
(``triangle_count_fused``) is the hand-optimised equivalent: orient to a
DAG and sum |N+(u) ∩ N+(v)| over directed edges with the binary-search
intersection, on the ``intersect_count`` CUDA kernel (Table 4a comparison
point).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.api import MiningApp
from repro_torch.core.apps.cf import make_cf_app
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.dag import orient_dag
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.sparse.intersect import intersect_count_sorted


def make_tc_app(use_dag: bool = True, eager_prune: bool = True) -> MiningApp:
    app = make_cf_app(3, use_dag=use_dag, eager_prune=eager_prune)
    return dataclasses.replace(app, name="tc")


def triangle_count_fused(g: CSRGraph, use_kernel: bool = True) -> int:
    """DAG + per-edge sorted-intersection count (no embedding lists), on
    the graph's device.

    ``use_kernel=True`` (the default here; the JAX package's default is
    False) runs the ``intersect_count`` wrapper: on a CUDA graph its kernel,
    on a CPU graph its plain version.  The port's entry point must reach
    the card's kernel, so the plain PyTorch intersection
    (``intersect_count_sorted``) runs only when the caller passes
    ``use_kernel=False``.  The counts are summed in int64 on the device and
    read once.
    """
    dag = orient_dag(g)
    if dag.n_edges == 0:
        return 0
    src, dst = (t.long() for t in dag.edge_list())
    rp = dag.row_ptr
    n_steps = max(1, math.ceil(math.log2(max(dag.max_degree, 1) + 1)))
    args = (dag.col_idx, rp[src], rp[src + 1], rp[dst], rp[dst + 1])
    if use_kernel:
        cnt = intersect_ops.intersect_count(*args, max_deg=dag.max_degree,
                                            n_steps=n_steps)
    else:
        cnt = intersect_count_sorted(*args, max_deg=dag.max_degree,
                                     n_steps=n_steps)
    return int(cnt.sum(dtype=torch.int64))
