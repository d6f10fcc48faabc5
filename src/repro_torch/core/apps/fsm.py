"""Frequent subgraph mining (paper Listing 5; counterpart of
``repro.core.apps.fsm``).

Edge-induced exploration over a labeled graph; MNI (domain) support
(Fig. 2); FILTER drops embeddings whose pattern's support is below the
threshold, which the anti-monotonic property of MNI makes sound (§2.1
footnote 2).  k-FSM mines frequent patterns with k-1 edges (§6.1).

Eager pruning (``to_add_vertex_mask``): a candidate vertex whose label
occurs fewer than ``min_support`` times in the whole graph can never
appear in a frequent embedding, because MNI domains are label-homogeneous.
The prune depends only on the candidate vertex, so it is a per-vertex mask
that the edge kernel gathers per candidate (and the plain pipeline with a
PyTorch gather).  The engine evaluates the hook once per ``Miner``.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import GraphCtx, MiningApp


def make_fsm_app(k: int, min_support: int,
                 max_patterns: int = 64) -> MiningApp:
    def to_add_vertex_mask(ctx: GraphCtx) -> torch.Tensor:
        if ctx.labels is None or min_support <= 0:
            return torch.ones(ctx.n_vertices, dtype=torch.bool,
                              device=ctx.device)
        # label histogram on the device (a scatter-add, not bincount,
        # which reads the host on CUDA)
        lab = ctx.labels.clamp(0, ctx.n_labels).long()
        freq = torch.zeros(ctx.n_labels + 1, dtype=torch.int32,
                           device=ctx.device)
        freq.scatter_add_(0, lab, torch.ones_like(lab, dtype=torch.int32))
        return freq[lab] >= min_support

    return MiningApp(name=f"{k}-fsm", kind="edge", max_size=k,
                     needs_reduce=True, needs_filter=True,
                     support_mode="domain", min_support=min_support,
                     to_add_vertex_mask=to_add_vertex_mask,
                     max_patterns=max_patterns)
