"""Host-side numpy samplers (counterpart of ``repro.graph.sampler``).

Two consumers share these primitives:

* :func:`sample_fanout` — GraphSAGE minibatch frontiers (fixed-shape
  ``[B * prod(fanout)]`` blocks).  Sampling with replacement from each
  vertex's CSR segment; isolated vertices self-loop.
* The sampled capacity estimator (:func:`repro_torch.core.plan.
  estimate_plan`) — :func:`sample_worklist` and
  :func:`sample_worklist_stratified` draw the level-0 embeddings it probes
  through the real mining pipeline.

Each draws from a ``numpy.random.Generator`` the same numbers in the same
order as the JAX package's function, so the two give the same sample.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def sample_fanout(g: CSRGraph, seeds: np.ndarray,
                  fanouts: tuple[int, ...], seed: int = 0
                  ) -> list[np.ndarray]:
    """Returns frontiers [seeds, hop1, hop2, ...]; hop_k has
    len(seeds) * prod(fanouts[:k]) vertex ids."""
    rng = np.random.default_rng(seed)
    rp = g.row_ptr.cpu().numpy()
    ci = g.col_idx.cpu().numpy()
    frontiers = [np.asarray(seeds, np.int32)]
    cur = frontiers[0]
    for fan in fanouts:
        deg = rp[cur + 1] - rp[cur]
        if ci.size == 0:
            # zero-edge graph: every vertex is isolated, so all self-loop
            # (the gather below would index an empty array)
            nbrs = np.broadcast_to(cur[:, None], (len(cur), fan))
        else:
            # sample with replacement; degree-0 vertices self-loop
            r = rng.integers(0, np.maximum(deg, 1)[:, None],
                             size=(len(cur), fan))
            idx = rp[cur][:, None] + r
            nbrs = np.where(deg[:, None] > 0,
                            ci[np.minimum(idx, len(ci) - 1)],
                            cur[:, None])
        cur = nbrs.reshape(-1).astype(np.int32)
        frontiers.append(cur)
    return frontiers


def sample_worklist(m: int, sample_size: int, rng: np.random.Generator,
                    sort: bool = True) -> np.ndarray:
    """Sample (without replacement) of level-0 worklist indices.

    ``sort=True`` keeps the sampled indices in worklist order (FSM's edge
    uids keep their relative order, so the canonical edge-growth test
    makes every comparison the full worklist would); ``sort=False``
    shuffles, so a probe that truncates its frontier keeps a uniform
    subsample rather than a low-id prefix."""
    size = min(int(sample_size), int(m))
    idx = rng.choice(m, size=size, replace=False).astype(np.int64)
    return np.sort(idx) if sort else idx


def sample_worklist_stratified(m: int, sample_size: int,
                               rng: np.random.Generator, bands: int = 8,
                               sort: bool = False) -> np.ndarray:
    """Stratified worklist sample: a proportional share from each of
    ``bands`` contiguous index ranges.

    After degree relabeling the level-0 worklist is in CSR order, so index
    order is source-degree order and the bands are degree strata: the hub
    head, whose few rows dominate the candidate counts, cannot be missed.
    Every band is sampled at the same rate, so the plain sampling-fraction
    scale-up still holds."""
    m, size = int(m), min(int(sample_size), int(m))
    if size <= 0:
        return np.empty((0,), dtype=np.int64)
    bands = max(1, min(int(bands), size))
    edges = np.linspace(0, m, bands + 1).astype(np.int64)
    picks = []
    for b in range(bands):
        lo, hi = edges[b], edges[b + 1]
        # proportional allocation; rounding drift lands in the last band
        k = (size * (b + 1)) // bands - (size * b) // bands
        k = min(k, hi - lo)
        if k > 0:
            picks.append(lo + rng.choice(hi - lo, size=k, replace=False))
    idx = np.concatenate(picks).astype(np.int64) if picks else \
        np.empty((0,), dtype=np.int64)
    if sort:
        return np.sort(idx)
    rng.shuffle(idx)
    return idx
