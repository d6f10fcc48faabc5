"""k-clique finding (paper Listing 3; counterpart of ``repro.core.apps.cf``).

Eager pruning extends only the last vertex of each embedding, and a
candidate survives iff it is connected to every embedding vertex.  With DAG
orientation (§4.1) each clique is generated once; without it uniqueness is
``u > last``.  The rules are also given as a :class:`PredicateSpec` per
level, the form the CUDA kernels read; the variant without eager pruning
and without the DAG needs the automorphism-canonical test, which a spec
cannot express, so it has none and runs only on the ``torch-ref`` backend.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (GraphCtx, MiningApp, PredicateSpec,
                                  is_auto_canonical_vertex)


def clique_spec(kk: int, use_dag: bool, eager_prune: bool):
    """The clique rules of ``repro.core.apps.cf`` for parent width ``kk``,
    or None where they need the canonical test."""
    every = (1 << kk) - 1
    if use_dag:
        return PredicateSpec(required=every, distinct=every,
                             src_slot_eq=-1 if eager_prune else kk - 1)
    if eager_prune:
        return PredicateSpec(required=every, greater=1 << (kk - 1))
    return None


def make_cf_app(k: int, use_dag: bool = True,
                eager_prune: bool = True) -> MiningApp:
    def to_extend(ctx: GraphCtx, emb: torch.Tensor) -> torch.Tensor:
        if eager_prune:
            mask = torch.zeros(emb.shape, dtype=torch.bool,
                               device=emb.device)
            mask[:, emb.shape[1] - 1] = True
            return mask
        return torch.ones(emb.shape, dtype=torch.bool, device=emb.device)

    def to_add(ctx: GraphCtx, emb: torch.Tensor, u: torch.Tensor,
               src_slot: torch.Tensor, state):
        kk = emb.shape[1]
        ok = u >= 0
        for j in range(kk):
            ok = ok & ctx.is_connected(emb[:, j], u)
        if use_dag:
            for j in range(kk):
                ok = ok & (u != emb[:, j])
            if not eager_prune:
                ok = ok & (src_slot == kk - 1)
        elif eager_prune:
            ok = ok & (u > emb[:, kk - 1])
        else:
            ok = ok & is_auto_canonical_vertex(ctx, emb, u, src_slot)
        return ok

    specs = tuple(clique_spec(kk, use_dag, eager_prune)
                  for kk in range(2, max(k, 3)))
    # without eager pruning every slot extends, so the capacities differ:
    # the ablation keys its plans apart (the default keys as JAX's does)
    return MiningApp(name=f"{k}-clique", kind="vertex", max_size=k,
                     use_dag=use_dag, to_extend=to_extend, to_add=to_add,
                     to_add_spec=None if None in specs else specs,
                     plan_key="" if eager_prune else "no-eager-prune")


def make_cf_app_compiled(k: int) -> MiningApp:
    """k-clique through the pattern compiler instead of the hand-written
    rules: ``pattern_app(Pattern.clique(k))``, whose symmetry-breaking
    chain ``v0 < v1 < ... < v_{k-1}`` plays the role of the DAG
    orientation.  It counts every clique once, as :func:`make_cf_app`."""
    # through psm's names: this module's hooks call ctx.is_connected, and
    # the contract linter would take Pattern's host method for it
    from repro_torch.core.apps import psm
    return psm.pattern_app(psm.Pattern.clique(k))
