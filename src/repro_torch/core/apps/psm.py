"""Generic pattern mining: any compiled pattern as a MiningApp (counterpart
of ``repro.core.apps.psm``).

``pattern_app(Pattern.named("diamond"))`` compiles the pattern
(:mod:`repro_torch.core.patterns`) and turns each level of the
:class:`~repro_torch.core.patterns.MatchingPlan` into the hooks the engine
runs:

* ``to_extend`` activates exactly the level's anchor slot, so each
  candidate is enumerated once, from one adjacency list;
* ``to_add_spec`` is one :class:`~repro_torch.core.api.PredicateSpec` per
  level: required and forbidden connectivity, injectivity and the
  symmetry-breaking order constraints (and, for a labeled pattern, its
  label equations), the form the CUDA kernels evaluate in place of JAX's
  traced ``to_add_kernel``.

``pattern_set_app`` compiles a whole set into one common-prefix trie: each
level is a :class:`~repro_torch.core.api.BranchSetSpec`, whose branch
bitmap is both the predicate and the new state column, and the leaf bits
of the last state column are the per-pattern counts (``state_histogram``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.api import (Branch, BranchSetSpec, GraphCtx,
                                  MiningApp, PredicateSpec, _bits)
from repro_torch.core.patterns import (GraphStats, LevelPlan, MatchingPlan,
                                       Pattern, PatternSetPlan,
                                       compile_pattern, compile_pattern_set)

__all__ = ["pattern_app", "pattern_set_app", "make_level_spec",
           "make_labeled_level_spec", "make_set_branch_spec"]


def make_level_spec(lp: LevelPlan) -> PredicateSpec:
    """The conjunction for one matching-order position (the counterpart of
    ``make_level_kernel_predicate``): required slots adjacent, forbidden
    ones not (induced matching), ``u != emb_j`` for every distinct slot,
    and ``u > emb_j`` for each symmetry-breaking constraint ``v_j <
    v_new``."""
    return PredicateSpec(required=_bits(lp.required),
                         forbidden=_bits(lp.forbidden),
                         distinct=_bits(lp.distinct),
                         greater=_bits(lp.smaller))


def make_labeled_level_spec(lp: LevelPlan, labels) -> PredicateSpec:
    """The labeled variant (``make_labeled_level_kernel_predicate``): the
    candidate's label is the position's, and the first extension (position
    2) also checks the labels of slots 0 and 1, the level-0 label
    filter."""
    first = ((int(labels[0]), int(labels[1])) if lp.position == 2
             else None)
    spec = make_level_spec(lp)
    return PredicateSpec(required=spec.required, forbidden=spec.forbidden,
                         distinct=spec.distinct, greater=spec.greater,
                         label=int(labels[lp.position]), first_labels=first)


def _make_to_extend(plan: MatchingPlan):
    anchors = {lp.position: lp.anchor for lp in plan.levels}

    def to_extend(ctx: GraphCtx, emb: torch.Tensor) -> torch.Tensor:
        mask = torch.zeros(emb.shape, dtype=torch.bool, device=emb.device)
        mask[:, anchors[emb.shape[1]]] = True
        return mask

    return to_extend


def pattern_app(pattern: Pattern, induced: bool = True,
                backend: Optional[str] = None,
                stats: Optional[GraphStats] = None) -> MiningApp:
    """Compile ``pattern`` and wrap the plan as a MiningApp.

    ``induced=True`` counts vertex-induced occurrences (the diamond count
    equals ``mc(4)``'s diamond entry); ``induced=False`` counts subgraph
    occurrences.  Every occurrence is counted once, so the result is
    ``MineResult.count`` with no reduce.  ``stats``
    (:func:`~repro_torch.core.patterns.graph_stats` of the target graph)
    turns on input-aware matching-order selection.
    """
    plan = compile_pattern(pattern, induced=induced, stats=stats)
    p = plan.pattern
    if p.labels is None:
        specs = tuple(make_level_spec(lp) for lp in plan.levels)
    else:
        specs = tuple(make_labeled_level_spec(lp, p.labels)
                      for lp in plan.levels)
    return MiningApp(
        name=f"psm[{pattern.name}]", kind="vertex", max_size=p.k,
        backend=backend, max_patterns=1,
        directed_worklist=not plan.first_pair_symmetric,
        plan_key=plan.plan_key, to_extend=_make_to_extend(plan),
        to_add_spec=specs)


# ---------------------------------------------------------------------------
# Multi-pattern sets: one traversal for a whole pattern set


def make_set_branch_spec(branches) -> BranchSetSpec:
    """One trie level's branch set (``make_set_branch_bits``): bit b of its
    bitmap is set iff the candidate extends branch b."""
    return BranchSetSpec(tuple(Branch.from_set_branch(br)
                               for br in branches))


def _make_set_to_extend(plan: PatternSetPlan):
    anchors = {lvl[0].position: tuple(sorted({br.anchor for br in lvl}))
               for lvl in plan.levels}

    def to_extend(ctx: GraphCtx, emb: torch.Tensor) -> torch.Tensor:
        mask = torch.zeros(emb.shape, dtype=torch.bool, device=emb.device)
        for a in anchors[emb.shape[1]]:
            mask[:, a] = True
        return mask

    return to_extend


def _make_set_to_extend_state(plan: PatternSetPlan):
    """Per-embedding anchor activation: slot a is enumerated only by rows
    whose bitmap still carries a branch anchored at a, so dead branches
    generate no candidates."""
    by_level: dict = {}
    for lvl in plan.levels:
        slots: dict = {}
        for br in lvl:
            slots.setdefault(br.anchor, set()).add(br.parent)
        by_level[lvl[0].position] = {
            a: tuple(sorted(ps)) for a, ps in slots.items()}

    def to_extend_state(ctx: GraphCtx, emb: torch.Tensor,
                        state: torch.Tensor) -> torch.Tensor:
        mask = torch.zeros(emb.shape, dtype=torch.bool, device=emb.device)
        for a, parents in by_level[emb.shape[1]].items():
            live = torch.zeros(state.shape, dtype=torch.bool,
                               device=state.device)
            for p in parents:
                live = live | (((state >> p) & 1) == 1)
            mask[:, a] = live
        return mask

    return to_extend_state


def _make_set_histogram(plan: PatternSetPlan, dedup_slot: tuple[int, ...]):
    """Leaf bits -> per-input-pattern counts: ``p_map[i]`` is the count of
    the caller's ``patterns[i]`` (isomorphic duplicates share a slot, so
    they report the same count)."""
    n_dedup = len(plan.patterns)
    leaves = plan.leaves

    def state_histogram(state: torch.Tensor, valid: torch.Tensor):
        v = valid.to(torch.int32)
        pm = torch.zeros(n_dedup, dtype=torch.int32, device=state.device)
        for b, pid in enumerate(leaves):
            pm[pid] += (v * ((state >> b) & 1)).sum(dtype=torch.int32)
        # a slot per input pattern, by host indices (no host-to-device copy)
        return torch.stack([pm[s] for s in dedup_slot])

    return state_histogram


def _root_state(ctx: GraphCtx, emb: torch.Tensor, n) -> torch.Tensor:
    """Every embedding starts at the trie root (bit 0)."""
    return torch.ones(emb.shape[:1], dtype=torch.int32, device=emb.device)


def pattern_set_app(patterns: Sequence[Pattern], induced: bool = True,
                    backend: Optional[str] = None,
                    name: Optional[str] = None,
                    stats: Optional[GraphStats] = None) -> MiningApp:
    """Compile a whole pattern set into one app (a shared trie).

    Per level every live trie branch is extended at once (``to_extend``
    activates the union of branch anchors, ``to_extend_state`` only those
    the row's bitmap still carries), the branch bitmap threads through the
    embedding list as the state column (``update_state_kernel``, the
    level's :meth:`BranchSetSpec.bits`), and a candidate survives iff it
    extends any live branch.  ``MineResult.p_map[i]`` is the count of
    ``patterns[i]``; with ``induced=True`` ``count`` is the sum of the
    deduplicated counts, and non-induced it counts matched embeddings.
    """
    plan = compile_pattern_set(patterns, induced=induced, stats=stats)
    specs = tuple(make_set_branch_spec(lvl) for lvl in plan.levels)
    return MiningApp(
        name=name or f"psm-set[{len(plan.patterns)}x{plan.k}v]",
        kind="vertex", max_size=plan.k, backend=backend,
        max_patterns=len(plan.dedup_slot), needs_reduce=True,
        directed_worklist=plan.directed, plan_key=plan.plan_key,
        to_extend=_make_set_to_extend(plan),
        to_extend_state=_make_set_to_extend_state(plan),
        to_add_spec=specs,
        update_state_kernel=tuple(spec.bits for spec in specs),
        state_histogram=_make_set_histogram(plan, plan.dedup_slot),
        init_state=_root_state)
