"""Host-side pattern compiler: spec -> matching order + kernel predicates
(a copy of ``repro.core.patterns.compile``, field for field the same
plans; the port turns each level's rules into the slot masks its CUDA
kernels read, in :mod:`repro_torch.core.apps.psm`).

This is the system's answer to Pangolin's flexibility claim: the paper
eliminates runtime isomorphism tests by baking *application-specific
knowledge* — a matching order and symmetry-breaking rules — into each
app's hooks, but expects the user to hand-derive them (Listing 3's clique
rules, Listing 4's motif memoization).  G2Miner-style, this module derives
that knowledge automatically from the pattern graph at plan time:

1. **Matching order** — connectivity-first: start at a max-degree pattern
   vertex, then repeatedly append the vertex with the most edges into the
   ordered prefix (ties: higher degree, lower id).  Every position except
   the first is adjacent to an earlier one, so candidate generation is
   always an adjacency-list walk of one *anchor* parent, and the most
   constrained (most-connected) positions come earliest — the selectivity
   the per-level capacity planner then measures and exploits.
2. **Symmetry breaking** — the automorphism group of the reordered
   pattern is reduced by a stabilizer chain: while non-trivial, take the
   smallest moved position ``i``, emit ``v_i < v_j`` for every other
   member ``j`` of its orbit, and descend into the stabilizer of ``i``.
   By orbit-stabilizer counting the surviving constraint set admits
   exactly ONE of the ``|Aut|`` automorphic embeddings of each match, so
   counting needs no canonical-labeling reduce step at all.
3. **Per-level connectivity masks** — for the position added at each
   level: which earlier positions must be adjacent (``required``) and,
   for induced matching, which must not be (``forbidden``).  Together
   with the order constraints these compile directly into the
   elementwise ``to_add_kernel`` predicate form that runs *inside* the
   fused Pallas extend kernel.

Everything here is plain python/numpy executed once per pattern; the
output :class:`MatchingPlan` is immutable and hashable pieces only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.patterns.spec import Pattern

__all__ = ["LevelPlan", "MatchingPlan", "SetBranch", "PatternSetPlan",
           "GraphStats", "graph_stats", "compile_pattern",
           "compile_pattern_set", "matching_order", "symmetry_break",
           "MAX_SET_BRANCHES"]

# The multi-pattern executor threads a per-embedding branch bitmap in the
# i32 memo-state column, so a trie level holds at most 32 branches (one
# bit per live trie node) — and therefore a set at most 32 patterns.
MAX_SET_BRANCHES = 32


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Compiled rules for extending to pattern position ``position``.

    All indices refer to positions in the *matching order* (= embedding
    slots).  ``anchor`` is the parent slot whose adjacency list generates
    the candidates; ``required``/``forbidden`` are the connectivity mask
    (candidate must / must not be adjacent to those slots); ``distinct``
    lists the slots needing an explicit ``u != v_j`` check — the
    non-required ones, where adjacency doesn't already imply
    distinctness (non-induced matching drops ``forbidden`` but is still
    an *injective* mapping, so ``distinct`` survives); ``smaller`` lists
    slots whose vertex id must be smaller than the candidate's (the
    symmetry-breaking order constraints that become checkable at this
    level)."""

    position: int
    anchor: int
    required: tuple[int, ...]
    forbidden: tuple[int, ...]
    distinct: tuple[int, ...]
    smaller: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MatchingPlan:
    """The full compiled plan for one pattern.

    ``pattern`` is the input pattern *reordered* into matching order
    (position i of every embedding matches pattern vertex i).
    ``first_pair_symmetric`` reports whether symmetry breaking emitted
    the ``v_0 < v_1`` constraint — in that case the level-0 worklist can
    be the undirected (src < dst) edge list, which enforces it
    structurally; otherwise positions 0 and 1 are distinguishable and the
    worklist must contain both orientations of every edge."""

    pattern: Pattern
    order: tuple[int, ...]
    levels: tuple[LevelPlan, ...]
    constraints: tuple[tuple[int, int], ...]
    n_automorphisms: int
    first_pair_symmetric: bool
    induced: bool

    @property
    def plan_key(self) -> str:
        """Plan-cache identity: isomorphism hash + matching semantics
        + a digest of the per-level rules.  The digest matters because
        the same pattern admits several matching orders (the cost model
        picks by graph statistics): capacity plans recorded for one
        order must not replay for another whose per-level frontiers
        differ."""
        levels_sig = hashlib.sha1(
            repr(tuple((lp.required, lp.smaller)
                       for lp in self.levels)).encode()).hexdigest()[:8]
        return (f"{self.pattern.hash_hex()}:"
                f"{'i' if self.induced else 'h'}:{levels_sig}")


# ---------------------------------------------------------------------------
# Degree/frequency-aware order cost model
#
# Pangolin expects the user to hand-derive matching orders; the PR-5
# compiler picks them connectivity-first with degree tie-breaks —
# structure only, blind to the input graph.  G2Miner's "input-aware"
# axis: the best order depends on the graph's degree profile (a sparse
# graph rewards early symmetry breaking, a dense one rewards early
# connectivity constraints).  GraphStats summarizes the input in four
# scalars + label frequencies, and _order_cost turns a candidate order's
# per-level (required, smaller) keys into an expected frontier-size
# trajectory under an independent-edge model: candidates per frontier
# row scale with the degree-biased mean degree (the extension anchor is
# reached by an edge, so it is degree-biased), each extra required
# adjacency survives with probability avg_degree/n, each order
# constraint halves survivors, and a label equality scales by that
# label's frequency.  The absolute numbers are crude; only the ranking
# between orders of the SAME pattern matters, and there the dominant
# factors (how early constraints bind) are exactly what the model sees.


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Cheap input-graph summary driving cost-model order selection.

    ``biased_degree`` is E[d^2]/E[d] — the expected degree of the vertex
    an edge points at (size-biased), which is what extension fan-out
    actually follows; ``label_freq[l]`` is the fraction of vertices
    labeled ``l`` (empty mapping for unlabeled graphs)."""

    n_vertices: int
    n_edges: int
    avg_degree: float
    biased_degree: float
    label_freq: tuple[tuple[int, float], ...] = ()

    def freq(self, label: int) -> float:
        return dict(self.label_freq).get(int(label), 1.0)


def _numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor on any device (or of an array)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def graph_stats(g) -> GraphStats:
    """Host-side degree/label statistics of a CSR graph (numpy, O(n))."""
    deg = _numpy(g.degrees()).astype(np.float64) if g.n_vertices \
        else np.zeros(0)
    total = float(deg.sum())
    avg = total / g.n_vertices if g.n_vertices else 0.0
    biased = float((deg ** 2).sum()) / total if total else 0.0
    label_freq: tuple[tuple[int, float], ...] = ()
    if getattr(g, "labels", None) is not None and g.n_vertices:
        lab = _numpy(g.labels)
        vals, counts = np.unique(lab, return_counts=True)
        label_freq = tuple((int(v), float(c) / g.n_vertices)
                           for v, c in zip(vals, counts))
    return GraphStats(n_vertices=int(g.n_vertices),
                      n_edges=int(g.n_edges), avg_degree=avg,
                      biased_degree=biased, label_freq=label_freq)


def _order_cost(keys, stats: GraphStats,
                level_labels: Optional[tuple[int, ...]] = None,
                first_pair_symmetric: bool = True) -> float:
    """Expected total work (candidates + survivors, all levels) of one
    candidate matching order, given per-level (required, smaller) keys."""
    n = max(stats.n_vertices, 1)
    p_edge = min(stats.avg_degree / n, 1.0)
    # level-0 frontier: one row per undirected edge when the first pair
    # is exchangeable (structural src < dst), both orientations otherwise
    f = stats.n_edges / 2.0 if first_pair_symmetric else float(stats.n_edges)
    cost = f
    for i, (required, smaller) in enumerate(keys):
        cand = f * stats.biased_degree
        surv = (cand * p_edge ** max(len(required) - 1, 0)
                * 0.5 ** len(smaller))
        if level_labels is not None:
            surv *= stats.freq(level_labels[i])
        cost += cand + surv
        f = surv
    return cost


def matching_order(pattern: Pattern,
                   stats: Optional[GraphStats] = None) -> tuple[int, ...]:
    """Matching order over the pattern's original vertex ids.

    Without ``stats``: the structural connectivity-first heuristic (start
    at a max-degree vertex, append the vertex with the most edges into
    the prefix; ties by degree then lower id).  With ``stats``: every
    legal order is scored by :func:`_order_cost` under that graph's
    degree/label statistics and the cheapest wins (ties broken
    deterministically by the order's rule keys, then the order itself).
    """
    if stats is None:
        adj = pattern.adjacency()
        deg = adj.sum(axis=1)
        first = int(max(range(pattern.k), key=lambda v: (deg[v], -v)))
        order = [first]
        remaining = set(range(pattern.k)) - {first}
        while remaining:
            nxt = max(remaining,
                      key=lambda v: (int(adj[v, order].sum()),
                                     int(deg[v]), -v))
            if not adj[nxt, order].any():
                # cannot happen for a connected pattern, but fail loudly
                raise ValueError(f"pattern {pattern.name!r}: vertex {nxt} "
                                 "has no edge into the ordered prefix")
            order.append(int(nxt))
            remaining.discard(nxt)
        return tuple(order)

    adj = pattern.adjacency()
    auts = pattern.automorphisms()
    best = None
    for order in _valid_orders(pattern):
        keys, fp = _order_keys(adj, auts, order)
        level_labels = None
        if pattern.labels is not None:
            level_labels = tuple(int(pattern.labels[order[i]])
                                 for i in range(2, pattern.k))
        rank = (_order_cost(keys, stats, level_labels,
                            first_pair_symmetric=fp), tuple(keys), order)
        if best is None or rank < best:
            best = rank
    return best[2]


def symmetry_break(pattern: Pattern) -> tuple[tuple[tuple[int, int], ...],
                                              int]:
    """Order constraints admitting one embedding per automorphism class.

    Returns ``(constraints, n_automorphisms)`` where each constraint
    ``(a, b)`` (always ``a < b`` as positions) demands ``v_a < v_b``.
    Stabilizer-chain construction: at each step the smallest still-moved
    position is constrained to be the minimum of its orbit, and the group
    shrinks to that position's stabilizer.  The product of the orbit
    sizes consumed equals ``|Aut|`` (orbit–stabilizer), so exactly one of
    the ``|Aut|`` automorphic placements of any match survives all
    constraints — matches are counted exactly once with no runtime
    canonical labeling."""
    return _stabilizer_constraints(pattern.k, pattern.automorphisms())


def _stabilizer_constraints(k: int, auts: list[tuple[int, ...]]
                            ) -> tuple[tuple[tuple[int, int], ...], int]:
    """Stabilizer-chain constraints for an explicit automorphism group."""
    constraints: list[tuple[int, int]] = []
    group = auts
    while len(group) > 1:
        moved = min(i for i in range(k)
                    if any(s[i] != i for s in group))
        orbit = sorted({s[moved] for s in group})
        for j in orbit:
            if j != moved:
                constraints.append((moved, j))
        group = [s for s in group if s[moved] == moved]
    return tuple(constraints), len(auts)


def compile_pattern(pattern: Pattern, induced: bool = True,
                    stats: Optional[GraphStats] = None) -> MatchingPlan:
    """Compile ``pattern`` into a :class:`MatchingPlan`.

    ``induced=True`` (default) matches vertex-induced subgraphs — the
    candidate at each level must be adjacent to exactly the pattern's
    required earlier positions and to none of the others, so counts line
    up with motif-census semantics.  ``induced=False`` drops the
    forbidden masks and counts subgraph occurrences (every edge of the
    pattern present, extra edges allowed).  ``stats``
    (:func:`graph_stats` of the target graph) switches matching-order
    selection to the input-aware cost model; counts are identical either
    way (every legal order counts each match once), only per-level
    frontier sizes — and therefore capacities and work — change.
    """
    pattern.validate()
    order = matching_order(pattern, stats=stats)
    reordered = pattern.relabel(order)
    adj = reordered.adjacency()
    if not adj[0, 1]:
        raise ValueError("matching order broke the level-0 edge invariant")
    constraints, n_aut = symmetry_break(reordered)
    levels = []
    for pos in range(2, pattern.k):
        required = tuple(j for j in range(pos) if adj[j, pos])
        non_adjacent = tuple(j for j in range(pos) if not adj[j, pos])
        smaller = tuple(a for a, b in constraints if b == pos)
        levels.append(LevelPlan(position=pos, anchor=max(required),
                                required=required,
                                forbidden=non_adjacent if induced else (),
                                distinct=non_adjacent, smaller=smaller))
    return MatchingPlan(pattern=reordered, order=order,
                        levels=tuple(levels), constraints=constraints,
                        n_automorphisms=n_aut,
                        first_pair_symmetric=(0, 1) in constraints,
                        induced=induced)


# ---------------------------------------------------------------------------
# Multi-pattern sets: merge matching orders into a common-prefix trie
#
# G2Miner's observation: patterns of a set usually share partial matching
# orders, so a whole set (all of mc(k)'s motifs, a user's pattern list) can
# be mined in ONE traversal — each level extends every live branch at once,
# and a per-embedding branch bitmap records which trie nodes the embedding
# still satisfies.  The compiler below picks each pattern's matching order
# *among all legal orders* to maximize the shared prefix, then merges the
# per-level (connectivity, symmetry) keys into a trie whose leaves are the
# patterns.


@dataclasses.dataclass(frozen=True)
class SetBranch:
    """One trie node: the rules for extending to ``position`` along it.

    ``parent`` is the branch index at the previous level whose bitmap bit
    must be set for this branch to stay live (bit 0 = the shared root for
    the first extension level).  ``first_pair`` marks the folded
    ``v_0 < v_1`` symmetry constraint — emitted only when the set runs on
    a *directed* level-0 worklist (some other pattern needs both edge
    orientations) and this branch's pattern has exchangeable first
    positions, so the structural ``src < dst`` filter is unavailable and
    the constraint must be checked explicitly."""

    position: int
    parent: int
    anchor: int
    required: tuple[int, ...]
    forbidden: tuple[int, ...]
    distinct: tuple[int, ...]
    smaller: tuple[int, ...]
    first_pair: bool = False


@dataclasses.dataclass(frozen=True)
class PatternSetPlan:
    """Compiled trie for one pattern set.

    ``levels[i]`` holds the branches extending to position ``i + 2``;
    ``leaves[b]`` maps final-level branch ``b`` to its pattern's index in
    ``patterns``.  ``directed`` mirrors ``MiningApp.directed_worklist``.
    ``n_nodes`` counts trie nodes — strictly fewer than the unshared
    ``len(patterns) * (k - 2)`` whenever any prefix is shared.
    ``dedup_slot[i]`` is the caller's i-th input pattern's index in the
    deduplicated ``patterns`` (isomorphic duplicates share a slot), so
    executors can report counts in the caller's indexing without
    re-deriving the isomorphism identity."""

    patterns: tuple[Pattern, ...]
    k: int
    induced: bool
    directed: bool
    levels: tuple[tuple[SetBranch, ...], ...]
    leaves: tuple[int, ...]
    n_nodes: int
    dedup_slot: tuple[int, ...] = ()
    cost_model: bool = False

    @property
    def plan_key(self) -> str:
        """Plan-cache identity: the set's isomorphism hashes + semantics.

        Order-insensitive (capacity plans depend on the branch union, not
        on pattern indices), so permuted sets share cached plans.  The
        ``cost_model`` flag separates tries whose order *tie-breaks* were
        picked by graph statistics from structurally-picked ones — their
        branch sets (and so per-level frontiers) can differ."""
        ident = (self.k, self.induced,
                 tuple(sorted(p.hash_hex() for p in self.patterns)))
        suffix = ":c" if self.cost_model else ""
        return ("set:" + hashlib.sha1(repr(ident).encode()).hexdigest()[:16]
                + suffix)


def _valid_orders(pattern: Pattern) -> list[tuple[int, ...]]:
    """Every vertex order whose each position >= 1 touches the prefix."""
    adj = pattern.adjacency()
    out: list[tuple[int, ...]] = []

    def rec(prefix: list[int], remaining: set):
        if not remaining:
            out.append(tuple(prefix))
            return
        for v in sorted(remaining):
            if not prefix or adj[v, prefix].any():
                rec(prefix + [v], remaining - {v})

    rec([], set(range(pattern.k)))
    return out


def _order_keys(adj: np.ndarray, auts: list, order: tuple[int, ...]):
    """Per-level (required, smaller) keys + first-pair symmetry for one
    candidate matching order (automorphisms conjugated, not recomputed)."""
    k = adj.shape[0]
    inv = [0] * k
    for i, v in enumerate(order):
        inv[v] = i
    a2 = adj[np.ix_(order, order)]
    auts2 = [tuple(inv[a[order[i]]] for i in range(k)) for a in auts]
    constraints, _ = _stabilizer_constraints(k, auts2)
    keys = []
    for pos in range(2, k):
        required = tuple(j for j in range(pos) if a2[j, pos])
        smaller = tuple(a for a, b in constraints if b == pos)
        keys.append((required, smaller))
    return keys, (0, 1) in constraints


def compile_pattern_set(patterns: Sequence[Pattern],
                        induced: bool = True,
                        stats: Optional[GraphStats] = None
                        ) -> PatternSetPlan:
    """Compile a set of same-size unlabeled patterns into one shared trie.

    Per pattern, every legal matching order is considered (connected
    prefixes only); orders are chosen greedily, in input order, to
    maximize the prefix shared with the trie built so far — "reordering
    individual matching orders where legal".  Each order's
    symmetry-breaking constraints come from the stabilizer chain of its
    *conjugated* automorphism group, so any choice counts each match
    exactly once; sharing therefore never trades correctness.  With
    ``stats``, ties between equally-sharing orders break by the
    input-aware cost model (:func:`_order_cost`) instead of
    lexicographically — sharing stays primary (the trie's whole point),
    cost picks among the equally-shared.

    The level-0 worklist stays undirected (``src < dst``) whenever every
    pattern admits an order whose first two positions are automorphism-
    exchangeable (the ``v0 < v1`` constraint is then structural); one
    asymmetric pattern switches the whole set to the directed worklist,
    and symmetric branches regain exactness through an explicit
    ``first_pair`` check at the first extension level.

    Duplicate patterns (isomorphic specs) are deduplicated keeping first
    occurrence; labeled patterns and mixed vertex counts are rejected.
    """
    pats = list(patterns)
    if not pats:
        raise ValueError("pattern set is empty")
    slot_by_code: dict[int, int] = {}
    deduped: list[Pattern] = []
    dedup_slot: list[int] = []
    for p in pats:
        p.validate()
        if p.labels is not None:
            raise ValueError(
                f"pattern {p.name!r} is labeled: pattern sets compile to "
                "elementwise kernel predicates, which cannot gather "
                "ctx.labels — mine labeled patterns individually via "
                "pattern_app")
        code = p.canonical_code()
        if code not in slot_by_code:
            slot_by_code[code] = len(deduped)
            deduped.append(p)
        dedup_slot.append(slot_by_code[code])
    ks = {p.k for p in deduped}
    if len(ks) != 1:
        raise ValueError(
            f"pattern set mixes vertex counts {sorted(ks)}: all patterns "
            "of a set must have the same size (the shared level loop "
            "extends every branch in lock step)")
    if len(deduped) > MAX_SET_BRANCHES:
        raise ValueError(
            f"pattern set has {len(deduped)} patterns; the branch bitmap "
            f"is one i32 per embedding, so sets are capped at "
            f"{MAX_SET_BRANCHES}")
    k = deduped[0].k

    # candidate orders per pattern: (keys, first_pair), deduplicated
    per_pattern = []
    for p in deduped:
        adj = p.adjacency()
        auts = p.automorphisms()
        cands, seen = [], set()
        for order in _valid_orders(p):
            keys, fp = _order_keys(adj, auts, order)
            sig = (tuple(keys), fp)
            if sig not in seen:
                seen.add(sig)
                cands.append((keys, fp))
        per_pattern.append(cands)

    directed = any(not any(fp for _, fp in cands) for cands in per_pattern)
    if not directed:   # undirected worklist: symmetric-first orders only
        per_pattern = [[c for c in cands if c[1]] for cands in per_pattern]

    n_levels = k - 2
    nodes: list[dict] = [{} for _ in range(n_levels)]
    branches: list[list[SetBranch]] = [[] for _ in range(n_levels)]

    def full_keys(keys, fp):
        """Fold the first-pair check into the level-2 key (directed only:
        an undirected worklist enforces v0 < v1 structurally)."""
        out = []
        for i, (required, smaller) in enumerate(keys):
            pc = bool(directed and fp) if i == 0 else False
            out.append((required, smaller, pc))
        return tuple(out)

    def prefix_len(keys):
        parent, depth = 0, 0
        for i, key in enumerate(keys):
            nxt = nodes[i].get((parent, key))
            if nxt is None:
                break
            parent, depth = nxt, depth + 1
        return depth

    leaves_by_node: dict[int, int] = {}
    for pid, cands in enumerate(per_pattern):
        scored = [full_keys(keys, fp) for keys, fp in cands]
        if stats is None:
            best = min(scored, key=lambda fk: (-prefix_len(fk), fk))
        else:
            best = min(scored, key=lambda fk: (
                -prefix_len(fk),
                _order_cost([(r, s) for r, s, _pc in fk], stats,
                            first_pair_symmetric=not directed),
                fk))
        parent = 0
        for i, key in enumerate(best):
            node = nodes[i].get((parent, key))
            if node is None:
                required, smaller, pc = key
                non_adj = tuple(j for j in range(i + 2)
                                if j not in required)
                node = len(branches[i])
                if node >= MAX_SET_BRANCHES:
                    raise ValueError(
                        f"trie level {i + 2} exceeds {MAX_SET_BRANCHES} "
                        "branches (the i32 bitmap budget)")
                nodes[i][(parent, key)] = node
                branches[i].append(SetBranch(
                    position=i + 2, parent=parent, anchor=max(required),
                    required=required,
                    forbidden=non_adj if induced else (),
                    distinct=non_adj, smaller=smaller, first_pair=pc))
            parent = node
        if parent in leaves_by_node:
            raise RuntimeError(
                f"patterns {leaves_by_node[parent]} and {pid} compiled to "
                "identical matching-order chains — dedupe should have "
                "caught isomorphic inputs")
        leaves_by_node[parent] = pid

    leaves = tuple(leaves_by_node[i] for i in range(len(branches[-1])))
    return PatternSetPlan(
        patterns=tuple(deduped), k=k, induced=induced, directed=directed,
        levels=tuple(tuple(b) for b in branches), leaves=leaves,
        n_nodes=sum(len(b) for b in branches),
        dedup_slot=tuple(dedup_slot), cost_model=stats is not None)
