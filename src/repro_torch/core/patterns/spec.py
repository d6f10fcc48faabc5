"""Pattern specifications: what the user writes down to mine a pattern
(a copy of ``repro.core.patterns.spec``: the port imports nothing of the
JAX package, and its compiled plans must equal the JAX ones field for
field).

A :class:`Pattern` is a small undirected graph (edge list / adjacency,
optional vertex labels) given either programmatically
(``Pattern.clique(5)``, ``Pattern.from_edges([(0, 1), (1, 2)])``), as a
compact string (``Pattern.from_string("0-1,1-2,0-2")``), or by name from
the built-in library (``Pattern.named("diamond")``).  Patterns are pure
host-side objects — numpy + python ints, no jax — because everything
derived from them (matching order, symmetry-breaking constraints,
connectivity masks) is computed once at plan time by
:mod:`repro_torch.core.patterns.compile` and baked into kernel predicates.

The module also owns the exhaustive enumeration of connected k-vertex
graphs (:func:`enumerate_connected_codes` / :func:`n_connected_patterns`)
that gives motif counting a *derived* pattern-table bound instead of a
silent guess.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
from typing import Optional, Sequence

import numpy as np

__all__ = ["Pattern", "PATTERN_LIBRARY", "PATTERN_SETS", "pattern_names",
           "pattern_set_names", "named_pattern_set", "motif_patterns",
           "enumerate_connected_codes", "n_connected_patterns",
           "MAX_PATTERN_SIZE"]

# The compiler brute-forces automorphisms / canonical forms over k!
# permutations; 6! = 720 keeps plan-time trivial, 7! starts to hurt.
MAX_PATTERN_SIZE = 6


def _tri_bit(i: int, j: int, k: int) -> int:
    """Bit position of pair (i < j) in the upper-triangle packing
    (row-major over pairs — same layout as repro.core.pattern)."""
    return sum(k - 1 - r for r in range(i)) + (j - i - 1)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """An undirected, connected, loop-free pattern graph.

    Attributes:
      edges:  sorted tuple of (i, j) pairs with i < j
      k:      number of vertices (0..k-1, all of which must appear
              connected)
      labels: optional per-vertex label tuple (labeled matching)
      name:   display name (library name, or a generated one)
    """

    edges: tuple[tuple[int, int], ...]
    k: int
    labels: Optional[tuple[int, ...]] = None
    name: str = "pattern"

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_edges(edges: Sequence[Sequence[int]],
                   k: Optional[int] = None,
                   labels: Optional[Sequence[int]] = None,
                   name: Optional[str] = None) -> "Pattern":
        norm = set()
        hi = -1
        for e in edges:
            u, v = int(e[0]), int(e[1])
            if u == v:
                raise ValueError(f"pattern self-loop {u}-{v}")
            if u < 0 or v < 0:
                raise ValueError(f"negative pattern vertex in {u}-{v}")
            norm.add((min(u, v), max(u, v)))
            hi = max(hi, u, v)
        if not norm:
            raise ValueError("pattern needs at least one edge")
        kk = int(k) if k is not None else hi + 1
        if hi >= kk:
            raise ValueError(f"edge vertex {hi} >= k={kk}")
        lab = None if labels is None else tuple(int(x) for x in labels)
        if lab is not None and len(lab) != kk:
            raise ValueError(f"{len(lab)} labels for k={kk} vertices")
        p = Pattern(edges=tuple(sorted(norm)), k=kk, labels=lab,
                    name=name or f"pattern-{kk}v{len(norm)}e")
        p.validate()
        return p

    @staticmethod
    def from_string(spec: str, labels: Optional[Sequence[int]] = None,
                    name: Optional[str] = None) -> "Pattern":
        """Parse ``"0-1,1-2,0-2"`` (the ``--pattern-edges`` CLI syntax)."""
        edges = []
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            u, _, v = part.partition("-")
            edges.append((int(u), int(v)))
        return Pattern.from_edges(edges, labels=labels,
                                  name=name or f"edges:{spec}")

    @staticmethod
    def clique(k: int) -> "Pattern":
        return Pattern.from_edges(list(itertools.combinations(range(k), 2)),
                                  k=k, name=f"{k}-clique")

    @staticmethod
    def cycle(k: int) -> "Pattern":
        return Pattern.from_edges([(i, (i + 1) % k) for i in range(k)],
                                  k=k, name=f"{k}-cycle")

    @staticmethod
    def path(k: int) -> "Pattern":
        return Pattern.from_edges([(i, i + 1) for i in range(k - 1)],
                                  k=k, name=f"{k}-path")

    @staticmethod
    def star(k: int) -> "Pattern":
        """Star on k vertices: center 0, k-1 leaves."""
        return Pattern.from_edges([(0, i) for i in range(1, k)],
                                  k=k, name=f"{k}-star")

    @staticmethod
    def named(name: str) -> "Pattern":
        key = name.strip().lower().replace("_", "-")
        if key not in PATTERN_LIBRARY:
            raise KeyError(f"unknown pattern {name!r} "
                           f"(library: {', '.join(pattern_names())})")
        return PATTERN_LIBRARY[key]()

    # -- views --------------------------------------------------------------

    def adjacency(self) -> np.ndarray:
        adj = np.zeros((self.k, self.k), bool)
        for i, j in self.edges:
            adj[i, j] = adj[j, i] = True
        return adj

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def degrees(self) -> np.ndarray:
        return self.adjacency().sum(axis=1).astype(np.int64)

    def relabel(self, order: Sequence[int], name: Optional[str] = None
                ) -> "Pattern":
        """The same pattern with vertex ``order[i]`` renamed to ``i``."""
        inv = {int(v): i for i, v in enumerate(order)}
        edges = [(inv[i], inv[j]) for i, j in self.edges]
        labels = (None if self.labels is None
                  else [self.labels[v] for v in order])
        return Pattern.from_edges(edges, k=self.k, labels=labels,
                                  name=name or self.name)

    def validate(self) -> None:
        if self.k > MAX_PATTERN_SIZE:
            raise ValueError(
                f"pattern has {self.k} vertices; the compiler brute-forces "
                f"k! permutations and supports k <= {MAX_PATTERN_SIZE}")
        if self.k < 3:
            raise ValueError("patterns need >= 3 vertices (the engine's "
                             "level-0 worklist already enumerates edges)")
        if not self.is_connected():
            raise ValueError(f"pattern {self.name!r} is disconnected; "
                             "only connected patterns are minable")

    def is_connected(self) -> bool:
        adj = self.adjacency()
        seen = {0}
        frontier = [0]
        while frontier:
            v = frontier.pop()
            for u in np.flatnonzero(adj[v]):
                if int(u) not in seen:
                    seen.add(int(u))
                    frontier.append(int(u))
        return len(seen) == self.k

    # -- identity -----------------------------------------------------------

    def automorphisms(self) -> list[tuple[int, ...]]:
        """All vertex permutations preserving adjacency (and labels)."""
        adj = self.adjacency()
        out = []
        for perm in itertools.permutations(range(self.k)):
            if self.labels is not None and any(
                    self.labels[perm[i]] != self.labels[i]
                    for i in range(self.k)):
                continue
            if all(adj[perm[i], perm[j]] == adj[i, j]
                   for i in range(self.k) for j in range(i + 1, self.k)):
                out.append(perm)
        return out

    def canonical_code(self) -> int:
        """Isomorphism-invariant integer code (python int; exact).

        Minimum over all k! permutations of the (labels, adjacency)
        packing — two patterns are isomorphic (label-preservingly) iff
        their codes are equal.
        """
        adj = self.adjacency()
        n_labels = (max(self.labels) + 1) if self.labels else 1
        best = None
        for perm in itertools.permutations(range(self.k)):
            code = 0
            for i in range(self.k):
                for j in range(i + 1, self.k):
                    if adj[perm[i], perm[j]]:
                        code |= 1 << _tri_bit(i, j, self.k)
            if self.labels is not None:
                mult = 1 << (self.k * (self.k - 1) // 2)
                for i in range(self.k - 1, -1, -1):
                    code += self.labels[perm[i]] * mult
                    mult *= n_labels
            best = code if best is None else min(best, code)
        return best

    def hash_hex(self) -> str:
        """Stable isomorphism-invariant fingerprint (for plan signatures)."""
        ident = (self.k, self.canonical_code(),
                 tuple(sorted(self.labels)) if self.labels else None)
        return hashlib.sha1(repr(ident).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Named pattern library


def _house() -> Pattern:
    # square 0-1-2-3 plus roof apex 4 on the 0-3 wall
    return Pattern.from_edges([(0, 1), (1, 2), (2, 3), (0, 3), (0, 4),
                               (3, 4)], k=5, name="house")


def _diamond() -> Pattern:
    # 4-cycle plus one diagonal: two triangles sharing an edge
    return Pattern.from_edges([(0, 1), (0, 2), (1, 2), (0, 3), (1, 3)],
                              k=4, name="diamond")


def _tailed_triangle() -> Pattern:
    return Pattern.from_edges([(0, 1), (1, 2), (0, 2), (2, 3)], k=4,
                              name="tailed-triangle")


def _bowtie() -> Pattern:
    # two triangles sharing one vertex
    return Pattern.from_edges([(0, 1), (0, 2), (1, 2), (2, 3), (2, 4),
                               (3, 4)], k=5, name="bowtie")


PATTERN_LIBRARY: dict = {
    "triangle": lambda: Pattern.clique(3),
    "wedge": lambda: Pattern.path(3),
    "diamond": _diamond,
    "tailed-triangle": _tailed_triangle,
    "4-cycle": lambda: Pattern.cycle(4),
    "4-clique": lambda: Pattern.clique(4),
    "4-path": lambda: Pattern.path(4),
    "4-star": lambda: Pattern.star(4),
    "house": _house,
    "bowtie": _bowtie,
    "5-cycle": lambda: Pattern.cycle(5),
    "5-clique": lambda: Pattern.clique(5),
    "5-path": lambda: Pattern.path(5),
    "5-star": lambda: Pattern.star(5),
}


def pattern_names() -> list[str]:
    return sorted(PATTERN_LIBRARY)


# ---------------------------------------------------------------------------
# Enumeration of connected k-vertex graphs (the derived motif-table bound)


@functools.lru_cache(maxsize=None)
def enumerate_connected_codes(k: int) -> tuple[int, ...]:
    """Canonical codes of all connected unlabeled graphs on k vertices.

    Exhaustive over the 2^(k(k-1)/2) adjacency bitmasks, canonicalized by
    minimizing over all k! permutations and deduplicated — fully
    vectorized numpy, so even k = 6 (32768 graphs x 720 permutations)
    takes about a second, once, cached.  Raises for k beyond
    :data:`MAX_PATTERN_SIZE` — callers must fail loudly rather than guess.
    """
    if k < 1:
        raise ValueError(f"k={k} < 1")
    if k > MAX_PATTERN_SIZE:
        raise ValueError(
            f"cannot enumerate {k}-vertex patterns: exhaustive canonical "
            f"enumeration is implemented for k <= {MAX_PATTERN_SIZE} "
            f"(2^{k * (k - 1) // 2} graphs x {k}! permutations); pass an "
            f"explicit max_patterns bound instead")
    if k == 1:
        return (0,)
    n_pairs = k * (k - 1) // 2
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    codes = np.arange(1 << n_pairs, dtype=np.int64)

    # adjacency tensor [G, k, k] from the code bits
    adj = np.zeros((codes.shape[0], k, k), dtype=bool)
    for b, (i, j) in enumerate(pairs):
        bit = ((codes >> b) & 1).astype(bool)
        adj[:, i, j] = bit
        adj[:, j, i] = bit

    # connectivity: boolean transitive closure from vertex 0
    reach = adj[:, 0, :].copy()
    reach[:, 0] = True
    for _ in range(k - 1):
        reach = reach | (reach[:, :, None] & adj).any(axis=1)
    connected = reach.all(axis=1)

    # canonical form: min over permutations of the bit-permuted code
    best = codes.copy()
    for perm in itertools.permutations(range(k)):
        newc = np.zeros_like(codes)
        for b, (i, j) in enumerate(pairs):
            pi, pj = perm[i], perm[j]
            nb = _tri_bit(min(pi, pj), max(pi, pj), k)
            newc |= ((codes >> b) & 1) << nb
        np.minimum(best, newc, out=best)
    return tuple(int(c) for c in sorted(set(best[connected].tolist())))


def n_connected_patterns(k: int) -> int:
    """Number of non-isomorphic connected k-vertex graphs (1,1,2,6,21,112).

    This is the exact bound on distinct unlabeled k-motif patterns —
    derived by enumeration, never guessed.  Raises ``ValueError`` with a
    clear message beyond k = :data:`MAX_PATTERN_SIZE`.
    """
    return len(enumerate_connected_codes(k))


# The k = 3 / 4 motif orderings are pinned to the classifier enums of
# repro.core.pattern (WEDGE=0, TRIANGLE=1; PATH4..CLIQUE4 = 0..5) so the
# multi-pattern mc(k) path emits p_map in the same slot order as the
# memo/custom classifiers and the networkx oracle.
_MOTIF_ENUM_ORDER = {
    3: ("wedge", "triangle"),
    4: ("4-path", "4-star", "4-cycle", "tailed-triangle", "diamond",
        "4-clique"),
}


def _pattern_from_code(code: int, k: int) -> Pattern:
    """Decode an upper-triangle adjacency code back into a Pattern."""
    edges = [(i, j) for i in range(k) for j in range(i + 1, k)
             if (code >> _tri_bit(i, j, k)) & 1]
    return Pattern.from_edges(edges, k=k, name=f"{k}v-{code:#x}")


def motif_patterns(k: int) -> tuple[Pattern, ...]:
    """All connected k-vertex patterns, as Pattern specs.

    For k = 3 / 4 the tuple index equals the motif enum of
    :mod:`repro.core.pattern`; for larger k patterns come in canonical-
    code order (the :func:`enumerate_connected_codes` order).  This is
    the pattern set the multi-pattern mc(k) plan compiles.
    """
    if k in _MOTIF_ENUM_ORDER:
        pats = tuple(Pattern.named(n) for n in _MOTIF_ENUM_ORDER[k])
        assert len(pats) == n_connected_patterns(k)
        return pats
    return tuple(_pattern_from_code(c, k)
                 for c in enumerate_connected_codes(k))


# Named pattern sets for the CLI (`--pattern-set motifs4`).
PATTERN_SETS: dict = {
    "motifs3": lambda: motif_patterns(3),
    "motifs4": lambda: motif_patterns(4),
    "motifs5": lambda: motif_patterns(5),
}


def pattern_set_names() -> list[str]:
    return sorted(PATTERN_SETS)


def named_pattern_set(name: str) -> tuple[Pattern, ...]:
    key = name.strip().lower().replace("_", "-")
    if key not in PATTERN_SETS:
        raise KeyError(f"unknown pattern set {name!r} "
                       f"(sets: {', '.join(pattern_set_names())})")
    return PATTERN_SETS[key]()
