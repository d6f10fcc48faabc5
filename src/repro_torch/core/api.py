"""Pangolin programming interface (paper §3.2; counterpart of
``repro.core.api``).

A :class:`MiningApp` carries the paper's hooks as vectorised callables
over embedding batches.  :class:`GraphCtx` packages the graph tensors and
the static search parameters the hooks consume.

The fused backends of the JAX package trace the app's elementwise
``to_add_kernel`` callable into the extend kernel.  A Python callable
cannot be traced into CUDA C++, so the port adds representations a kernel
can read, one per kind of predicate the JAX apps trace:

  * :class:`PredicateSpec` — a conjunction of slot bitmasks (the clique
    rules, and a compiled pattern's per-level rules with forbidden slots
    and, for a labeled pattern, label equations);
  * :class:`CanonicalSpec` — the default automorphism-canonical test
    (``is_auto_canonical_kernel``) of apps with no ``toAdd`` hook;
  * :class:`BranchSetSpec` — a pattern-set trie level: up to 32 branches,
    whose i32 bitmap is both the predicate (any bit set) and the new
    state column (``update_state_kernel``).

The plain backend evaluates a spec on tensors (``spec.__call__``), and the
CUDA kernels read its fields (``spec.words()``), so both agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.graph.csr import (CSRGraph, PackedGraph, pack_adjacency,
                                   packed_contains)
from repro_torch.sparse.intersect import adj_contains


@dataclasses.dataclass(frozen=True)
class GraphCtx:
    """Device-side graph context threaded through all hooks."""

    row_ptr: torch.Tensor          # int32[n+1]
    col_idx: torch.Tensor          # int32[m]
    labels: Optional[torch.Tensor]  # int32[n] or None
    n_vertices: int
    n_edges: int
    n_steps: int                   # binary search depth, ceil log2 max degree
    packed: Optional[PackedGraph] = None   # full bit-packed adjacency
    n_labels: int = 1
    # edge-induced support: undirected edge ids
    edge_uid: Optional[torch.Tensor] = None   # int32[m] uid per directed edge
    usrc: Optional[torch.Tensor] = None       # int32[m/2] endpoints per uid
    udst: Optional[torch.Tensor] = None
    n_uedges: int = 0

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def is_connected(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Listing 2 ``isConnected``: is v in N(u)?  One bit test with the
        full pack, else a CSR binary search."""
        if self.packed is not None:
            if not self.packed.full:
                raise NotImplementedError("partial packs are not ported yet")
            return packed_contains(self.packed, u, v)
        return adj_contains(self.row_ptr, self.col_idx, u, v, self.n_steps)

    def degree(self, v: torch.Tensor) -> torch.Tensor:
        v = v.clamp(0, self.n_vertices - 1).long()
        return self.row_ptr[v + 1] - self.row_ptr[v]


def make_ctx(g: CSRGraph, pack_max_bytes: int = 4 << 20,
             with_edge_uids: bool = False) -> GraphCtx:
    """GraphCtx from a CSR graph (host-side preprocessing).

    Attaches the full bit-packed adjacency when every row fits under
    ``pack_max_bytes``, and no pack otherwise (connectivity then binary
    searches the CSR; ``pack_max_bytes=0`` forces that) — the JAX default.
    The opt-in partial and core packs are not ported yet.
    ``with_edge_uids`` builds the undirected edge-id table of the
    edge-induced pipeline, on the host with int64 keys, as JAX does.
    """
    n_steps = max(1, math.ceil(math.log2(max(g.max_degree, 1) + 1)))
    n_labels = (int(g.labels.max().item()) + 1
                if g.labels is not None and g.n_vertices else 1)
    edge_uid = usrc = udst = None
    n_uedges = 0
    if with_edge_uids:
        src, dst = (t.cpu().numpy() for t in g.edge_list())
        lo = np.minimum(src, dst).astype(np.int64)
        hi = np.maximum(src, dst).astype(np.int64)
        key = lo * np.int64(g.n_vertices) + hi
        uniq, inv = np.unique(key, return_inverse=True)
        dev = g.device
        edge_uid = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(dev)
        usrc = torch.from_numpy((uniq // g.n_vertices).astype(np.int32)).to(
            dev)
        udst = torch.from_numpy((uniq % g.n_vertices).astype(np.int32)).to(
            dev)
        n_uedges = int(uniq.shape[0])
    packed = None
    n_words = -(-max(g.n_vertices, 1) // 32)
    if g.n_vertices * n_words * 4 <= pack_max_bytes:
        packed = pack_adjacency(g, max_bytes=pack_max_bytes)
    return GraphCtx(row_ptr=g.row_ptr, col_idx=g.col_idx, labels=g.labels,
                    n_vertices=g.n_vertices, n_edges=g.n_edges,
                    n_steps=n_steps, packed=packed, n_labels=n_labels,
                    edge_uid=edge_uid, usrc=usrc, udst=udst,
                    n_uedges=n_uedges)


# ---------------------------------------------------------------------------
# Default canonicality test (Listing 2 ``isAutoCanonical``)


def is_auto_canonical_vertex(ctx: GraphCtx, emb: torch.Tensor,
                             u: torch.Tensor,
                             src_slot: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Vertex-induced automorphism-canonical extension test.

    emb: int32[N, k] parent vertices; u: int32[N] candidates; src_slot:
    int32[N] the embedding position that generated u.  Accept iff
    u > v_0, u is not in emb, u was extended from the first embedding
    vertex it is adjacent to, and u exceeds every vertex after that one.
    """
    k = emb.shape[1]
    ok = u > emb[:, 0]
    found = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for j in range(k):
        adj = ctx.is_connected(u, emb[:, j])
        ok = ok & ~(found & (u < emb[:, j]))
        found = found | adj
        ok = ok & (u != emb[:, j])
        if src_slot is not None:
            ok = ok & ~(adj & (j < src_slot))
    return ok & found


def is_auto_canonical_edge(ctx: GraphCtx, eids: torch.Tensor,
                           new_eid: torch.Tensor, new_src: torch.Tensor,
                           new_dst: torch.Tensor, e_src: torch.Tensor,
                           e_dst: torch.Tensor) -> torch.Tensor:
    """Edge-induced canonical extension test over undirected edge ids.

    eids: int32[N, E] existing edge uids (extension order); new_eid:
    int32[N]; (new_src, new_dst): endpoints of the candidate; (e_src,
    e_dst): int32[N, E] endpoints of the existing edges.  The rule of the
    vertex case, with "neighbour" = shares an endpoint.
    """
    E = eids.shape[1]
    ok = new_eid > eids[:, 0]
    found = torch.zeros(new_eid.shape, dtype=torch.bool,
                        device=new_eid.device)
    for j in range(E):
        shares = ((new_src == e_src[:, j]) | (new_src == e_dst[:, j])
                  | (new_dst == e_src[:, j]) | (new_dst == e_dst[:, j]))
        ok = ok & ~(found & (new_eid < eids[:, j]))
        found = found | shares
        ok = ok & (new_eid != eids[:, j])
    return ok & found


def is_auto_canonical_vertex_bits(emb: torch.Tensor, u: torch.Tensor,
                                  conn: torch.Tensor,
                                  src_slot: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Connectivity-bit variant of :func:`is_auto_canonical_vertex`:
    ``conn[:, j]`` holds the adjacency of candidate u to embedding vertex j
    (as an extend kernel emits it).  Assumes symmetric adjacency."""
    k = emb.shape[1]
    return is_auto_canonical_kernel(tuple(emb[:, j] for j in range(k)), u,
                                    src_slot, None,
                                    tuple(conn[:, j] for j in range(k)))


def is_auto_canonical_kernel(emb_cols, u, src_slot, state, conn):
    """Elementwise automorphism-canonical test (the ``to_add_kernel`` form
    of :func:`is_auto_canonical_vertex_bits`): ``emb_cols`` and ``conn`` are
    length-k tuples of tensors.  Assumes symmetric adjacency."""
    k = len(emb_cols)
    ok = u > emb_cols[0]
    found = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for j in range(k):
        adj = conn[j]
        ok = ok & ~(found & (u < emb_cols[j]))
        found = found | adj
        ok = ok & (u != emb_cols[j])
        if src_slot is not None:
            ok = ok & ~(adj & (j < src_slot))
    return ok & found


# ---------------------------------------------------------------------------
# The kernel-readable predicates
#
# Each spec evaluates elementwise on tensors, as a JAX ``to_add_kernel``
# does: ``spec(emb_cols, u, src_slot, state, conn[, lab_cols, lab_u])``
# with ``emb_cols``/``conn`` length-k tuples, and encodes itself for the
# kernels as a flat list of int32 words (``words()``): the kind, then its
# fields.  ``KINDS`` is the kernels' numbering.

KINDS = {"clique": 0, "conjunction": 1, "canonical": 2, "branches": 3}


def _bits(slots: Sequence[int]) -> int:
    out = 0
    for j in slots:
        out |= 1 << int(j)
    return out


@dataclasses.dataclass(frozen=True)
class PredicateSpec:
    """A conjunction of slot terms, the rules of a clique or of one level
    of a compiled pattern.

    For a candidate ``u`` extending a parent with vertices ``emb_j``
    (j < k) and connectivity bits ``conn_j`` (u in N(emb_j)), the
    predicate is the conjunction of

      * ``u >= 0`` (a real vertex),
      * ``conn_j`` for every bit j of ``required``,
      * ``not conn_j`` for every bit j of ``forbidden`` (induced matching),
      * ``u != emb_j`` for every bit j of ``distinct``,
      * ``u > emb_j`` for every bit j of ``greater``,
      * ``src_slot == src_slot_eq`` when ``src_slot_eq >= 0``,
      * ``label(u) == label`` when ``label >= 0`` (a labeled pattern), and
        ``label(emb_0), label(emb_1) == first_labels`` when that is set
        (its first extension, which doubles as the level-0 label filter).

    With no forbidden slot and no label the kind is ``clique`` (the rules
    of ``repro.core.apps.cf``, which :func:`~repro_torch.core.apps.cf.
    make_cf_app` fills in), else ``conjunction``.
    """

    required: int = 0
    distinct: int = 0
    greater: int = 0
    src_slot_eq: int = -1
    forbidden: int = 0
    label: int = -1
    first_labels: Optional[tuple[int, int]] = None

    @property
    def needs_labels(self) -> bool:
        return self.label >= 0 or self.first_labels is not None

    @property
    def kind(self) -> str:
        return ("conjunction" if self.forbidden or self.needs_labels
                else "clique")

    @property
    def writes_state(self) -> bool:
        return False

    def words(self) -> list[int]:
        lab0, lab1 = self.first_labels or (-1, -1)
        return [KINDS[self.kind], int(self.needs_labels), self.required,
                self.forbidden, self.distinct, self.greater,
                self.src_slot_eq, self.label, lab0, lab1]

    def __call__(self, emb_cols: Sequence[torch.Tensor], u: torch.Tensor,
                 src_slot: torch.Tensor, state: Optional[torch.Tensor],
                 conn: Sequence[torch.Tensor], lab_cols=None,
                 lab_u=None) -> torch.Tensor:
        """Evaluate elementwise on tensors (the ``to_add_kernel`` form)."""
        ok = u >= 0
        if self.label >= 0:
            ok = ok & (lab_u == self.label)
        if self.first_labels is not None:
            ok = ok & (lab_cols[0] == self.first_labels[0]) \
                & (lab_cols[1] == self.first_labels[1])
        for j in range(len(emb_cols)):
            if self.required >> j & 1:
                ok = ok & conn[j]
            if self.forbidden >> j & 1:
                ok = ok & ~conn[j]
            if self.distinct >> j & 1:
                ok = ok & (u != emb_cols[j])
            if self.greater >> j & 1:
                ok = ok & (u > emb_cols[j])
        if self.src_slot_eq >= 0:
            ok = ok & (src_slot == self.src_slot_eq)
        return ok


@dataclasses.dataclass(frozen=True)
class CanonicalSpec:
    """The default automorphism-canonical test,
    :func:`is_auto_canonical_kernel`, as a kernel-readable spec: it reads
    the connectivity bit of every slot, in slot order."""

    needs_labels = False
    kind = "canonical"
    writes_state = False

    def words(self) -> list[int]:
        return [KINDS["canonical"], 0]

    def __call__(self, emb_cols, u, src_slot, state, conn, lab_cols=None,
                 lab_u=None) -> torch.Tensor:
        return is_auto_canonical_kernel(emb_cols, u, src_slot, state, conn)


CANONICAL = CanonicalSpec()

# A trie level's branch bitmap is one i32 state word.
MAX_BRANCHES = 32


@dataclasses.dataclass(frozen=True)
class Branch:
    """One trie branch of a :class:`BranchSetSpec`, its slot sets as
    bitmasks: the candidate extends it iff the parent's state carries bit
    ``parent``, the candidate came from slot ``anchor``, every ``required``
    slot is adjacent, no ``forbidden`` one is, ``u`` differs from every
    ``distinct`` slot and exceeds every ``smaller`` one, and, with
    ``first_pair``, ``emb_0 < emb_1``."""

    parent: int
    anchor: int
    required: int = 0
    forbidden: int = 0
    distinct: int = 0
    smaller: int = 0
    first_pair: bool = False

    @classmethod
    def from_set_branch(cls, br) -> "Branch":
        """From a compiled :class:`~repro_torch.core.patterns.SetBranch`."""
        return cls(parent=br.parent, anchor=br.anchor,
                   required=_bits(br.required),
                   forbidden=_bits(br.forbidden),
                   distinct=_bits(br.distinct), smaller=_bits(br.smaller),
                   first_pair=bool(br.first_pair))


@dataclasses.dataclass(frozen=True)
class BranchSetSpec:
    """One level of a pattern-set trie (``make_set_branch_bits`` of the
    JAX package): :meth:`bits` is the i32 bitmap whose bit b is set iff the
    candidate extends branch b; the predicate is ``bits != 0``, and the
    bitmap is the new embedding's state (the app's ``update_state_kernel``
    is this spec's :meth:`bits`)."""

    branches: tuple[Branch, ...]

    needs_labels = False
    kind = "branches"
    writes_state = True

    def __post_init__(self):
        if not 1 <= len(self.branches) <= MAX_BRANCHES:
            raise ValueError(f"{len(self.branches)} branches; a level holds "
                             f"1 to {MAX_BRANCHES}")

    def words(self) -> list[int]:
        out = [KINDS["branches"], 0, len(self.branches)]
        for br in self.branches:
            out += [br.parent, br.anchor, br.required, br.forbidden,
                    br.distinct, br.smaller, int(br.first_pair)]
        return out

    def bits(self, emb_cols, u, src_slot, state, conn) -> torch.Tensor:
        out = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        base = u >= 0
        for b, br in enumerate(self.branches):
            ok = base & (((state >> br.parent) & 1) == 1)
            ok = ok & (src_slot == br.anchor)
            for j in range(len(emb_cols)):
                if br.required >> j & 1:
                    ok = ok & conn[j]
                if br.forbidden >> j & 1:
                    ok = ok & ~conn[j]
                if br.distinct >> j & 1:
                    ok = ok & (u != emb_cols[j])
                if br.smaller >> j & 1:
                    ok = ok & (u > emb_cols[j])
            if br.first_pair:
                ok = ok & (emb_cols[0] < emb_cols[1])
            out = out | (ok.to(torch.int32) << b)
        return out

    def __call__(self, emb_cols, u, src_slot, state, conn, lab_cols=None,
                 lab_u=None) -> torch.Tensor:
        return self.bits(emb_cols, u, src_slot, state, conn) != 0


def spec_state_update(spec, upd) -> bool:
    """Whether state update ``upd`` is ``spec``'s own bitmap (the only
    state update the kernels compute)."""
    return (isinstance(spec, BranchSetSpec)
            and getattr(upd, "__self__", None) is spec
            and getattr(upd, "__func__", None) is BranchSetSpec.bits)


def _per_level(app: "MiningApp", field: str, seq, k: Optional[int]):
    if k is None:
        raise ValueError(f"app {app.name!r} has a per-level {field}; callers "
                         "must pass the parent embedding width k")
    idx = k - 2
    if not 0 <= idx < len(seq):
        raise ValueError(f"app {app.name!r}: no {field} entry for level "
                         f"k={k} ({len(seq)} per-level entries)")
    return seq[idx]


def resolve_kernel_predicate(app: "MiningApp", k: Optional[int] = None):
    """The eager in-kernel ``toAdd`` predicate of ``app`` for parent width
    ``k``, or None when the app has none.

    ``app.to_add_spec`` holds one spec per level, indexed by ``k - 2`` like
    a per-level JAX ``to_add_kernel``.  An app with no ``toAdd`` hook at all
    (and no DAG, whose oriented adjacency the bits cannot stand in for)
    gets the canonical test, :data:`CANONICAL`, as in JAX.
    """
    if app.kind != "vertex":
        return None
    if app.to_add_spec is not None:
        return _per_level(app, "to_add_spec", app.to_add_spec, k)
    if app.to_add is None and app.to_add_bits is None and not app.use_dag:
        return CANONICAL
    return None


def resolve_state_kernel(app: "MiningApp", k: Optional[int] = None):
    """The eager in-kernel state update of ``app`` for parent width ``k``
    (``fn(emb_cols, u, src_slot, state, conn) -> i32``, the new embedding's
    state), or None; a per-level sequence is indexed by ``k - 2``."""
    usk = app.update_state_kernel
    if usk is None or app.kind != "vertex":
        return None
    if callable(usk):
        return usk
    return _per_level(app, "update_state_kernel", usk, k)


# ---------------------------------------------------------------------------
# Application definition


@dataclasses.dataclass(frozen=True)
class MiningApp:
    """One graph-mining application (paper Listing 1).

    Hook signatures (vectorised; N = candidate or embedding batch):
      to_extend(ctx, emb[N,k])                           -> bool[N,k]
      to_extend_state(ctx, emb[N,k], state[N])           -> bool[N,k]
      to_add(ctx, emb[N,k], u[N], src_slot[N], state[N]) -> bool[N]
      to_add_vertex_mask(ctx)                            -> bool[n_vertices]
      get_pattern(ctx, emb[N,k], state[N], valid[N])     -> (pat[N], state)
      state_histogram(state[N], valid[N])                -> p_map[max_patterns]
      init_state(ctx, emb[N,2], n)                       -> state[N]
    ``to_add_spec`` is the kernel-readable form of the eager ``toAdd``,
    one spec per level (:class:`PredicateSpec`, :class:`CanonicalSpec` or
    :class:`BranchSetSpec`).  ``update_state_kernel`` is the state update
    (``fn(emb_cols, u, src_slot, state, conn) -> i32``, one per level); the
    kernels compute only a branch set's own bitmap
    (``BranchSetSpec.bits``).  ``to_extend_state`` takes precedence over
    ``to_extend`` where the state column exists.  ``to_add_vertex_mask``
    is the edge pipeline's eager ``toAdd`` when it depends only on the
    candidate vertex (FSM's label-frequency prune).  ``state`` is the
    per-embedding memo slot (paper §4.2); it flows level to level.  The
    other fields are the capacity-plan identity and carry the JAX
    package's names and defaults, so a plan recorded by either package
    keys the same way.  ``backend`` is the app's preferred phase backend
    (``Miner(backend=...)`` overrides it).

    Edge-induced apps (``kind="edge"``) run with ``needs_filter``,
    ``support_mode="domain"`` and ``min_support`` (FSM).
    """

    name: str
    kind: str = "vertex"
    max_size: int = 3
    use_dag: bool = False
    needs_reduce: bool = False
    needs_filter: bool = False
    support_mode: str = "count"
    max_patterns: int = 8
    min_support: int = 0
    to_extend: Optional[Callable] = None
    to_extend_state: Optional[Callable] = None
    to_add: Optional[Callable] = None
    to_add_bits: Optional[Callable] = None
    to_add_spec: Optional[tuple] = None
    to_add_vertex_mask: Optional[Callable] = None
    update_state_kernel: Optional[Callable | tuple] = None
    state_histogram: Optional[Callable] = None
    get_pattern: Optional[Callable] = None
    init_state: Optional[Callable] = None
    backend: Optional[str] = None
    directed_worklist: bool = False
    plan_key: str = ""
