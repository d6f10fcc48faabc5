"""Pangolin programming interface (paper §3.2; counterpart of
``repro.core.api``).

A :class:`MiningApp` carries the paper's hooks as vectorised callables
over embedding batches.  :class:`GraphCtx` packages the graph tensors and
the static search parameters the hooks consume.

The fused backends of the JAX package trace the app's elementwise
``to_add_kernel`` callable into the extend kernel.  A Python callable
cannot be traced into CUDA C++, so the port adds one representation a
kernel can read: :class:`PredicateSpec`, a handful of slot bitmasks that
express the clique rules.  The plain backend evaluates the same spec on
tensors (``PredicateSpec.__call__``), and the CUDA kernels read its fields,
so both agree bit for bit.
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


# ---------------------------------------------------------------------------
# The kernel-readable predicate


@dataclasses.dataclass(frozen=True)
class PredicateSpec:
    """An eager ``toAdd`` predicate that a CUDA kernel can read.

    For a candidate ``u`` extending a parent with vertices ``emb_j``
    (j < k) and connectivity bits ``conn_j`` (u in N(emb_j)), the
    predicate is the conjunction of

      * ``u >= 0`` (a real vertex),
      * ``conn_j`` for every bit j of ``required``,
      * ``u != emb_j`` for every bit j of ``distinct``,
      * ``u > emb_j`` for every bit j of ``greater``,
      * ``src_slot == src_slot_eq`` when ``src_slot_eq >= 0``.

    That is exactly the rule set of the hand-written clique app
    (``repro.core.apps.cf``), which :func:`~repro_torch.core.apps.cf.
    make_cf_app` fills in.  The automorphism-canonical test is not a
    conjunction of such terms, so an app that needs it has no spec.
    """

    required: int = 0
    distinct: int = 0
    greater: int = 0
    src_slot_eq: int = -1

    def __call__(self, emb_cols: Sequence[torch.Tensor], u: torch.Tensor,
                 src_slot: torch.Tensor, state: torch.Tensor,
                 conn: Sequence[torch.Tensor]) -> torch.Tensor:
        """Evaluate elementwise on tensors (the ``to_add_kernel`` form)."""
        ok = u >= 0
        for j in range(len(emb_cols)):
            if self.required >> j & 1:
                ok = ok & conn[j]
            if self.distinct >> j & 1:
                ok = ok & (u != emb_cols[j])
            if self.greater >> j & 1:
                ok = ok & (u > emb_cols[j])
        if self.src_slot_eq >= 0:
            ok = ok & (src_slot == self.src_slot_eq)
        return ok


def resolve_kernel_predicate(app: "MiningApp", k: Optional[int] = None
                             ) -> Optional[PredicateSpec]:
    """The eager in-kernel ``toAdd`` predicate of ``app`` for parent width
    ``k``, or None when the app has none.

    ``app.to_add_spec`` holds one :class:`PredicateSpec` per level,
    indexed by ``k - 2`` like a per-level JAX ``to_add_kernel``.
    """
    if app.kind != "vertex" or app.to_add_spec is None:
        return None
    spec = app.to_add_spec
    if k is None:
        raise ValueError(f"app {app.name!r} has a per-level to_add_spec; "
                         "callers must pass the parent embedding width k")
    idx = k - 2
    if not 0 <= idx < len(spec):
        raise ValueError(f"app {app.name!r}: no to_add_spec entry for level "
                         f"k={k} ({len(spec)} per-level specs)")
    return spec[idx]


# ---------------------------------------------------------------------------
# Application definition


@dataclasses.dataclass(frozen=True)
class MiningApp:
    """One graph-mining application (paper Listing 1).

    Hook signatures (vectorised; N = candidate or embedding batch):
      to_extend(ctx, emb[N,k])                           -> bool[N,k]
      to_add(ctx, emb[N,k], u[N], src_slot[N], state[N]) -> bool[N]
      to_add_vertex_mask(ctx)                            -> bool[n_vertices]
    ``to_add_spec`` is the kernel-readable form of the eager ``toAdd``,
    one :class:`PredicateSpec` per level.  ``to_add_vertex_mask`` is the
    edge pipeline's eager ``toAdd`` when it depends only on the candidate
    vertex (FSM's label-frequency prune); the edge kernel gathers it per
    candidate.  The other fields are the capacity-plan identity and carry
    the JAX package's names and defaults, so a plan recorded by either
    package keys the same way.

    Edge-induced apps (``kind="edge"``) run with ``needs_filter``,
    ``support_mode="domain"`` and ``min_support`` (FSM).  Not ported yet:
    the count reduce of vertex apps (``needs_reduce``) and the state
    column (``update_state_kernel``); the engine and backends raise
    NotImplementedError for an app that asks for them.
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
    to_add: Optional[Callable] = None
    to_add_spec: Optional[tuple[PredicateSpec, ...]] = None
    to_add_vertex_mask: Optional[Callable] = None
    update_state_kernel: Optional[Callable] = None
    directed_worklist: bool = False
    plan_key: str = ""
