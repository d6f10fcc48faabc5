"""Execution engine, vertex half (paper Alg. 1; counterpart of
``repro.core.engine``).

There is one level loop, :func:`run_level_loop`, and a capacity policy
decides how each level's static capacities are obtained: the cold
:meth:`Miner.run` inspects every level on the host (``HostCapPolicy``) and
records a :class:`~repro_torch.core.plan.MiningPlan`; later runs replay it
(``PlanCapPolicy``) through :class:`~repro_torch.core.plan.MiningExecutor`
without a host read until the end.  Every phase op resolves through the
backend registry (:mod:`repro_torch.core.phases`).

Not ported yet: edge-induced mining, edge blocks, the sampled estimator and
the plan cache, reduce hooks, and the observability spans and metrics of
``repro.obs``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import torch

from repro_torch.core.api import GraphCtx, MiningApp, make_ctx
from repro_torch.core.embedding_list import (EmbeddingLevel,
                                             init_level0_vertex, materialize,
                                             total_bytes)
from repro_torch.core.phases import BackendSpec, get_backend
from repro_torch.core.plan import HostCapPolicy, MiningExecutor, bucket_pow2
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.dag import orient_dag


@dataclasses.dataclass
class LevelStats:
    level: int
    n_candidates: int
    n_embeddings: int
    capacity: int
    bytes: int
    seconds: float
    live_bytes: int = 0       # embedding list + materialised frontier


@dataclasses.dataclass
class MineResult:
    count: int
    stats: list[LevelStats] = dataclasses.field(default_factory=list)
    levels: Optional[list[EmbeddingLevel]] = None


class _PhaseOps:
    """Backend phase ops bound to one (ctx, app, backend) triple."""

    def __init__(self, ctx: GraphCtx, app: MiningApp, backend,
                 fuse_filter: bool = True):
        if app.kind != "vertex":
            raise NotImplementedError(
                f"app {app.name!r}: edge-induced mining is not ported yet")
        self.ctx, self.app, self.backend = ctx, app, backend
        self.fuse_filter = fuse_filter

    def inspect(self, emb, n, st, *, cand_cap):
        return self.backend.inspect_vertex(self.ctx, self.app, emb, n, st,
                                           cand_cap)

    def bound(self, emb, n, st):
        return self.backend.candidate_bound_vertex(self.ctx, self.app, emb,
                                                   n, st)

    def extend(self, emb, n, st, *, cand_cap, out_cap):
        # fused extend + filter + compaction with counts: the one
        # enumeration per level (no separate inspection on replay)
        return self.backend.extend_pruned(self.ctx, self.app, emb, n, st,
                                          cand_cap, out_cap,
                                          fuse_filter=self.fuse_filter)


class _VertexPipeline:
    """Vertex-induced frontier: emb matrix + memo state."""

    def __init__(self, ops: _PhaseOps, src, dst, n0):
        self.ops = ops
        if ops.app.needs_reduce:
            raise NotImplementedError(
                f"app {ops.app.name!r}: the reduce phase is not ported yet")
        self.levels = init_level0_vertex(src, dst, n0)
        self.emb = materialize(self.levels)
        self.n = self.levels[0].n
        self.state = torch.zeros(self.emb.shape[:1], dtype=torch.int32,
                                 device=self.emb.device)

    def level_range(self):
        return range(2, self.ops.app.max_size)

    def frontier_nbytes(self) -> int:
        return self.emb.numel() * self.emb.element_size()

    def bound(self):
        return self.ops.bound(self.emb, self.n, self.state)

    def inspect(self, cand_cap: int):
        return self.ops.inspect(self.emb, self.n, self.state,
                                cand_cap=cand_cap)

    def extend(self, cand_cap: int, out_cap: int):
        new_level, self.emb, n_cand = self.ops.extend(
            self.emb, self.n, self.state, cand_cap=cand_cap,
            out_cap=out_cap)
        self.levels.append(new_level)
        self.n = new_level.n
        return n_cand, new_level.n

    def reduce_filter(self, level: int, policy):
        # no reduce hooks yet; apps carry no memo state between levels
        self.state = torch.zeros(self.emb.shape[:1], dtype=torch.int32,
                                 device=self.emb.device)

    def result(self, stats) -> MineResult:
        return MineResult(count=int(self.n), stats=stats, levels=self.levels)


def run_level_loop(pipe, policy, collect_stats: bool = False
                   ) -> list[LevelStats]:
    """Drive a pipeline through all levels under a capacity policy.

    With a ``HostCapPolicy`` this is the host driver and ``collect_stats``
    is honoured; with a ``PlanCapPolicy`` the loop reads nothing from the
    device, so it must be off.
    """
    stats: list[LevelStats] = []
    if policy.traceable and collect_stats:
        raise ValueError("per-level stats need the host policy")

    def record(level, n_cand, t0):
        last = pipe.levels[-1]
        if last.vid.is_cuda:
            torch.cuda.synchronize(last.vid.device)
        nbytes = total_bytes(pipe.levels)
        stats.append(LevelStats(level, n_cand, int(last.n), last.capacity,
                                nbytes, time.perf_counter() - t0,
                                nbytes + pipe.frontier_nbytes()))

    for level in pipe.level_range():
        t0 = time.perf_counter()
        cand_cap, out_cap = policy.extend_caps(pipe)
        n_cand, n_surv = pipe.extend(cand_cap, out_cap)
        policy.note_extend(n_cand, n_surv, cand_cap, out_cap)
        pipe.reduce_filter(level, policy)
        if collect_stats:
            record(level, int(n_cand), t0)
    return stats


class Miner:
    """Host-driver mining engine for one (graph, app, backend) triple.

    The first :meth:`run` is the host inspection pass and records a
    :class:`~repro_torch.core.plan.MiningPlan`; later runs replay it
    through one :class:`~repro_torch.core.plan.MiningExecutor`, reading
    the device once per run.  ``device=None`` runs on the CUDA device and
    raises when there is none; pass ``device="cpu"`` for the host.
    ``backend=None`` is the ``cuda`` backend.
    """

    def __init__(self, graph: CSRGraph, app: MiningApp,
                 fuse_filter: bool = True, backend: BackendSpec = None,
                 pack_max_bytes: int = 4 << 20, device: DeviceSpec = None):
        self.device = resolve_device(device)
        self.app = app
        self.backend = get_backend(backend)
        graph = graph.to(self.device)
        g = orient_dag(graph) if app.use_dag else graph
        self.graph = g
        self.ctx = make_ctx(g, pack_max_bytes=pack_max_bytes)
        self.fuse_filter = fuse_filter
        self.ops = _PhaseOps(self.ctx, app, self.backend,
                             fuse_filter=fuse_filter)
        self._executors: dict[int, MiningExecutor] = {}
        self._digest: Optional[str] = None
        self._edges: Optional[tuple[torch.Tensor, torch.Tensor]] = None

    def graph_digest(self) -> str:
        """Stable fingerprint of the (oriented) CSR arrays; the same bytes
        as the JAX package hashes, so both compute the same digest."""
        if self._digest is None:
            h = hashlib.sha1()
            h.update(self.graph.row_ptr.cpu().numpy().tobytes())
            h.update(self.graph.col_idx.cpu().numpy().tobytes())
            self._digest = h.hexdigest()[:16]
        return self._digest

    def executor(self, cap0: int) -> MiningExecutor:
        """The (cached) executor for level-0 capacity ``cap0``."""
        ex = self._executors.get(cap0)
        if ex is None:
            ex = MiningExecutor(self, cap0)
            self._executors[cap0] = ex
        return ex

    def init_edges(self):
        """Level-0 worklist: DAG edges (directed) or undirected src < dst.

        Built once per Miner (it reads the graph's degrees on the host), so
        a warm run reads nothing from the device before its replay.
        """
        if self._edges is None:
            if self.app.use_dag or self.app.directed_worklist:
                self._edges = self.graph.edge_list()
            else:
                self._edges = self.graph.undirected_edge_list()
        return self._edges

    def run(self, collect_stats: bool = False, plan_source: str = "inspect",
            block_size: Optional[int] = None) -> MineResult:
        """Mine the graph.  A cold run inspects every level (the paper's
        inspection-execution) and records the plan; a warm run replays it.
        ``collect_stats`` forces the host path.  Blocks and the
        ``estimate`` and ``cache`` plan sources are not ported yet and
        raise."""
        if plan_source != "inspect":
            raise NotImplementedError(
                f"plan_source={plan_source!r} is not ported yet")
        if block_size:
            raise NotImplementedError("edge blocks are not ported yet")
        src, dst = self.init_edges()
        m = int(src.shape[0])
        cap0 = bucket_pow2(m)
        ex = self.executor(cap0)
        if collect_stats or not ex.has_plan:
            pipe = _VertexPipeline(self.ops, src, dst, m)
            policy = HostCapPolicy()
            stats = run_level_loop(pipe, policy, collect_stats)
            ex.adopt_plan(policy.caps)
            return pipe.result(stats)
        pad = cap0 - m
        src = torch.nn.functional.pad(src, (0, pad))
        dst = torch.nn.functional.pad(dst, (0, pad))
        return MineResult(count=ex.execute(src, dst, m))
