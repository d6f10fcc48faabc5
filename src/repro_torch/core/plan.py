"""Plan-once / execute-many, matching half (counterpart of
``repro.core.plan``).

* :class:`MiningPlan` — the per-level ``(cand_cap, out_cap)`` schedule (and
  for FSM the per-level filter capacities) and the identity it was planned
  for, read and written as JSON in the JAX
  package's schema, so a plan recorded by either package replays in the
  other (see :mod:`repro_torch.interop`).
* :class:`HostCapPolicy` — the paper's inspection-execution: per level,
  read the exact candidate and survivor counts from the device and record
  the capacities.  A cold run is the planning pass.
* :class:`PlanCapPolicy` — replay a plan with static capacities and no host
  read: the overflow flag stays a device tensor.
* :class:`MiningExecutor` — run the replay, read the count and the overflow
  flag from the device once at the end, and on overflow grow the plan and
  retry.

PyTorch runs eagerly, so there is no compiled program per plan; the sampled
estimator, the plan cache and plan transfer wait for a later slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np
import torch


def bucket_pow2(n: int, minimum: int = 128) -> int:
    """Round up to the next power of two."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def bucket_cap(n: int, quantum: int = 128, minimum: int = 128) -> int:
    """Survivor-scale capacity: round up to a multiple of ``quantum``."""
    n = max(int(n), minimum)
    return -(-n // quantum) * quantum


PLAN_SCHEMA = 4


class StalePlanError(ValueError):
    """A serialised plan from an incompatible schema."""


@dataclasses.dataclass(frozen=True)
class MiningPlan:
    """Static capacity schedule for one mining run.

    ``caps[i]`` is the ``(cand_cap, out_cap)`` pair of extension level
    ``i`` (paper level ``i + 2``).  The fields and their JSON are those of
    the JAX package's schema 4.
    """

    kind: str
    caps: tuple[tuple[int, int], ...]
    filter_caps: tuple[int, ...] = ()
    cap0: int = 0
    signature: str = ""
    source: str = "manual"
    app_key: str = ""
    profile: tuple[float, ...] = ()
    n_edges: int = 0
    transfer_key: str = ""

    def grown(self, factor: int = 2) -> "MiningPlan":
        """Overflow response: scale every capacity."""
        return dataclasses.replace(
            self,
            caps=tuple((c * factor, o * factor) for c, o in self.caps),
            filter_caps=tuple(f * factor for f in self.filter_caps),
            source="grown")

    def to_json(self) -> str:
        return json.dumps({
            "schema": PLAN_SCHEMA, "kind": self.kind, "cap0": self.cap0,
            "caps": [list(c) for c in self.caps],
            "filter_caps": list(self.filter_caps),
            "signature": self.signature, "source": self.source,
            "app_key": self.app_key, "profile": list(self.profile),
            "n_edges": self.n_edges, "transfer_key": self.transfer_key})

    @classmethod
    def from_json(cls, text: str) -> "MiningPlan":
        d = json.loads(text)
        schema = d.get("schema")
        if schema != PLAN_SCHEMA:
            raise StalePlanError(
                f"plan schema {schema!r} != current {PLAN_SCHEMA}")
        return cls(kind=d["kind"], cap0=int(d["cap0"]),
                   caps=tuple((int(c), int(o)) for c, o in d["caps"]),
                   filter_caps=tuple(int(f) for f in d["filter_caps"]),
                   signature=d.get("signature", ""),
                   source=d.get("source", "cache"),
                   app_key=d.get("app_key", ""),
                   profile=tuple(float(x) for x in d.get("profile", ())),
                   n_edges=int(d.get("n_edges", 0)),
                   transfer_key=d.get("transfer_key", ""))


def plan_app_key(app, backend_name: str, fuse_filter: bool = True,
                 compaction: str = "xla-scan") -> str:
    """App and backend identity without the graph (the JAX hash over the
    same fields, so equal inputs give equal keys in both packages)."""
    fields = (app.name, app.kind, app.max_size, app.use_dag,
              app.needs_reduce, app.needs_filter, app.support_mode,
              app.max_patterns, app.min_support, app.plan_key,
              app.directed_worklist, backend_name, bool(fuse_filter),
              str(compaction))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


def plan_transfer_key(app, fuse_filter: bool = True) -> str:
    """App identity without backend or compaction: capacities are counts
    every backend produces bit for bit, so plans whose transfer keys match
    are capacity-comparable across backends, and across the two packages."""
    fields = (app.name, app.kind, app.max_size, app.use_dag,
              app.needs_reduce, app.needs_filter, app.support_mode,
              app.max_patterns, app.min_support, app.plan_key,
              app.directed_worklist, bool(fuse_filter))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


def plan_signature(graph_digest: str, app, backend_name: str, cap0: int,
                   fuse_filter: bool = True,
                   compaction: str = "xla-scan") -> str:
    """Stable identity of (graph, app knobs, backend, block capacity)."""
    fields = (graph_digest,
              plan_app_key(app, backend_name, fuse_filter, compaction),
              int(cap0))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


# ---------------------------------------------------------------------------
# Capacity policies


class HostCapPolicy:
    """Inspection-execution with a host read per level; records the plan.

    ``extend_caps`` reads the degree-sum bound, then the exact inspection
    counts.  Candidate capacities bucket to powers of two, output
    capacities to tight survivor-scale multiples.
    """

    traceable = False

    def __init__(self):
        self.caps: list[tuple[int, int]] = []
        self.filter_caps: list[int] = []

    def extend_caps(self, pipe):
        bound = int(pipe.bound())
        if bound > 1 << 30:
            raise OverflowError(
                f"{bound} candidates at one level: more than 2^30 int32 "
                "candidate slots need edge blocks, which are not ported yet")
        cand_cap = bucket_pow2(bound)
        _, n_next = pipe.inspect(cand_cap)
        out_cap = bucket_cap(int(n_next))
        self.caps.append((cand_cap, out_cap))
        return cand_cap, out_cap

    def note_extend(self, n_cand, n_surv, cand_cap: int,
                    out_cap: int) -> None:
        # inspection and extension must agree; with tight caps a
        # disagreement would truncate results, so fail loudly
        if int(n_surv) > out_cap or int(n_cand) > cand_cap:
            raise RuntimeError(
                f"extend produced {int(n_surv)} survivors / {int(n_cand)} "
                f"candidates for planned caps ({cand_cap}, {out_cap}): "
                "inspection and extension disagree")

    def filter_cap(self, n_keep) -> int:
        cap = bucket_cap(int(n_keep))
        self.filter_caps.append(cap)
        return cap

    def overflow(self):
        return False


class PlanCapPolicy:
    """Replay a :class:`MiningPlan` with no host read.

    Capacities that overflow truncate the worklist; the overflow flag is a
    device tensor folded from each level's true counts, read once by the
    caller.
    """

    traceable = True

    def __init__(self, plan: MiningPlan, device: torch.device):
        self.plan = plan
        self._li = 0
        self._fi = 0
        self._ovf = torch.zeros((), dtype=torch.bool, device=device)

    def extend_caps(self, pipe):
        cand_cap, out_cap = self.plan.caps[self._li]
        self._li += 1
        return cand_cap, out_cap

    def note_extend(self, n_cand, n_surv, cand_cap: int,
                    out_cap: int) -> None:
        self._ovf = self._ovf | (n_cand > cand_cap) | (n_surv > out_cap)

    def filter_cap(self, n_keep) -> int:
        cap = self.plan.filter_caps[self._fi]
        self._fi += 1
        self._ovf = self._ovf | (n_keep > cap)
        return cap

    def overflow(self):
        return self._ovf


# ---------------------------------------------------------------------------
# The executor


class MiningExecutor:
    """One plan for one (graph, app, backend, cap0) signature, replayed
    across runs.  ``execute`` reads the device once per attempt (the count
    and the overflow flag together) and retries with a grown plan on
    overflow."""

    def __init__(self, miner, cap0: int, plan: Optional[MiningPlan] = None,
                 max_retries: int = 6):
        self.miner = miner
        self.cap0 = int(cap0)
        self.max_retries = max_retries
        self.kind = miner.app.kind
        compaction = miner.backend.compaction
        self.signature = plan_signature(miner.graph_digest(), miner.app,
                                        miner.backend.name, self.cap0,
                                        miner.fuse_filter, compaction)
        self.app_key = plan_app_key(miner.app, miner.backend.name,
                                    miner.fuse_filter, compaction)
        self.transfer_key = plan_transfer_key(miner.app, miner.fuse_filter)
        self._plan = plan
        self.n_executions = 0
        self.n_replans = 0

    @property
    def plan(self) -> Optional[MiningPlan]:
        return self._plan

    @property
    def has_plan(self) -> bool:
        return self._plan is not None

    def adopt_plan(self, caps, filter_caps=(), source: str = "inspect"
                   ) -> None:
        """Install a recorded plan; a plan already in place wins."""
        if self._plan is not None:
            return
        self._plan = MiningPlan(kind=self.kind, caps=tuple(caps),
                                filter_caps=tuple(filter_caps),
                                cap0=self.cap0, signature=self.signature,
                                source=source, app_key=self.app_key,
                                transfer_key=self.transfer_key)

    def _grow(self) -> None:
        self.n_replans += 1
        self._plan = self._plan.grown()

    def _run_once(self, *args):
        """One replay with no host read: the pipeline's result tensors, the
        overflow flag last, all on the device."""
        from repro_torch.core import engine as E
        m = self.miner
        pipe_cls = (E._VertexPipeline if self.kind == "vertex"
                    else E._EdgePipeline)
        pipe = pipe_cls(m.ops, *args)
        policy = PlanCapPolicy(self._plan, m.device)
        E.run_level_loop(pipe, policy)
        return pipe.bounded_result(policy)

    def _run_with_retry(self, *args) -> list[int]:
        """Replay the plan, growing it on overflow.  Each attempt reads the
        device once, after the last level: the results and the overflow
        flag, flattened into one int64 vector, in one transfer."""
        for attempt in range(self.max_retries + 1):
            outs = self._run_once(*args)
            self.n_executions += 1
            flat = torch.cat([o.to(torch.int64).reshape(-1)
                              for o in outs]).tolist()
            if not flat[-1]:
                return flat[:-1]
            if attempt == self.max_retries:
                break
            self._grow()
        raise RuntimeError(f"mining plan {self.signature} still overflows "
                           f"after {self.max_retries + 1} attempts")

    def execute(self, src, dst, n_valid: int) -> tuple[int, np.ndarray]:
        """Replay the plan on a vertex-induced worklist; returns ``(count,
        p_map)``, the per-pattern counts int32[max_patterns] (zeros for an
        app without a reduce), read with the count in the one transfer."""
        assert self.kind == "vertex"
        n = torch.tensor(n_valid, dtype=torch.int32, device=self.miner.device)
        flat = self._run_with_retry(src, dst, n)
        return flat[0], np.asarray(flat[1:], dtype=np.int32)

    def execute_edge(self, src, dst, eid, n_valid: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Replay the plan on an edge-induced (FSM) worklist; returns
        ``(codes, supports)``, each int32[max_patterns]."""
        assert self.kind == "edge"
        n = torch.tensor(n_valid, dtype=torch.int32, device=self.miner.device)
        flat = self._run_with_retry(src, dst, eid, n)
        half = len(flat) // 2
        return (np.asarray(flat[:half], dtype=np.int32),
                np.asarray(flat[half:], dtype=np.int32))
