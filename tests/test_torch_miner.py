"""PyTorch port, the main path end to end: ``Miner.run`` counts for TC and
4-CF against the JAX ``Miner``, cold and warm, on both port backends; the
overflow backstop; a JAX-recorded plan replayed through ``interop``; the
warm replay's single device read; and the device default."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.core.plan import MiningPlan as JaxMiningPlan
from repro.graph import generators as G
from repro_torch import interop
from repro_torch.core import Miner, make_cf_app, make_tc_app
from repro_torch.graph import generators as TG

GRAPHS = {"er80": (lambda: G.erdos_renyi(80, 0.1, seed=0),
                   lambda: TG.erdos_renyi(80, 0.1, seed=0, device="cpu")),
          "rmat8": (lambda: G.rmat(8, seed=0),
                    lambda: TG.rmat(8, seed=0, device="cpu")),
          "clique7": (lambda: G.clique(7), lambda: TG.clique(7,
                                                            device="cpu"))}
APPS = {"tc": (jax_make_tc_app, make_tc_app),
        "4-cf": (lambda: jax_make_cf_app(4), lambda: make_cf_app(4))}


@functools.lru_cache(maxsize=None)
def jax_miner(gname, aname):
    """A JAX reference Miner that has run cold (its plan recorded)."""
    m = JaxMiner(GRAPHS[gname][0](), APPS[aname][0]())
    m.cold_count = m.run().count
    return m


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("aname", sorted(APPS))
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_counts_match_jax_cold_and_warm(gname, aname, backend):
    want = jax_miner(gname, aname).cold_count
    m = Miner(GRAPHS[gname][1](), APPS[aname][1](), backend=backend,
              device="cpu")
    cold = m.run()
    assert cold.count == want
    (ex,) = m._executors.values()
    assert ex.plan.source == "inspect" and ex.n_executions == 0
    assert m.run().count == want                      # warm: plan replay
    assert ex.n_executions == 1 and ex.n_replans == 0


def test_cold_stats_report_every_level():
    m = Miner(TG.rmat(8, seed=0, device="cpu"), make_cf_app(4), device="cpu")
    r = m.run(collect_stats=True)
    assert [s.level for s in r.stats] == [2, 3]
    assert r.stats[-1].n_embeddings == r.count
    assert all(s.n_candidates >= s.n_embeddings for s in r.stats)


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_overflow_replay_grows_the_plan(backend):
    m = Miner(TG.rmat(8, seed=0, device="cpu"), make_cf_app(4),
              backend=backend, device="cpu")
    want = m.run().count
    (ex,) = m._executors.values()
    ex._plan = dataclasses.replace(
        ex.plan, caps=tuple((c // 8, o // 8) for c, o in ex.plan.caps))
    assert m.run().count == want
    assert ex.n_replans >= 1 and ex.plan.source == "grown"


def test_jax_plan_replays_in_port():
    jm = jax_miner("rmat8", "4-cf")
    (jex,) = jm._executors.values()
    plan = interop.plan_from_json(jex.plan.to_json())
    assert plan.caps == jex.plan.caps and plan.cap0 == jex.plan.cap0
    g = interop.graph_from_arrays(np.asarray(jm.graph_in.row_ptr),
                                  np.asarray(jm.graph_in.col_idx),
                                  device="cpu")
    m = Miner(g, make_cf_app(4), backend="cuda", device="cpu")
    assert m.graph_digest() == jm.graph_digest()      # same CSR bytes
    ex = m.executor(plan.cap0)
    assert ex.transfer_key == plan.transfer_key       # same app identity
    ex.adopt_plan(plan.caps, plan.filter_caps, source="transfer")
    assert m.run().count == jm.cold_count             # no inspection pass
    assert ex.n_executions == 1 and ex.n_replans == 0
    back = JaxMiningPlan.from_json(interop.plan_to_json(ex.plan))
    assert back.caps == jex.plan.caps and back.source == "transfer"


def test_warm_replay_reads_the_device_once(monkeypatch):
    m = Miner(TG.rmat(8, seed=0, device="cpu"), make_cf_app(4),
              backend="cuda", device="cpu")
    want = m.run().count
    reads = []

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads.append(name)
            return orig(self, *a, **kw)
        return read

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    count = m.run().count
    monkeypatch.undo()
    assert count == want
    assert reads == ["tolist"]


def test_miner_needs_a_card_unless_asked_for_cpu(monkeypatch):
    g = TG.clique(6, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Miner(g, make_tc_app())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Miner(g, make_tc_app(), device="cuda")
    assert Miner(g, make_tc_app(), device="cpu").run().count == 20


def test_unported_run_modes_raise():
    m = Miner(TG.clique(6, device="cpu"), make_tc_app(), device="cpu")
    with pytest.raises(NotImplementedError, match="estimate"):
        m.run(plan_source="estimate")
    with pytest.raises(NotImplementedError, match="blocks"):
        m.run(block_size=4)
