"""PyTorch port, the edge-induced path end to end: ``Miner.run`` of FSM
against the JAX ``Miner``, cold and warm, on both port backends (the
``cuda`` backend through its kernel's plain version on the CPU); the cold
plan against JAX's; an edge plan through ``interop``; the warm replay's
single device read; and the two repairs that labeled graphs needed (the
graph digest hashes the labels, and the ``cuda`` backend runs a labeled
graph whose predicate reads no label)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_fsm_app as jax_make_fsm_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.core.plan import MiningPlan as JaxMiningPlan
from repro.graph import generators as G
from repro_torch import interop
from repro_torch.core import Miner, get_backend, make_cf_app, make_fsm_app
from repro_torch.core import make_tc_app
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops, ref

GRAPHS = {
    "fig2": (G.paper_fig2_graph,
             lambda: TG.paper_fig2_graph(device="cpu")),
    "er14l3": (lambda: G.erdos_renyi(14, 0.3, seed=5, labels=3),
               lambda: TG.erdos_renyi(14, 0.3, seed=5, labels=3,
                                      device="cpu")),
    "er12l2": (lambda: G.erdos_renyi(12, 0.3, seed=7, labels=2),
               lambda: TG.erdos_renyi(12, 0.3, seed=7, labels=2,
                                      device="cpu")),
    # the er100l3 row of BENCH_backends.json (benchmarks/bench_backends.py)
    "er100l3": (lambda: G.erdos_renyi(100, 0.08, seed=1, labels=3),
                lambda: TG.erdos_renyi(100, 0.08, seed=1, labels=3,
                                       device="cpu")),
}
CASES = [("fig2", 3, 0), ("er14l3", 3, 0), ("er14l3", 3, 2),
         ("er14l3", 3, 3), ("er12l2", 4, 2), ("er12l2", 4, 3),
         ("er100l3", 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_miner(gname, k, min_support):
    """A JAX reference Miner that has run cold (its plan recorded)."""
    m = JaxMiner(GRAPHS[gname][0](),
                 jax_make_fsm_app(k, min_support, max_patterns=64))
    m.cold = m.run()
    return m


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("gname,k,min_support", CASES,
                         ids=[f"{g}-{k}fsm-ms{s}" for g, k, s in CASES])
def test_fsm_matches_jax_cold_and_warm(gname, k, min_support, backend):
    jm = jax_miner(gname, k, min_support)
    want = jm.cold
    m = Miner(GRAPHS[gname][1](), make_fsm_app(k, min_support,
                                               max_patterns=64),
              backend=backend, device="cpu")
    assert m.graph_digest() == jm.graph_digest()
    ops.reset_counts()
    for run in ("cold", "warm"):
        got = m.run()
        assert got.count == want.count
        assert got.codes.dtype == got.supports.dtype == np.int32
        np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
        np.testing.assert_array_equal(got.supports,
                                      np.asarray(want.supports))
    (ex,) = m._executors.values()
    (jex,) = jm._executors.values()
    assert ex.plan.caps == jex.plan.caps
    assert ex.plan.filter_caps == jex.plan.filter_caps
    assert ex.transfer_key == jex.plan.transfer_key
    assert ex.n_executions == 1 and ex.n_replans == 0
    levels = k - 2
    assert ref.extend_edge_ref.calls == (3 * levels if backend == "cuda"
                                         else 0)


def test_fsm_stats_and_overflow_replay():
    m = Miner(GRAPHS["er12l2"][1](), make_fsm_app(4, 2), backend="cuda",
              device="cpu")
    r = m.run(collect_stats=True)
    assert [s.level for s in r.stats] == [1, 2, 3]
    (ex,) = m._executors.values()
    ex._plan = dataclasses.replace(
        ex.plan, caps=tuple((c // 4, o // 4) for c, o in ex.plan.caps),
        filter_caps=tuple(f // 4 for f in ex.plan.filter_caps))
    warm = m.run()
    np.testing.assert_array_equal(warm.codes, r.codes)
    np.testing.assert_array_equal(warm.supports, r.supports)
    assert ex.n_replans >= 1 and ex.plan.source == "grown"


def test_edge_plan_round_trips_through_jax_json():
    jm = jax_miner("er14l3", 3, 2)
    (jex,) = jm._executors.values()
    plan = interop.plan_from_json(jex.plan.to_json())
    assert plan.kind == "edge" and plan.filter_caps == jex.plan.filter_caps
    m = Miner(GRAPHS["er14l3"][1](), make_fsm_app(3, 2), backend="cuda",
              device="cpu")
    ex = m.executor(plan.cap0)
    ex.adopt_plan(plan.caps, plan.filter_caps, source="transfer")
    r = m.run()                                       # no inspection pass
    np.testing.assert_array_equal(r.supports, np.asarray(jm.cold.supports))
    assert ex.n_executions == 1 and ex.n_replans == 0
    back = JaxMiningPlan.from_json(interop.plan_to_json(ex.plan))
    assert back.filter_caps == jex.plan.filter_caps
    assert back.source == "transfer"


def test_warm_fsm_replay_reads_the_device_once(monkeypatch):
    m = Miner(GRAPHS["er12l2"][1](), make_fsm_app(4, 2), backend="cuda",
              device="cpu")
    want = m.run()
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
    got = m.run()
    monkeypatch.undo()
    assert reads == ["tolist"]
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.supports, want.supports)


def test_label_mask_is_evaluated_once_per_miner():
    calls = []
    app = make_fsm_app(4, 2)
    hook = app.to_add_vertex_mask

    def counted(ctx):
        calls.append(ctx)
        return hook(ctx)
    app = dataclasses.replace(app, to_add_vertex_mask=counted)
    m = Miner(GRAPHS["er12l2"][1](), app, backend="cuda", device="cpu")
    m.run()
    m.run()
    assert len(calls) == 1


def test_label_mask_drops_rare_labels():
    g = TG.erdos_renyi(30, 0.2, seed=3, labels=3, device="cpu")
    freq = torch.bincount(g.labels, minlength=3)
    ms = int(freq.min()) + 1
    m = Miner(g, make_fsm_app(3, ms), device="cpu")
    mask = m.ops.app.to_add_vertex_mask(m.ctx)
    assert torch.equal(mask, freq[g.labels.long()] >= ms)
    assert not bool(mask.all()) and bool(mask.any())


# -- the repairs -------------------------------------------------------------

@pytest.mark.parametrize("app", ["3-fsm", "tc"])
def test_graph_digest_hashes_labels_like_jax(app):
    jax_app, port_app = {"3-fsm": (jax_make_fsm_app(3, 2),
                                   make_fsm_app(3, 2)),
                         "tc": (jax_make_tc_app(), make_tc_app())}[app]
    jm = JaxMiner(G.erdos_renyi(14, 0.3, seed=5, labels=3), jax_app)
    m = Miner(TG.erdos_renyi(14, 0.3, seed=5, labels=3, device="cpu"),
              port_app, device="cpu")
    unlabeled = Miner(TG.erdos_renyi(14, 0.3, seed=5, device="cpu"),
                      port_app, device="cpu")
    assert m.graph_digest() == jm.graph_digest()
    assert m.graph_digest() != unlabeled.graph_digest()


@pytest.mark.parametrize("aname", ["tc", "4-cf"])
def test_cuda_backend_counts_labeled_graphs(aname):
    jax_app, port_app = {"tc": (jax_make_tc_app, make_tc_app),
                         "4-cf": (lambda: jax_make_cf_app(4),
                                  lambda: make_cf_app(4))}[aname]
    g = G.erdos_renyi(40, 0.3, seed=2, labels=3)
    want = JaxMiner(g, jax_app(), backend="reference").run().count
    m = Miner(TG.erdos_renyi(40, 0.3, seed=2, labels=3, device="cpu"),
              port_app(), backend="cuda", device="cpu")
    assert m.run().count == want and m.run().count == want


def test_cuda_backend_edge_capabilities_and_refusals():
    cuda = get_backend("cuda")
    caps = cuda.capabilities(make_fsm_app(3, 2))
    assert caps["extend_edge"] == "cuda-kernel"
    assert caps["extend_pruned"] == caps["extend_vertex"] == "n/a"
    assert cuda.capabilities(make_tc_app())["extend_edge"] == "n/a"
    batch = dataclasses.replace(make_fsm_app(3, 2), to_add_vertex_mask=None,
                                to_add=lambda ctx, emb, u, st: u >= 0)
    assert cuda.capabilities(batch)["extend_edge"] == \
        "unsupported:batch-to-add"
    g = GRAPHS["er14l3"][1]
    with pytest.raises(NotImplementedError, match="batch to_add"):
        Miner(g(), batch, backend="cuda", device="cpu").run()
    # the plain backend runs the batch hook (every label is frequent here,
    # so the mask it replaces dropped nothing)
    assert Miner(g(), batch, backend="torch-ref", device="cpu").run().count \
        == Miner(g(), make_fsm_app(3, 2), device="cpu").run().count
    # FSM's support is global, so the edge path ignores block sizes (paper
    # §5.2), as the JAX package does
    assert Miner(g(), make_fsm_app(3, 2), device="cpu").run(
        block_size=4).count == Miner(g(), make_fsm_app(3, 2),
                                     device="cpu").run().count


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_fsm_on_a_graph_without_edges(backend):
    from repro_torch.graph.csr import from_edge_list
    g = from_edge_list(np.zeros((0, 2)), n_vertices=5,
                       labels=np.array([0, 1, 0, 1, 2]), device="cpu")
    m = Miner(g, make_fsm_app(3, 1), backend=backend, device="cpu")
    ops.reset_counts()
    for run in ("cold", "warm"):
        r = m.run()
        assert r.count == 0 and not r.supports.any()
    # no candidate exists, so the cuda backend launches nothing
    assert ref.extend_edge_ref.calls == 0
