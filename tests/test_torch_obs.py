"""PyTorch port, observability against the JAX package.

The port's ``repro_torch.obs`` is a copy of ``repro.obs``: the same
registry arithmetic and exports; the engine, plan, executor and block
queue report under the JAX package's names, so a cold and a warm TC and
3-FSM run trace the same (name, cat) spans and events as JAX's and count
the same ``mine.candidates``, ``mine.survivors`` and ``plan.*``; both
validators accept the port's exports; a blocked run records the block
queue's overlap and the live-bytes gauges.  JAX's side runs on its
reference backend, cached per worker; torch on one thread.
"""
import functools
import json

import pytest
import torch

from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.obs import validate as jax_validate
from repro_torch.core import Miner, make_fsm_app, make_tc_app
from repro_torch.graph import generators as TG
from repro_torch.obs import metrics, report, trace, validate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each test starts and ends with both tracers off and both registries
    empty."""
    for tr, reg in ((trace, metrics), (jax_trace, jax_metrics)):
        tr.disable()
        reg.reset()
    yield
    for tr, reg in ((trace, metrics), (jax_trace, jax_metrics)):
        tr.disable()
        reg.reset()


def _record(reg):
    """The same recordings into one package's registry."""
    reg.inc("c", 2, level=3)
    reg.inc("c", 0.5, level=3)
    reg.set_gauge("g", 0.25)
    for v in (0.0, 0.3, 1.0, 3.0, 100.0, 1e6):
        reg.observe("h", v, kind="x")
    return reg.snapshot(), reg.render()


def test_registry_is_jax():
    assert _record(metrics) == _record(jax_metrics)


def test_span_args_take_torch_scalars(tmp_path):
    trace.enable()
    with trace.span("s", cat="c", n=torch.tensor(7), x=torch.tensor(0.5),
                    v=torch.arange(3)):
        pass
    doc = json.loads(open(trace.save(str(tmp_path / "t.json"))).read())
    args = doc["traceEvents"][0]["args"]
    assert (args["n"], args["x"]) == (7, 0.5) and isinstance(args["v"], str)


def test_obs_imports_nothing():
    import ast
    import pathlib
    for path in pathlib.Path(trace.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        roots = {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module
                 and n.level == 0}
        roots |= {a.name.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.Import) for a in n.names}
        assert roots <= {"__future__", "json", "math", "os", "sys",
                         "threading", "time", "typing", "repro_torch"}, roots


APPS = ("tc", "3-fsm")


def _graph(name, jax=False):
    labels = 3 if name == "3-fsm" else None
    if jax:
        from repro.graph import generators as G
        return G.erdos_renyi(24, 0.25, seed=7, labels=labels)
    return TG.erdos_renyi(24, 0.25, seed=7, labels=labels, device="cpu")


def _observed(tr, reg):
    """(the set of (name, cat) of every event, the counters compared)."""
    names = {(e["name"], e["cat"]) for e in tr.get().events}
    snap = reg.snapshot()["counters"]
    counters = {k: v for k, v in snap.items()
                if k.startswith(("mine.candidates", "mine.survivors",
                                 "plan."))}
    return names, counters


@functools.lru_cache(maxsize=None)
def jax_observed(name):
    """JAX's events and counters over a cold and a warm run."""
    from repro.core import Miner as JaxMiner
    from repro.core import make_fsm_app as jf, make_tc_app as jt
    app = jt() if name == "tc" else jf(3, min_support=2, max_patterns=64)
    jax_trace.disable()
    jax_metrics.reset()
    jax_trace.enable()
    miner = JaxMiner(_graph(name, jax=True), app)
    counts = [miner.run().count for _ in ("cold", "warm")]
    out = _observed(jax_trace, jax_metrics), counts
    jax_trace.disable()
    jax_metrics.reset()
    return out


def _port_app(name):
    return (make_tc_app() if name == "tc"
            else make_fsm_app(3, min_support=2, max_patterns=64))


@pytest.mark.parametrize("name", APPS)
def test_cold_and_warm_runs_observe_as_jax(name, tmp_path):
    (want_names, want_counters), want_counts = jax_observed(name)
    trace.enable()
    miner = Miner(_graph(name), _port_app(name), backend="cuda",
                  device="cpu")
    counts = [miner.run().count for _ in ("cold", "warm")]
    names, counters = _observed(trace, metrics)
    assert counts == want_counts
    assert names == want_names
    assert counters == want_counters
    assert ("executor.compile", "executor") in names
    assert ("level", "mine") in names and ("miner.run", "mine") in names
    # the exports pass both validators
    tpath = trace.save(str(tmp_path / "t.json"))
    mpath = metrics.dump(str(tmp_path / "m.json"))
    for v in (validate, jax_validate):
        v.validate_trace(json.load(open(tpath)))
        v.validate_metrics(json.load(open(mpath)))


def test_warm_replay_traces_no_level_and_no_op():
    miner = Miner(_graph("tc"), make_tc_app(), device="cpu")
    miner.run()
    trace.enable()
    miner.run()
    miner.run()
    names = [e["name"] for e in trace.get().events]
    assert names == ["executor.compile", "miner.run", "executor.replay",
                     "miner.run"]
    assert metrics.value("executor.compiles", kind="vertex") == 1
    assert metrics.value("executor.replays", kind="vertex") == 1


def test_blocked_run_records_overlap_and_live_bytes():
    trace.enable()
    miner = Miner(TG.erdos_renyi(40, 0.2, seed=3, device="cpu"),
                  make_tc_app(), device="cpu")
    r = miner.run(block_size=32, collect_stats=True)
    assert r.count == miner.run().count
    snap = metrics.snapshot()
    overlap = snap["gauges"]["blocks.stage_overlap"]
    assert 0.0 < overlap <= 1.0
    actual = {k: v for k, v in snap["gauges"].items()
              if k.startswith("blocks.live_bytes.actual")}
    predicted = {k: v for k, v in snap["gauges"].items()
                 if k.startswith("blocks.live_bytes.predicted")}
    assert len(actual) == len(predicted) == len(miner.block_queue)
    assert all(v > 0 for v in actual.values())
    assert snap["histograms"]["blocks.stage_ms"]["count"] == \
        len(miner.block_queue)
    events = {e["name"] for e in trace.get().events}
    assert {"block", "block.stage", "level"} <= events


def test_estimate_and_grown_plans_report_their_events():
    trace.enable()
    miner = Miner(TG.erdos_renyi(40, 0.2, seed=3, device="cpu"),
                  make_tc_app(), device="cpu")
    miner.run(plan_source="estimate", safety_factor=0.01)
    events = {e["name"] for e in trace.get().events}
    assert {"plan.estimate", "plan.estimated", "plan.grown"} <= events
    assert metrics.value("plan.grown", kind="vertex") >= 1
    rep = miner.plan_reports()
    line = report.plan_table(rep)
    assert "source=grown" in line and "compiles" not in line
