"""PyTorch port, the mining CLI and ``serve --mine`` against the JAX
package.

``repro_torch.launch.mine.main([..., "--device", "cpu"])`` mines TC, 4-MC,
3-FSM, a library pattern, a pattern set, a blocked run and an estimated
plan on the JAX CLI's graph spec; each result, and the count the CLI
prints, equals JAX's ``Miner.run`` on the graph and app that JAX's CLI
builds, and the ``--trace`` / ``--metrics`` files pass both packages'
validators (an estimated run, which inspects no level, shows its
estimator span and plan event instead).  ``serve --mine`` answers two
queries.  The JAX side is cached per worker; torch runs on one thread.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro.obs import validate as jax_validate
from repro_torch.launch import mine, serve
from repro_torch.obs import metrics, trace, validate

GRAPH = "er:40,0.2"


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
    trace.disable()
    metrics.reset()
    yield
    trace.disable()
    metrics.reset()


def _jax_app(kind, arg):
    from repro.core import Pattern, pattern_app, pattern_set_app
    from repro.launch.mine import make_app
    if kind == "app":
        return make_app(arg, 2)
    if kind == "pattern":
        return pattern_app(Pattern.named(arg))
    return pattern_set_app(tuple(Pattern.named(n) for n in arg.split(",")))


@functools.lru_cache(maxsize=None)
def jax_result(kind, arg):
    """JAX's Miner.run on JAX's CLI graph: (count, p_map, codes,
    supports)."""
    from repro.core import Miner as JaxMiner
    from repro.launch.mine import load_graph
    labels = 3 if "fsm" in arg else None
    r = JaxMiner(load_graph(GRAPH, labels=labels), _jax_app(kind, arg)).run()
    lst = (lambda a: None if a is None else np.asarray(a).tolist())
    return r.count, lst(r.p_map), lst(r.codes), lst(r.supports)


CASES = {
    "tc": (("--app", "tc"), ("app", "tc")),
    "4-mc": (("--app", "4-mc"), ("app", "4-mc")),
    "3-fsm": (("--app", "3-fsm", "--minsup", "2"), ("app", "3-fsm")),
    "diamond": (("--pattern", "diamond"), ("pattern", "diamond")),
    "set": (("--patterns", "diamond,4-cycle"), ("set", "diamond,4-cycle")),
    "blocks": (("--app", "3-mc", "--blocks", "4"), ("app", "3-mc")),
    "estimate": (("--app", "4-cf", "--plan", "estimate", "--repeat", "2"),
                 ("app", "4-cf")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_mines_as_jax_and_exports_valid_files(case, tmp_path, capsys):
    flags, want_key = CASES[case]
    tpath, mpath = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    r = mine.main(["--graph", GRAPH, *flags, "--device", "cpu", "--trace",
                   tpath, "--metrics", mpath])
    out = capsys.readouterr().out
    count, p_map, codes, supports = jax_result(*want_key)
    if codes is not None:
        assert r.codes.tolist() == codes and r.supports.tolist() == supports
        assert f"{count} frequent patterns" in out
    elif r.p_map is not None:
        assert np.asarray(r.p_map).tolist() == p_map
        for n in p_map:
            assert f": {n}\n" in out
    else:
        assert r.count == count and f"count = {count} " in out
    doc = json.load(open(tpath))
    names = {e["name"] for e in doc["traceEvents"]}
    if case == "estimate":
        assert {"plan.estimate", "plan.estimated", "executor.replay"} <= names
        return
    snap = json.load(open(mpath))
    for v in (validate, jax_validate):
        v.validate_trace(doc)
        v.validate_metrics(snap)
    if case == "blocks":
        assert {"block", "block.stage"} <= names
        assert "blocks.stage_overlap" in snap["gauges"]


def test_cli_lists_and_refuses_as_jax(capsys):
    mine.main(["--pattern", "list", "--device", "cpu"])
    assert "diamond" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="FSM blocking"):
        mine.main(["--graph", GRAPH, "--app", "3-fsm", "--blocks", "2",
                   "--device", "cpu"])


def test_serve_mine_answers_two_queries(tmp_path, capsys):
    mpath = str(tmp_path / "m.json")
    results = serve.main(["--mine", "--graph", GRAPH, "--queries",
                          "tc,diamond", "--device", "cpu", "--metrics",
                          mpath])
    assert [x["query"] for x in results] == ["tc", "diamond"]
    assert results[0]["result"].count == jax_result("app", "tc")[0]
    assert results[1]["result"].count == jax_result("pattern", "diamond")[0]
    assert all(x["plan_reports"][0]["source"] == "estimated"
               for x in results)
    snap = json.load(open(mpath))
    assert snap["histograms"]["serve.first_ms"]["count"] == 2
    assert snap["histograms"]["serve.warm_ms"]["count"] == 2
    assert "[serve] warm: n=2" in capsys.readouterr().out
