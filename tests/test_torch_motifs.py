"""PyTorch port, motif counting and compiled patterns end to end:
``Miner.run`` on ``torch-ref``, ``cuda`` and ``cuda-1p`` (the CUDA
backends' wrappers run their plain versions on the CPU), cold and warm,
against the JAX ``Miner`` on its ``reference`` backend and, for one app of
each spec kind, its ``pallas`` backend in interpret mode; counts and
p_maps exactly, and against ``tests/oracles.py``'s brute-force pattern
count.  Then the smoke script's scipy census, held against JAX's mc(3) and
mc(4), so the card run's oracle is itself checked."""
import functools
import importlib.util
from pathlib import Path

import pytest
import torch

from oracles import pattern_count_bruteforce, pattern_count_noninduced
from repro.core import Miner as JaxMiner
from repro.core import make_mc_app as jax_make_mc_app
from repro.core.apps.psm import pattern_app as jax_pattern_app
from repro.core.apps.psm import pattern_set_app as jax_pattern_set_app
from repro.core.patterns import Pattern as JaxPattern
from repro.core.patterns import motif_patterns as jax_motif_patterns
from repro.graph import generators as G
from repro_torch.core import (Miner, Pattern, make_mc_app, pattern_app,
                              pattern_set_app)
from repro_torch.graph import generators as TG

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("torch-ref", "cuda", "cuda-1p")

# (port graph, JAX graph): a small ER graph, and a labeled one for the
# labeled pattern
GRAPHS = {"er": (lambda: TG.erdos_renyi(18, 0.35, seed=1, device="cpu"),
                 lambda: G.erdos_renyi(18, 0.35, seed=1)),
          "labeled": (lambda: TG.erdos_renyi(22, 0.3, seed=2, labels=3,
                                             device="cpu"),
                      lambda: G.erdos_renyi(22, 0.3, seed=2, labels=3))}

DIRECTED = ("diamond", "4-cycle", "4-star")
SYMMETRIC = ("diamond", "4-cycle", "4-clique")
LCHAIN = dict(edges=[(0, 1), (1, 2)], labels=[0, 1, 2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set(mod_pattern, mod_app, names, **kw):
    return lambda: mod_app([mod_pattern.named(n) for n in names], **kw)


# name -> (graph, port app, JAX app, patterns for the oracle by p_map slot
# (or the one pattern of a count), induced)
APPS = {f"mc{k}-{mode}": ("er", (lambda k=k, mode=mode: make_mc_app(k, mode)),
                          (lambda k=k, mode=mode: jax_make_mc_app(k, mode)),
                          k, True)
        for k in (3, 4) for mode in ("set", "memo", "custom", "generic")}
APPS.update({
    "mc5-set": ("er", lambda: make_mc_app(5), lambda: jax_make_mc_app(5), 5,
                True),
    "diamond": ("er", lambda: pattern_app(Pattern.named("diamond")),
                lambda: jax_pattern_app(JaxPattern.named("diamond")),
                "diamond", True),
    "5-clique": ("er", lambda: pattern_app(Pattern.clique(5)),
                 lambda: jax_pattern_app(JaxPattern.clique(5)), "5-clique",
                 True),
    "lchain": ("labeled", lambda: pattern_app(Pattern.from_edges(**LCHAIN)),
               lambda: jax_pattern_app(JaxPattern.from_edges(**LCHAIN)),
               "lchain", True),
    "set-directed": ("er", _set(Pattern, pattern_set_app, DIRECTED),
                     _set(JaxPattern, jax_pattern_set_app, DIRECTED),
                     DIRECTED, True),
    "set-symmetric": ("er", _set(Pattern, pattern_set_app, SYMMETRIC),
                      _set(JaxPattern, jax_pattern_set_app, SYMMETRIC),
                      SYMMETRIC, True),
    "set-noninduced": (
        "er", _set(Pattern, pattern_set_app, DIRECTED, induced=False),
        _set(JaxPattern, jax_pattern_set_app, DIRECTED, induced=False),
        DIRECTED, False),
    "set-duplicates": (
        "er", lambda: pattern_set_app([Pattern.clique(3),
                                       Pattern.from_string("0-1,1-2,0-2"),
                                       Pattern.path(3)]),
        lambda: jax_pattern_set_app([JaxPattern.clique(3),
                                     JaxPattern.from_string("0-1,1-2,0-2"),
                                     JaxPattern.path(3)]),
        ("triangle", "triangle", "wedge"), True),
})
# through JAX's Pallas kernels (interpret mode, about 10 s an app): the
# branch set with its state column, and the labeled conjunction
PALLAS = ("mc3-set", "lchain")


@functools.lru_cache(maxsize=None)
def jax_result(name, backend="reference"):
    gname, _, jax_app, _, _ = APPS[name]
    r = JaxMiner(GRAPHS[gname][1](), jax_app(), backend=backend).run()
    return r.count, None if r.p_map is None else [int(x) for x in r.p_map]


def _jax_pattern(p):
    if isinstance(p, str) and p == "lchain":
        return JaxPattern.from_edges(**LCHAIN)
    if isinstance(p, str) and p == "5-clique":
        return JaxPattern.clique(5)
    if isinstance(p, str):
        return JaxPattern.named(p)
    return p


@functools.lru_cache(maxsize=None)
def oracle(name):
    """Brute-force counts: per p_map slot, or the single count."""
    gname, _, _, pats, induced = APPS[name]
    g = GRAPHS[gname][1]()
    count = pattern_count_bruteforce if induced else pattern_count_noninduced
    if isinstance(pats, int):
        pats = jax_motif_patterns(pats)
        if name.endswith("generic"):     # the reduce numbers by code
            pats = sorted(pats, key=lambda p: p.canonical_code())
    elif isinstance(pats, str):
        return count(g, _jax_pattern(pats)), None
    p_map = [count(g, _jax_pattern(p)) for p in pats]
    return None, p_map


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_matches_jax_and_the_oracle(name, backend):
    gname, port_app, _, _, induced = APPS[name]
    want = jax_result(name)
    m = Miner(GRAPHS[gname][0](), port_app(), backend=backend, device="cpu")
    for run in ("cold", "warm"):
        r = m.run()
        got = (r.count, None if r.p_map is None
               else [int(x) for x in r.p_map])
        assert got == want, run
    (ex,) = m._executors.values()
    assert ex.n_executions == 1 and ex.n_replans == 0
    count, p_map = oracle(name)
    if p_map is None:
        assert want[0] == count
    else:
        assert want[1] == p_map
        if induced:          # one leaf per embedding, duplicates shared
            pats = APPS[name][3]
            keys = range(len(p_map)) if isinstance(pats, int) else pats
            assert want[0] == sum(dict(zip(keys, p_map)).values())


@pytest.mark.parametrize("name", PALLAS)
def test_jax_pallas_backend_agrees(name):
    """The JAX Pallas kernels (interpret mode) give what the port gives."""
    assert jax_result(name, "pallas") == jax_result(name)


def test_mc5_set_and_generic_agree():
    """k = 5 numbers the trie's leaves in canonical-code order, which is
    the generic reduce's order (checked against JAX as ``mc5-set``)."""
    g = GRAPHS["er"][0]()
    a = Miner(g, make_mc_app(5), device="cpu").run()
    b = Miner(g, make_mc_app(5, "generic"), device="cpu").run()
    assert (a.count, list(a.p_map)) == (b.count, list(b.p_map)) == \
        jax_result("mc5-set")


def test_default_device_is_the_card():
    """``Miner(g, make_mc_app(4))`` with no device runs on the card's cuda
    backend; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        Miner(GRAPHS["er"][0](), make_mc_app(4))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("graph", ["rmat6", "er"])
def test_smoke_census_equals_jax_mc(graph, k):
    smoke = _smoke()
    tg, jg = {"rmat6": (lambda: TG.rmat(6, 16, seed=0, device="cpu"),
                        lambda: G.rmat(6, 16, seed=0)),
              "er": GRAPHS["er"]}[graph]
    want = JaxMiner(jg(), jax_make_mc_app(k, "memo")).run()
    assert smoke.motif_census(tg(), k) == [int(x) for x in want.p_map]


def test_smoke_labeled_chain_count_equals_jax():
    smoke = _smoke()
    g = GRAPHS["labeled"][0]()
    assert smoke.labeled_chain_count(g) == jax_result("lchain")[0] > 0
