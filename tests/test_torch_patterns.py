"""PyTorch port, the pattern subsystem: the port's copy of the pattern
compiler (``repro_torch.core.patterns``) is held field for field against the
JAX package's on every named pattern, the motif tables for k = 3..5, the
named pattern sets and a directed set; the motif classifiers and canonical
codes of ``repro_torch.core.pattern`` against ``repro.core.pattern`` on
random adjacency; the level specs against JAX's traced predicates; and the
plan identity of the new apps against JAX's."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_mc_app as jax_make_mc_app
from repro.core import pattern as JP
from repro.core import patterns as JPS
from repro.core.apps import psm as jax_psm
from repro.core.plan import plan_app_key as jax_plan_app_key
from repro.graph import generators as G
from repro_torch.core import make_mc_app, pattern_app, pattern_set_app
from repro_torch.core import pattern as TP
from repro_torch.core import patterns as TPS
from repro_torch.core.apps import psm
from repro_torch.core.plan import plan_app_key
from repro_torch.graph import generators as TG


def _plain(x):
    """A dataclass tree as plain Python values, so the two packages'
    objects compare field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _pattern_fields(p):
    return (_plain(p), p.canonical_code(), p.hash_hex(),
            p.automorphisms())


def _plan_fields(plan):
    return _plain(plan), plan.plan_key


NAMED = TPS.pattern_names()


@pytest.mark.parametrize("induced", [True, False], ids=["induced", "hom"])
@pytest.mark.parametrize("name", NAMED)
def test_compiled_named_pattern_is_field_equal(name, induced):
    port = TPS.compile_pattern(TPS.Pattern.named(name), induced=induced)
    jax_plan = JPS.compile_pattern(JPS.Pattern.named(name), induced=induced)
    assert _pattern_fields(TPS.Pattern.named(name)) == \
        _pattern_fields(JPS.Pattern.named(name))
    assert _plan_fields(port) == _plan_fields(jax_plan)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_motif_tables_are_field_equal(k):
    assert TPS.n_connected_patterns(k) == JPS.n_connected_patterns(k)
    assert TPS.enumerate_connected_codes(k) == \
        JPS.enumerate_connected_codes(k)
    port, want = TPS.motif_patterns(k), JPS.motif_patterns(k)
    assert [_pattern_fields(p) for p in port] == \
        [_pattern_fields(p) for p in want]
    for p, q in zip(port, want):
        assert _plan_fields(TPS.compile_pattern(p)) == \
            _plan_fields(JPS.compile_pattern(q))


SETS = {name: (lambda name=name: TPS.named_pattern_set(name),
               lambda name=name: JPS.named_pattern_set(name))
        for name in TPS.pattern_set_names()}
SETS["directed"] = (
    lambda: [TPS.Pattern.named(n) for n in ("diamond", "4-cycle", "4-star")],
    lambda: [JPS.Pattern.named(n) for n in ("diamond", "4-cycle", "4-star")])
SETS["duplicates"] = (
    lambda: [TPS.Pattern.clique(3), TPS.Pattern.from_string("0-1,1-2,0-2"),
             TPS.Pattern.path(3)],
    lambda: [JPS.Pattern.clique(3), JPS.Pattern.from_string("0-1,1-2,0-2"),
             JPS.Pattern.path(3)])


@pytest.mark.parametrize("induced", [True, False], ids=["induced", "hom"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_compiled_pattern_set_is_field_equal(name, induced):
    port = TPS.compile_pattern_set(SETS[name][0](), induced=induced)
    want = JPS.compile_pattern_set(SETS[name][1](), induced=induced)
    assert _plan_fields(port) == _plan_fields(want)
    assert (port.directed, port.leaves, port.dedup_slot, port.n_nodes) == \
        (want.directed, want.leaves, want.dedup_slot, want.n_nodes)
    if name == "directed":
        assert port.directed
        assert any(br.first_pair for br in port.levels[0])


def test_graph_stats_and_cost_model_orders_are_equal():
    for labels in (None, 3):
        jg = G.rmat(7, 8, seed=1, labels=labels)
        tg = TG.rmat(7, 8, seed=1, labels=labels, device="cpu")
        stats, jstats = TPS.graph_stats(tg), JPS.graph_stats(jg)
        assert _plain(stats) == _plain(jstats)
        for name in ("house", "bowtie", "tailed-triangle"):
            assert _plan_fields(TPS.compile_pattern(
                TPS.Pattern.named(name), stats=stats)) == _plan_fields(
                JPS.compile_pattern(JPS.Pattern.named(name), stats=jstats))
        assert _plan_fields(TPS.compile_pattern_set(
            TPS.motif_patterns(4), stats=stats)) == _plan_fields(
            JPS.compile_pattern_set(JPS.motif_patterns(4), stats=jstats))


@functools.lru_cache(maxsize=None)
def _random_adjacency(k: int, n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed + k)
    upper = np.triu(rng.random((n, k, k)) < 0.5, 1)
    return upper | upper.transpose(0, 2, 1)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_canonical_and_quick_codes_equal_jax(k):
    adj = _random_adjacency(k)
    labels = np.random.default_rng(k).integers(0, 3, (adj.shape[0], k))
    ta, tl = torch.from_numpy(adj), torch.from_numpy(labels)
    ja, jl = jnp.asarray(adj), jnp.asarray(labels)
    for lab, jlab, n_labels in ((None, None, 1), (tl, jl, 3)):
        np.testing.assert_array_equal(
            TP.canonical_code(ta, lab, k, n_labels).numpy(),
            np.asarray(JP.canonical_code(ja, jlab, k, n_labels)))
        np.testing.assert_array_equal(
            TP.quick_code(ta, lab, k, n_labels).numpy(),
            np.asarray(JP.quick_code(ja, jlab, k, n_labels)))
    n_quick = 2 ** (k * (k - 1) // 2)
    np.testing.assert_array_equal(
        TP.canonicalize_via_quick(ta, None, k, 1, n_quick).numpy(),
        np.asarray(JP.canonicalize_via_quick(ja, None, k, 1, n_quick)))


def test_motif_classifiers_equal_jax():
    a3, a4 = _random_adjacency(3), _random_adjacency(4)
    np.testing.assert_array_equal(
        TP.classify_3motif(torch.from_numpy(a3)).numpy(),
        np.asarray(JP.classify_3motif(jnp.asarray(a3))))
    np.testing.assert_array_equal(
        TP.classify_4motif(torch.from_numpy(a4)).numpy(),
        np.asarray(JP.classify_4motif(jnp.asarray(a4))))
    np.testing.assert_array_equal(
        TP.wedge_center(torch.from_numpy(a3)).numpy(),
        np.asarray(JP.wedge_center(jnp.asarray(a3))))
    rng = np.random.default_rng(4)
    prev = rng.integers(0, 2, 400).astype(np.int32)
    center = rng.integers(0, 3, 400).astype(np.int32)
    conn = rng.random((400, 3)) < 0.5
    np.testing.assert_array_equal(
        TP.classify_4motif_memoized(torch.from_numpy(prev),
                                    torch.from_numpy(center),
                                    torch.from_numpy(conn)).numpy(),
        np.asarray(JP.classify_4motif_memoized(
            jnp.asarray(prev), jnp.asarray(center), jnp.asarray(conn))))
    for k in (3, 4):
        assert TP.motif_canonical_codes(k) == JP.motif_canonical_codes(k)
    assert (TP.N_MOTIFS, TP.MOTIF_NAMES) == (JP.N_MOTIFS, JP.MOTIF_NAMES)


def _spec_operands(k: int, n: int = 3000, seed: int = 3):
    """Random elementwise operands of a level predicate: parent columns
    with dead (-1) slots, candidates, source slots, states, connectivity
    bits and labels, as numpy."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-1, 12, (k, n)).astype(np.int32)
    u = rng.integers(-1, 12, n).astype(np.int32)
    src = rng.integers(0, k, n).astype(np.int32)
    st = rng.integers(0, 1 << 6, n).astype(np.int32)
    conn = rng.random((k, n)) < 0.5
    lab_cols = rng.integers(0, 3, (k, n)).astype(np.int32)
    lab_u = rng.integers(0, 3, n).astype(np.int32)
    return emb, u, src, st, conn, lab_cols, lab_u


def _both(fn_port, fn_jax, k, labeled=False):
    emb, u, src, st, conn, lab_cols, lab_u = _spec_operands(k)
    t = lambda a: torch.from_numpy(a)
    port_args = (tuple(map(t, emb)), t(u), t(src), t(st), tuple(map(t, conn)))
    jax_args = (tuple(map(jnp.asarray, emb)), jnp.asarray(u),
                jnp.asarray(src), jnp.asarray(st),
                tuple(map(jnp.asarray, conn)))
    if labeled:
        port_args += (tuple(map(t, lab_cols)), t(lab_u))
        jax_args += (tuple(map(jnp.asarray, lab_cols)), jnp.asarray(lab_u))
    return (fn_port(*port_args).numpy(),
            np.asarray(fn_jax(*jax_args)))


@pytest.mark.parametrize("name", ["diamond", "house", "5-cycle",
                                  "tailed-triangle"])
def test_level_specs_equal_jax_predicates(name):
    port = TPS.compile_pattern(TPS.Pattern.named(name))
    want = JPS.compile_pattern(JPS.Pattern.named(name))
    for lp, jlp in zip(port.levels, want.levels):
        got, exp = _both(psm.make_level_spec(lp),
                         jax_psm.make_level_kernel_predicate(jlp),
                         lp.position)
        np.testing.assert_array_equal(got, exp)
    labels = [i % 3 for i in range(port.pattern.k)]
    lport = TPS.compile_pattern(dataclasses.replace(
        TPS.Pattern.named(name), labels=tuple(labels)))
    lwant = JPS.compile_pattern(dataclasses.replace(
        JPS.Pattern.named(name), labels=tuple(labels)))
    for lp, jlp in zip(lport.levels, lwant.levels):
        got, exp = _both(
            psm.make_labeled_level_spec(lp, lport.pattern.labels),
            jax_psm.make_labeled_level_kernel_predicate(
                jlp, lwant.pattern.labels), lp.position, labeled=True)
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("name", ["motifs4", "motifs5", "directed"])
def test_branch_set_specs_equal_jax_bits(name):
    port = TPS.compile_pattern_set(SETS[name][0]())
    want = JPS.compile_pattern_set(SETS[name][1]())
    for lvl, jlvl in zip(port.levels, want.levels):
        spec = psm.make_set_branch_spec(lvl)
        got, exp = _both(spec.bits, jax_psm.make_set_branch_bits(jlvl),
                         lvl[0].position)
        np.testing.assert_array_equal(got, exp)
        assert spec.words()[:3] == [3, 0, len(lvl)]


MC_MODES = ("set", "memo", "custom", "generic")


@pytest.mark.parametrize("backend", ["torch-ref", "cuda", "cuda-1p"])
def test_new_apps_key_their_plans_as_jax_does(backend):
    apps = [(make_mc_app(k, mode), jax_make_mc_app(k, mode))
            for k in (3, 4) for mode in MC_MODES]
    apps.append((pattern_app(TPS.Pattern.named("diamond")),
                 jax_psm.pattern_app(JPS.Pattern.named("diamond"))))
    apps.append((pattern_set_app(SETS["directed"][0]()),
                 jax_psm.pattern_set_app(SETS["directed"][1]())))
    for port_app, jax_app in apps:
        assert plan_app_key(port_app, backend) == \
            jax_plan_app_key(jax_app, backend)
        assert (port_app.name, port_app.directed_worklist,
                port_app.max_patterns, port_app.needs_reduce) == \
            (jax_app.name, jax_app.directed_worklist,
             jax_app.max_patterns, jax_app.needs_reduce)


def test_mc_app_errors_match_jax():
    for fn in (make_mc_app, jax_make_mc_app):
        with pytest.raises(ValueError, match="32-bit branch bitmap"):
            fn(6, "set")
        with pytest.raises(ValueError, match="explicit max_patterns"):
            fn(7, "generic")
    assert make_mc_app(6).max_patterns == jax_make_mc_app(6).max_patterns
