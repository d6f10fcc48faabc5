"""PyTorch port, the smoke script's kernel checks, run on the CPU.

``chip_smoke.py`` holds every kernel launch of the main path against the
kernel's plain version, piece by piece over slot ranges.  On the CPU the
wrappers run the plain versions themselves, so these tests show that the
pieces cover every output element and agree with the whole launch, and
that a wrong output of any kernel stops the run; the same for the FSM
phase's edge-kernel checks and its scipy count against the port, for the
single-pass ``extend_pruned_1p`` checks of the ``cuda-1p`` phase (pieces
with the survivor offset carried, the overflow rerun, the pair's buffers)
and for the ``intersect_count`` checks of the fused-TC phase.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import make_cf_app, make_tc_app
from repro_torch.graph.generators import rmat
from repro_torch.kernels.extend_fused import ops
from repro_torch.kernels.intersect import ops as intersect_ops

ROOT = Path(__file__).resolve().parents[1]
APPS = (("tc", make_tc_app()), ("4-cf", make_cf_app(4)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_and_counts(smoke):
    g = rmat(7, 8, seed=0, device="cpu")
    return g, dict(zip(("tc", "4-cf"), smoke.scipy_counts(g)))


@pytest.mark.parametrize("mode,pack", [("bitmap", 4 << 20), ("search", 0)])
def test_checks_hold_every_launch(mode, pack):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    checks = smoke.checked_runs(g, APPS, expected, "cpu", pack_max_bytes=pack,
                                keep="tc", chunk=512)
    assert min(checks.launches.values()) >= 2
    assert set(checks.err.values()) == {0}
    assert mode in checks.modes and checks.overflow_cases >= 1
    assert sorted(checks.kept) == sorted(smoke.REPLACES)
    assert ops.extend_scatter.__name__ == "extend_scatter"     # restored


def _wrong_candidates(fn):
    def run(*a, **kw):
        row, u, src_slot, conn = fn(*a, **kw)
        return row, u, src_slot, conn ^ (torch.arange(conn.shape[0]) == 5)
    return run


def _wrong_count(fn):
    def run(*a, **kw):
        counts = fn(*a, **kw).clone()
        counts[-1] += 1
        return counts
    return run


def _wrong_scatter(fn):
    def run(*a, **kw):
        row, u = fn(*a, **kw)
        return row, u[torch.tensor([1, 0] + list(range(2, u.shape[0])))]
    return run


@pytest.mark.parametrize("name,wrong", [
    ("extend_candidates", _wrong_candidates),
    ("extend_count", _wrong_count),
    ("extend_scatter", _wrong_scatter)])
def test_checks_stop_at_a_wrong_kernel(monkeypatch, name, wrong):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    monkeypatch.setattr(ops, name, wrong(getattr(ops, name)))
    with pytest.raises(AssertionError, match=f"{name}.*plain version"):
        smoke.checked_runs(g, APPS, expected, "cpu", chunk=512)


def _skewed_labeled_graph():
    """A labeled RMAT graph whose label 3 is rare: the FSM label mask drops
    it while other patterns stay frequent."""
    g = rmat(9, 8, seed=0, labels=4, device="cpu")
    fold = (g.labels == 3) & (torch.arange(g.n_vertices) % 8 != 0)
    g = dataclasses.replace(g, labels=torch.where(fold, 0, g.labels))
    return g, int(torch.bincount(g.labels).min()) + 1


def test_fsm_checks_hold_every_edge_launch():
    smoke = _smoke()
    g, ms = _skewed_labeled_graph()
    checks, dropped = smoke.fsm_checked(g, ms, "cpu", keep=True,
                                        chunk=1 << 16)
    assert dropped == [3]
    assert checks.launches == {"extend_edge": 3}
    assert checks.err == {"extend_edge": 0}
    cand_cap, total, survivors, masked = checks.edge_levels[0]
    assert cand_cap >= total > survivors > 0 and masked > 0
    assert sorted(checks.kept) == ["extend_edge"]
    assert ops.extend_edge.__name__ == "extend_edge"           # restored


def test_fsm_checks_stop_at_a_wrong_edge_kernel(monkeypatch):
    smoke = _smoke()
    g, ms = _skewed_labeled_graph()
    fn = ops.extend_edge

    def wrong(*a, **kw):
        row, s, u, new_eid, add = fn(*a, **kw)
        return row, s, u, new_eid, add ^ (torch.arange(add.shape[0]) == 7)
    monkeypatch.setattr(ops, "extend_edge", wrong)
    with pytest.raises(AssertionError, match="extend_edge.*plain version"):
        smoke.fsm_checked(g, ms, "cpu", chunk=1 << 16)


def test_scipy_fsm_count_matches_the_port():
    smoke = _smoke()
    g, ms = _skewed_labeled_graph()
    want, edges, freq = smoke.scipy_fsm(g, ms)
    from repro_torch.core import Miner, make_fsm_app
    r = Miner(g, make_fsm_app(3, ms), device="cpu").run()
    assert smoke.frequent_supports(r, ms) == want and len(want) == r.count
    assert sum(freq) == g.n_vertices and len(edges) == 10


LOOKBACK = dict(backend="cuda-1p", names=("extend_pruned_1p",))


@pytest.mark.parametrize("mode,pack", [("bitmap", 4 << 20), ("search", 0)])
def test_lookback_checks_hold_every_launch(mode, pack):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    checks = smoke.checked_runs(g, APPS, expected, "cpu", pack_max_bytes=pack,
                                keep="tc", chunk=512, **LOOKBACK)
    assert checks.launches == {"extend_pruned_1p": 6}
    assert checks.err == {"extend_pruned_1p": 0}
    assert checks.pair_matches == 6 and checks.overflow_cases >= 1
    assert mode in checks.modes and sorted(checks.kept) == [
        "extend_pruned_1p"]
    assert ops.extend_pruned_1p.__name__ == "extend_pruned_1p"  # restored


def _wrong_1p(fn):
    def run(*a, **kw):
        row, u, n_surv = fn(*a, **kw)
        return row, u[torch.tensor([1, 0] + list(range(2, u.shape[0])))], \
            n_surv
    return run


def _wrong_total(fn):
    def run(*a, **kw):
        row, u, n_surv = fn(*a, **kw)
        return row, u, n_surv + 1
    return run


@pytest.mark.parametrize("wrong", [_wrong_1p, _wrong_total],
                         ids=["order", "total"])
def test_lookback_checks_stop_at_a_wrong_kernel(monkeypatch, wrong):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    monkeypatch.setattr(ops, "extend_pruned_1p",
                        wrong(ops.extend_pruned_1p))
    with pytest.raises(AssertionError,
                       match="extend_pruned_1p.*plain version"):
        smoke.checked_runs(g, APPS, expected, "cpu", chunk=512, **LOOKBACK)


def test_lookback_checks_stop_where_the_pair_differs(monkeypatch):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    monkeypatch.setattr(ops, "extend_pruned",
                        _wrong_1p(ops.extend_pruned_1p))
    with pytest.raises(AssertionError, match="two-pass pair"):
        smoke.checked_runs(g, APPS, expected, "cpu", chunk=512, **LOOKBACK)


def test_intersect_checks_hold_every_pair():
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    checks = smoke.tc_fused_checked(g, expected["tc"], "cpu", keep=True,
                                    chunk=512)
    assert checks.launches == {"intersect_count": 1}
    assert checks.err == {"intersect_count": 0}
    a, kw = checks.kept["intersect_count"]
    assert a[1].shape[0] > 512 // kw["max_deg"]       # several pieces
    assert intersect_ops.intersect_count.__name__ == "intersect_count"


def test_intersect_checks_stop_at_a_wrong_kernel(monkeypatch):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    fn = intersect_ops.intersect_count

    def wrong(*a, **kw):
        out = fn(*a, **kw).clone()
        out[-1] += 1
        return out
    monkeypatch.setattr(intersect_ops, "intersect_count", wrong)
    with pytest.raises(AssertionError, match="intersect_count.*plain version"):
        smoke.tc_fused_checked(g, expected["tc"], "cpu", chunk=512)


def test_flash_checks_hold_every_serving_launch():
    """Every flash-attention launch of serve_lm, in pieces of query rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    smoke = _smoke()
    sets = {"A": (2, 120, 3), "B": (1, 200, 2)}
    checks = smoke.lm_checked(get_arch("qwen3-0.6b"), sets, smoke=True,
                              device="cpu", chunk=512)
    assert checks.launches == {"flash_attention": 4}   # 2 layers, 2 sets
    assert checks.err == {"flash_attention": 0.0}
    assert list(checks.layer0) == ["A", "B"]          # each set's layer 0
    assert tuple(checks.layer0["A"][0][0].shape) == (2, 4, 120, 32)
    assert tuple(checks.layer0["B"][0][0].shape) == (1, 4, 200, 32)
    assert flash_ops.flash_attention.__name__ == "flash_attention"


def test_flash_variants_name_the_wrappers_counts():
    """time_flash expects each dtype's variant by the names the wrapper
    counts under."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    smoke = _smoke()
    assert set(smoke.FLASH_VARIANTS.values()) == set(
        flash_ops.VARIANT_LAUNCHES)


def test_flash_checks_stop_at_a_wrong_kernel(monkeypatch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    smoke = _smoke()
    fn = flash_ops.flash_attention

    def wrong(*a, **kw):
        out = fn(*a, **kw).clone()
        out[:, :, -1] += 1e-3                          # the last query row
        return out
    monkeypatch.setattr(flash_ops, "flash_attention", wrong)
    with pytest.raises(AssertionError, match="rows 119..120"):
        smoke.lm_checked(get_arch("qwen3-0.6b"), {"A": (2, 120, 2)},
                         smoke=True, device="cpu", chunk=512)


def test_attention_pairs_count_the_causal_mask():
    smoke = _smoke()
    for lq, lk in ((1, 5), (3, 3), (4, 9), (4096, 4096)):
        rows = torch.arange(lq)[:, None] + (lk - lq)
        mask = torch.arange(lk)[None, :] <= rows
        assert smoke.attention_pairs(lq, lk) == int(mask.sum())
    assert smoke.attention_pairs(3, 7, causal=False) == 21


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_checks_hold_and_stop(monkeypatch, dtype):
    from repro_torch.kernels.segsum import ops as segsum_ops
    smoke = _smoke()
    g = torch.Generator().manual_seed(0)
    data = torch.randn(500, 20, generator=g).to(dtype)
    seg = torch.randint(-1, 31, (500,), generator=g, dtype=torch.int32)
    checks = smoke.KernelChecks(names=("sorted_segment_sum",))
    with checks:
        segsum_ops.sorted_segment_sum(data, seg, 30)
    assert checks.launches == {"sorted_segment_sum": 1}
    assert checks.err == {"sorted_segment_sum": 0.0}
    fn = segsum_ops.sorted_segment_sum
    monkeypatch.setattr(segsum_ops, "sorted_segment_sum",
                        lambda *a: fn(*a) + 0.5)
    with pytest.raises(AssertionError, match="not close"):
        with smoke.KernelChecks(names=("sorted_segment_sum",)):
            segsum_ops.sorted_segment_sum(data, seg, 30)


# -- the [mc] phase: the state, canonical and labeled variants

def _mc_runs(smoke, g):
    """A branch set with its state column (3-MC's trie) and the canonical
    variant (4-MC's memo mode), against the census."""
    from repro_torch.core import make_mc_app
    c3, c4 = smoke.motif_census(g, 3), smoke.motif_census(g, 4)
    return [("3-mc", make_mc_app(3), sum(c3), c3),
            ("4-mc memo", make_mc_app(4, "memo"), sum(c4), c4)]


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
def test_mc_checks_hold_every_launch(backend):
    smoke = _smoke()
    g = rmat(5, 8, seed=0, device="cpu")
    checks = smoke.mc_checked(g, _mc_runs(smoke, g), "cpu", backend=backend,
                              chunk=512)
    assert set(checks.err.values()) == {0}
    assert set(checks.launches) == set(smoke.MC_PATH_KERNELS[backend])
    assert min(checks.launches.values()) >= 3     # a cold inspection a level
    if backend == "cuda-1p":
        assert checks.pair_matches == checks.launches["extend_pruned_1p"]


def _wrong_state(fn):
    """Flip a bit of the first survivor's state in branch-set launches."""
    def run(*a, **kw):
        out = fn(*a, **kw)
        if kw["spec"].kind != "branches":
            return out
        out = list(out)
        out[2] = out[2].clone()
        out[2][0] ^= 1 << 7
        return tuple(out)
    return run


@pytest.mark.parametrize("backend,name", [("cuda", "extend_scatter"),
                                          ("cuda-1p", "extend_pruned_1p")])
def test_mc_checks_stop_at_a_wrong_state(monkeypatch, backend, name):
    smoke = _smoke()
    g = rmat(5, 8, seed=0, device="cpu")
    monkeypatch.setattr(ops, name, _wrong_state(getattr(ops, name)))
    with pytest.raises(AssertionError, match=f"{name}.*plain version"):
        smoke.mc_checked(g, _mc_runs(smoke, g), "cpu", backend=backend,
                         chunk=512)


def test_levels_equal_compares_the_state_column():
    import dataclasses as dc

    from repro_torch.core import Miner, make_mc_app
    smoke = _smoke()
    g = rmat(5, 8, seed=0, device="cpu")
    levels = Miner(g, make_mc_app(4), device="cpu").run().levels
    assert smoke.levels_equal(levels, levels) == 3
    bad = levels[:-1] + [dc.replace(levels[-1],
                                    state=levels[-1].state ^ 1)]
    with pytest.raises(AssertionError, match="state differs"):
        smoke.levels_equal(levels, bad)


def test_args_keeper_keeps_the_level_it_names():
    from repro_torch.core import Miner, make_mc_app
    smoke = _smoke()
    g = rmat(5, 8, seed=0, device="cpu")
    with smoke.ArgsKeeper(("extend_count", "extend_scatter"), k=3) as keep:
        Miner(g, make_mc_app(4), device="cpu").run()
    assert sorted(keep.kept) == ["extend_count", "extend_scatter"]
    assert all(kw["k"] == 3 and kw["state"] is not None
               for _, kw in keep.kept.values())
    assert ops.extend_count.__name__ == "extend_count"        # restored
    row = smoke.bytes_moved("extend_scatter", *keep.kept["extend_scatter"])
    a, kw = keep.kept["extend_scatter"]
    plain_kw = {**kw, "state": None}
    assert row - smoke.bytes_moved("extend_scatter", a, plain_kw) == \
        4 * (kw["state"].numel() + kw["out_cap"])
