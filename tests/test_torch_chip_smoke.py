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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def test_k6_paths_and_shuffled_pairs_keep_every_pair():
    """The ``[k6]`` line's counts cover every pair of the fused TC's
    launch, all of them past the gates on a DAG; the shuffled launch holds
    the same pairs in another order and counts the same triangles."""
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    checks = smoke.tc_fused_checked(g, expected["tc"], "cpu", keep=True)
    a, kw = checks.kept["intersect_count"]
    paths = smoke.k6_paths(a, kw, "cpu")
    assert sum(paths.values()) == a[1].shape[0] and paths["search"] == 0
    shuffled = smoke.shuffled_pairs(a)
    assert shuffled[0] is a[0]
    assert not torch.equal(shuffled[1], a[1])
    key = [sorted(zip(*(t.tolist() for t in x[1:]))) for x in (a, shuffled)]
    assert key[0] == key[1]
    assert smoke.k6_paths(shuffled, kw, "cpu") == paths
    assert (int(intersect_ops.intersect_count(*shuffled, **kw).sum())
            == expected["tc"])


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


# -- the [mixed] phase: partial and core packs, K1's mixed probe

@pytest.mark.parametrize("backend,names", [
    ("cuda", ("extend_candidates", "extend_count", "extend_scatter")),
    ("cuda-1p", ("extend_pruned_1p",))])
@pytest.mark.parametrize("opts", [dict(pack_partial=True),
                                  dict(relabel=True)],
                         ids=["partial", "core"])
def test_mixed_checks_hold_every_launch(backend, names, opts):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    checks = smoke.checked_runs(g, APPS, expected, "cpu", keep="tc",
                                chunk=512, backend=backend, names=names,
                                pack_max_bytes=512, **opts)
    assert "mixed" in checks.modes and set(checks.err.values()) == {0}
    assert min(checks.launches.values()) >= 2
    a, kw = checks.kept[names[-1]]
    twin = smoke.search_twin(kw)
    assert twin["conn_mode"] == "search" and "row_slot" not in twin
    # the mixed bound is the search bound and the row map, none of the pack
    assert smoke.bytes_moved(names[-1], a, kw) - smoke.bytes_moved(
        names[-1], a, twin) == 4 * kw["row_slot"].numel()


def test_mixed_rows_name_each_kernel_and_the_probe():
    smoke = _smoke()
    assert sorted(smoke.MIXED_REPLACES) == sorted(
        f"{name}:{row}" for name in smoke.PRUNED_REPLACES
        for row in smoke.MIXED_ROWS)
    assert set(smoke.MIXED_REPLACES.values()) == {smoke.MIXED_PROBE}
    # the budget is a quarter of RMAT-16's full pack: 65,536 rows of 2,048
    # words
    assert smoke.MIXED_BUDGET16 * 4 == 65536 * 2048 * 4


# -- the build phase: registers and spills per pruned instantiation

PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152323extend_pruned_1p_kernelILi0ENS_10BranchPredEEEvNS_6TablesEiNS_4PackET0_iPyPjPiS7_S7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152323extend_pruned_1p_kernelILi0ENS_10BranchPredEEEvNS_6TablesEiNS_4PackET0_iPyPjPiS7_S7_S7_
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 24960 bytes smem
ptxas info    : Compile time = 321.751 ms
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152319extend_count_kernelILi2ENS_8ConjPredILb1EEEEEvNS_6TablesEiNS_4PackET0_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152319extend_count_kernelILi2ENS_8ConjPredILb1EEEEEvNS_6TablesEiNS_4PackET0_Pi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 20496 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152318extend_edge_kernelILi1EEEvNS_10EdgeTablesEiPiS2_S2_S2_S2_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152318extend_edge_kernelILi1EEEvNS_10EdgeTablesEiPiS2_S2_S2_S2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers, 560 bytes cmem[0]
"""


def test_build_report_gives_each_instantiations_resources():
    smoke = _smoke()
    res = smoke.instance_resources(PTXAS_REPORT)
    assert res == {
        ("extend_pruned_1p", "branches", "search"): dict(
            registers=40, spill_stores=16, spill_loads=12, stack=16,
            smem=24960),
        ("extend_count", "labeled", "mixed"): dict(
            registers=32, spill_stores=0, spill_loads=0, stack=0,
            smem=20496)}
    from repro_torch.kernels.build import kernel_resources
    edge = [v for name, v in kernel_resources(PTXAS_REPORT).items()
            if "extend_edge" in name]
    assert edge == [dict(registers=26, spill_stores=0, spill_loads=0,
                         stack=0, smem=0)]


def test_instance_of_names_the_launched_instantiation():
    from repro_torch.core.api import CANONICAL, PredicateSpec
    smoke = _smoke()
    labeled = PredicateSpec(required=1, label=1)
    assert labeled.needs_labels
    assert smoke.instance_of("extend_scatter", dict(
        spec=labeled, conn_mode="bitmap")) == (
        "extend_scatter", "labeled", "bitmap")
    assert smoke.instance_of("extend_count", dict(
        spec=CANONICAL, conn_mode="mixed")) == (
        "extend_count", "canonical", "mixed")


K3_REPORT = """\
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152324extend_candidates_kernelENS_6TablesEiPiS1_S1_S1_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__fa0614d1_9_extend_cu_6218152324extend_candidates_kernelENS_6TablesEiPiS1_S1_S1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 20496 bytes smem
"""


def test_build_report_gives_the_enumerators_resources():
    smoke = _smoke()
    assert smoke.enumerator_resources(PTXAS_REPORT + K3_REPORT) == {
        ("extend_edge", 1): dict(registers=26, spill_stores=0,
                                 spill_loads=0, stack=0, smem=0),
        ("extend_candidates", None): dict(registers=30, spill_stores=0,
                                          spill_loads=0, stack=0,
                                          smem=20496)}
    assert smoke.enumerator_of("extend_edge", dict(n_slots=3)) == (
        "extend_edge", 2)
    assert smoke.enumerator_of("extend_candidates", dict(k=3)) == (
        "extend_candidates", None)


def test_checks_keep_the_largest_candidates_launch(monkeypatch):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    seen = []
    fn = ops.extend_candidates

    def record(*a, **kw):
        seen.append((kw["k"], kw["cand_cap"]))
        return fn(*a, **kw)
    monkeypatch.setattr(ops, "extend_candidates", record)
    checks = smoke.checked_runs(g, APPS, expected, "cpu", keep="tc",
                                largest="4-cf", chunk=512,
                                names=("extend_candidates",))
    _, kw = checks.kept.pop("extend_candidates:4-cf")
    # TC enumerates level 2 (k = 2), then 4-CF levels 2 and 3, cold only
    assert [k for k, _ in seen] == [2, 2, 3]
    assert kw["cand_cap"] == max(cap for _, cap in seen[1:])
    assert sorted(checks.kept) == ["extend_candidates"]
    assert checks.kept["extend_candidates"][1]["k"] == 2


def test_tail_slots_count_the_constant_tail():
    """The slots tail_slots counts hold one value in every output of the
    plain versions, and lie past the total."""
    from repro_torch.kernels.extend_fused import ref
    smoke = _smoke()
    g = rmat(7, 8, seed=0, device="cpu")
    emb = torch.randint(0, g.n_vertices, (40, 3), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    emb[-1] = 0                        # the last parent's row starts at 0
    embc = emb.reshape(-1).long()
    vlo, vhi = g.row_ptr[embc], g.row_ptr[embc + 1]
    deg = (vhi - vlo).to(torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    a = (g.col_idx, offsets, offsets - deg, emb.reshape(-1), vlo, vhi)
    total, m = int(offsets[-1]), g.col_idx.shape[0]
    kw = dict(k=3, cand_cap=total + m + 500, n_steps=8)
    tail = smoke.tail_slots("extend_candidates", a, kw)
    assert 500 <= tail < kw["cand_cap"] - total
    row, u, src_slot, conn = ref.extend_candidates_ref(*a, **kw)
    for out in (row, u, src_slot, conn):
        assert bool((out[-tail:] == out[-1]).all())
    # the slot before the tail still reads col[m - 2]
    assert int(u[-tail - 1]) == int(g.col_idx[m - 2])
    assert smoke.tail_slots("extend_candidates", a,
                            dict(kw, cand_cap=total - 1)) == 0
    # K5's tail is every slot past the total
    assert smoke.tail_slots("extend_edge", (None, None, offsets),
                            dict(cand_cap=total + 77)) == 77


def test_k3_shapes_count_each_candidates_call():
    smoke = _smoke()
    g, _ = _graph_and_counts(smoke)
    from repro_torch.core import Miner
    smoke.K3_SHAPES.clear()
    seen = []
    fn = ops.extend_candidates
    with smoke.counting_k3_shapes():
        inner = ops.extend_candidates
        ops.extend_candidates = lambda *a, **kw: (
            seen.append((kw["k"], kw["cand_cap"])), inner(*a, **kw))[1]
        try:
            Miner(g, make_cf_app(4), device="cpu").run()
        finally:
            ops.extend_candidates = inner
    assert ops.extend_candidates is fn                       # restored
    assert seen and dict(smoke.K3_SHAPES) == {
        shape: seen.count(shape) for shape in seen}
    assert {k for k, _ in seen} == {2, 3}


def test_e2e_samples_time_fresh_miners_and_hold_the_count():
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    out = smoke.e2e_samples(g, "tc", make_tc_app(), expected["tc"], "cuda",
                            n=3)
    for run in ("cold", "warm"):
        med, lo, hi = out[run]
        assert 0 < lo <= med <= hi
    with pytest.raises(AssertionError, match="tc cuda cold"):
        smoke.e2e_samples(g, "tc", make_tc_app(), expected["tc"] + 1,
                          "cuda", n=1)


# -- the [plan] and [blocks] phases: estimated, transferred and blocked runs


def _plan_runs(smoke, g, expected):
    from repro_torch.core import make_mc_app
    c3 = smoke.motif_census(g, 3)
    return [("tc", make_tc_app(), expected["tc"], None),
            ("4-cf", make_cf_app(4), expected["4-cf"], None),
            ("3-mc", make_mc_app(3), sum(c3), c3)]


def _small_graph_and_counts(smoke):
    g = rmat(5, 8, seed=0, device="cpu")
    return g, dict(zip(("tc", "4-cf"), smoke.scipy_counts(g)))


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
def test_plan_checks_hold_every_launch_the_probes_included(backend):
    from repro_torch.core.plan import SAMPLE_CAND_CAP
    smoke = _smoke()
    g, expected = _small_graph_and_counts(smoke)
    checks = smoke.mc_checked(g, _plan_runs(smoke, g, expected), "cpu",
                              pack_max_bytes=0, backend=backend, chunk=4096,
                              run_kw={"plan_source": "estimate"},
                              names=smoke.PRUNED_PATH[backend])
    assert set(checks.err.values()) == {0}
    assert set(checks.launches) == set(smoke.PRUNED_PATH[backend])
    assert checks.cand_caps[SAMPLE_CAND_CAP] >= 3         # a probe an app
    for name in ("tc", "4-cf", "3-mc"):
        (plan,) = checks.plans[name]
        assert plan[3] in ("estimated", "grown")
        smoke.check_plans(name, checks.plans[name], ("estimated", "grown"))


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
def test_blocked_checks_hold_every_launch(backend):
    smoke = _smoke()
    g, expected = _small_graph_and_counts(smoke)
    checks = smoke.mc_checked(g, _plan_runs(smoke, g, expected), "cpu",
                              pack_max_bytes=0, backend=backend, chunk=512,
                              run_kw={"block_size": 40})
    assert set(checks.err.values()) == {0}
    # the first block is inspected (K3), the rest replay the plan
    assert checks.launches["extend_candidates"] >= 3
    assert all(p[0][0] == 128 for p in checks.plans.values())


def test_fsm_plan_checks_hold_every_edge_launch():
    smoke = _smoke()
    g = rmat(6, 8, seed=0, labels=4, device="cpu")
    ms = min(smoke.scipy_fsm(g, 0)[2]) + 1
    checks, _ = smoke.fsm_checked(g, ms, "cpu", chunk=4096,
                                  run_kw={"plan_source": "estimate"},
                                  n_launches=None)
    assert checks.err == {"extend_edge": 0}
    assert checks.launches["extend_edge"] >= 3          # probe, cold, warm
    smoke.check_plans("cpu", checks.plans["cpu"], ("estimated", "grown"))


def test_check_plans_refuses_unclipped_or_misnamed_plans():
    smoke = _smoke()
    ok = (128, [(1 << 30, 1 << 29)], [], "estimated", 0)
    smoke.check_plans("ok", [ok], ("estimated",))
    for bad in ((128, [(1 << 31, 128)], [], "estimated", 0),
                (128, [(256, 512)], [], "estimated", 0),
                (128, [(256, 128)], [1 << 31], "estimated", 0),
                (128, [(256, 128)], [], "grown", 0),
                (128, [(256, 128)], [], "estimated", 1),
                (128, [(256, 128)], [], "inspect", 0)):
        with pytest.raises(AssertionError):
            smoke.check_plans("bad", [bad], ("estimated", "grown"))
    with pytest.raises(AssertionError, match="no plan"):
        smoke.check_plans("none", [], ("estimated",))


def test_wedge_census_and_block_candidates_count_what_the_miner_sees():
    from repro_torch.core import Miner, make_mc_app
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    assert smoke.wedge_census(g, expected["tc"]) == smoke.motif_census(g, 3)
    m = Miner(g, make_mc_app(3), device="cpu")
    (level2,) = m.run(collect_stats=True).stats
    per = smoke.block_candidates(m, 100)
    assert sum(per) == level2.n_candidates
    assert len(per) == -(-int(m.init_edges()[0].shape[0]) // 100)


def test_note_launches_adds_each_run_to_its_rows():
    smoke = _smoke()
    launches = {"extend_count": 1, "extend_count:branches": 0,
                "extend_count:clique-mixed-core": 0}
    smoke.note_launches(launches, {"extend_count": 5},
                        {("extend_count", "branches", "search"): 2,
                         ("extend_count", "clique", "mixed"): 3,
                         ("extend_count", "clique", "search"): 4},
                        pack="core")
    assert launches == {"extend_count": 6, "extend_count:branches": 2,
                        "extend_count:clique-mixed-core": 3}


def test_e2e_samples_pass_the_run_options():
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    out = smoke.e2e_samples(g, "tc", make_tc_app(), expected["tc"], "cuda",
                            n=2, run_kw={"plan_source": "estimate"})
    assert set(out) == {"cold", "warm"}


def _smoke_by_name(monkeypatch):
    """The smoke script imported by its module name, so that spawned ranks
    find its rank function."""
    import importlib
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("chip_smoke")


def test_sharded_checks_and_shared_ranks_hold(monkeypatch, tmp_path):
    """The [sharded] phase's pieces at a small size on the CPU: a world of
    one over gloo, every launch checked, each answer Miner.run's and
    scipy's; then four gloo ranks from the single-process caps scaled to
    their block, each rank's first round checked launch by launch, each
    rank's answer the world of one's."""
    smoke = _smoke_by_name(monkeypatch)
    from repro_torch.core import make_fsm_app
    from repro_torch.core.blocks import scale_caps
    from repro_torch.core.plan import bucket_pow2
    from repro_torch.launch import mesh
    g, expected = _graph_and_counts(smoke)
    gl, ms = rmat(7, 8, seed=0, labels=3, device="cpu"), 2
    fsm = make_fsm_app(3, ms, max_patterns=64)
    world1, plans = {}, {}
    group, _ = mesh.init_group(str(tmp_path / "store"), 0, 1, "gloo", "cpu")
    try:
        for name, graph, app, backend in (
                ("tc", g, make_tc_app(), "cuda"),
                ("4-cf", g, make_cf_app(4), "cuda-1p"),
                ("3-fsm", gl, fsm, "cuda")):
            want, plans[name], _ = smoke.single_card_plan(graph, app,
                                                          backend)
            caps, fcaps, _ = plans[name]
            edge = app.kind == "edge"
            names = (tuple(smoke.EDGE_REPLACES) if edge
                     else smoke.PRUNED_PATH[backend])
            result, checks = smoke.sharded_checked(
                group, graph, app, caps, fcaps if edge else None, backend,
                names, "cpu", chunk=512)
            assert set(checks.err.values()) == {0}
            world1[name] = smoke.sharded_result(result)
            assert world1[name] == want
            if not edge:
                assert want[0] == expected[name]
    finally:
        mesh.close_group()
    assert world1["3-fsm"][0] == len(smoke.scipy_fsm(gl, ms)[0]) > 0
    jobs = []
    for name, gargs, aargs in (("tc", (7, 8, 0, None), ("tc",)),
                               ("3-fsm", (7, 8, 0, 3), ("3-fsm", ms))):
        caps, fcaps, m = plans[name]
        ratio = 2 * bucket_pow2(-(-m // 4)) / bucket_pow2(m)
        caps, fcaps = scale_caps(caps, fcaps, ratio)
        jobs.append((name, gargs, aargs, caps,
                     fcaps if name == "3-fsm" else None, "cuda"))
    ranks = mesh.spawn(smoke.shared_card_rank, 4, backend="gloo",
                       device="cpu", args=(jobs,))
    assert len(ranks) == 4
    for out in ranks:
        for name in ("tc", "3-fsm"):
            assert out[name]["result"] == world1[name]
            assert out[name]["rounds"] >= 1
            assert min(out[name]["checked"].values()) >= 1
            assert set(out[name]["err"].values()) == {0}


def test_cli_checked_validates_both_exports(tmp_path):
    smoke = _smoke()
    g, expected = _graph_and_counts(smoke)
    r = smoke.cli_checked(["--graph", "rmat:7", "--app", "tc", "--device",
                           "cpu"], tmp_path, "tc")
    from repro_torch.launch.mine import load_graph
    assert r.count == smoke.scipy_counts(load_graph("rmat:7",
                                                    device="cpu"))[0]
    assert (tmp_path / "tc.trace.json").exists()
    from repro_torch.obs import trace
    assert not trace.on


def test_lint_phase_passes_on_the_port(capsys):
    _smoke().lint_phase()
    out = capsys.readouterr().out
    assert out.startswith("[lint] 0 findings in ") and ".cu files" in out


def test_packed_reduce_check_equals_the_dense_path(monkeypatch, capsys):
    """The world-1 packed-reduce check, on one local rank with the sync
    check made a plain call (the CPU has no device syncs to catch)."""
    from repro_torch.core import make_fsm_app
    smoke = _smoke()
    monkeypatch.setattr(smoke, "sync_free", lambda fn: fn())
    g, ms = _skewed_labeled_graph()
    smoke.packed_reduce_sync_free(None, g, make_fsm_app(3, ms), "cuda")
    assert "no device sync in the whole reduce_domain_sharded(packed=True)" \
        in capsys.readouterr().out


def test_moe_checks_keep_layer0_input_and_every_route():
    """The [moe] phase's helpers on the DeepSeek-MoE SMOKE model: every
    flash launch checked (head dim 16 padded to 32), the first MoE call's
    tokens and weights kept, each route call's experts recorded."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    smoke = _smoke()
    arch = get_arch("deepseek-moe-16b")
    with smoke.first_moe_input(40) as kept, \
            smoke.recorded_routes() as routes:
        checks = smoke.lm_checked(arch, {"A": (2, 60, 3)}, smoke=True,
                                  device="cpu", chunk=512, label="moe")
    assert checks.launches == {"flash_attention": 2}
    assert tuple(checks.layer0["A"][0][0].shape) == (2, 4, 60, 32)
    assert tuple(kept["x"].shape) == (40, 64)
    assert sorted(kept["params"]) == sorted(
        ["router", "w1", "w2", "w3", "shared_w1", "shared_w2", "shared_w3"])
    assert tuple(kept["params"]["w1"].shape) == (8, 64, 32)   # one layer
    # 2 layers of the prefill (120 tokens) and of 2 decode steps (2 tokens)
    assert [tuple(r.shape) for r in routes] == [(120, 2)] * 2 + [(2, 2)] * 4
    assert moe.apply_moe.__name__ == "apply_moe"
    assert moe.route.__name__ == "route"
    out = smoke.moe_layer_against_cpu(kept["x"], kept["params"],
                                      arch.smoke.moe)
    assert out["dispatch_diff"] == [] and out["y_err"] == 0.0
    assert out["capacity"] == moe.capacity(40, arch.smoke.moe) == 20


def test_route_flips_count_each_differing_expert_set():
    smoke = _smoke()
    a = [torch.tensor([[0, 1], [2, 3], [4, 5]]), torch.tensor([[1, 2]])]
    same = [torch.tensor([[1, 0], [2, 3], [5, 4]]), torch.tensor([[2, 1]])]
    assert smoke.route_flips(a, same) == 0         # sets, not orders
    b = [torch.tensor([[0, 1], [2, 4], [4, 5]]), torch.tensor([[1, 3]])]
    assert smoke.route_flips(a, b) == 2
    assert smoke.route_flips(a, b[:1]) == 2        # a call only a made
    assert smoke.route_flips(a, [a[0][:2], a[1]]) == 3     # another shape


def test_dispatch_diff_names_each_differing_field():
    from repro_torch.models import moe
    smoke = _smoke()
    cfg = moe.MoEConfig(n_routed=4, top_k=2, d_ff=8, capacity_factor=0.5)
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe(16, cfg, torch.float32, g, torch.device("cpu"))
    x = torch.randn(24, 16, generator=g)
    r = moe.route(params, x, cfg)
    assert smoke.dispatch_diff(r, moe.route(params, x, cfg)) == []
    wrong = r._replace(keep=~r.keep, capacity=r.capacity + 1)
    assert smoke.dispatch_diff(r, wrong) == ["keep", "capacity"]


def test_f32_config_cuts_only_the_depth():
    import dataclasses
    from repro_torch.configs.registry import get_arch
    smoke = _smoke()
    arch = get_arch(smoke.MOE_ARCH)
    cfg = smoke.f32_config(arch, smoke.MOE_F32_LAYERS)
    assert (cfg.n_layers, cfg.dtype) == (4, "float32")
    want = dataclasses.replace(arch.config, n_layers=4, dtype="float32")
    assert cfg == want and cfg.moe == arch.config.moe
    assert smoke.f32_config(arch).n_layers == 28


def test_recsys_helpers_copy_trees_to_the_cpu():
    smoke = _smoke()
    tree = {"a": torch.ones(2), "mlp": [{"w": torch.zeros(1)}]}
    out = smoke.on_cpu(tree)
    assert isinstance(out["mlp"], list) and out["mlp"][0]["w"].shape == (1,)
    assert smoke.RECSYS_CPU_CANDIDATES <= 1_000_000


def test_train_checks_hold_every_launch_of_the_steps():
    """The [train] phase's checked run on the Qwen3 SMOKE model on the CPU:
    one check a layer a step (no remat in SMOKE), the first launch's
    arguments kept; the launch formula counts the remat recompute and
    the microbatches."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    smoke = _smoke()
    args = smoke.train_args(smoke.TRAIN_ARCH, 2, 4, 16, "--smoke",
                            "--device", "cpu")
    checks = smoke.train_checked(args, chunk=512)
    cfg = get_arch(smoke.TRAIN_ARCH).smoke
    assert checks.launches["flash_attention"] == \
        smoke.train_launches(cfg, 1, 2) == 4
    assert checks.err["flash_attention"] == 0.0
    assert tuple(checks.kept["flash_attention"][0][0].shape) == (4, 4, 16, 32)
    full = get_arch(smoke.TRAIN_ARCH).config
    assert smoke.train_launches(full, 4, smoke.TRAIN_STEPS) == 672
    assert smoke.train_launches(dataclasses.replace(full, remat=False), 4,
                                3) == 336


@pytest.mark.parametrize("causal", [True, False])
def test_attention_grad_check_pieces_cover_every_row(causal):
    """The reference of the [train] phase's ``attention_grad`` check:
    autograd through the plain version over pieces of query rows equals
    the whole, and ``attention_grad`` within f32 rounding of it."""
    from repro_torch.kernels.flash_attention import grad, ref
    smoke = _smoke()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 4, 10, 32), (2, 2, 14, 32), (2, 2, 14, 32)))
    dout = torch.randn(q.shape, generator=g)
    whole = smoke.autograd_attention_ref(q, k, v, dout, causal)
    pieces = smoke.autograd_attention_ref(q, k, v, dout, causal, rows=3)
    out = ref.attention_ref(q, k, v, causal=causal)
    got = grad.attention_grad(q, k, v, out, dout, causal)
    for w, p, x in zip(whole, pieces, got):
        torch.testing.assert_close(p, w, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(x, w, atol=1e-5, rtol=1e-5)
    tree = smoke.on_device({"a": [torch.ones(1)]}, "cpu")
    assert isinstance(tree["a"], list)


# -- the [gnn] phase: the GNN train cells, K7 on their message passing

def _gnn_smoke_cell(smoke, arch_id, shape, **changes):
    """The SMOKE cell of (arch, shape) from ``gnn_cell``, its config
    changed as the phase cuts depth, and a small batch on the CPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import node_classification_data
    from repro_torch.launch import steps as S
    cell = smoke.gnn_cell(arch_id, shape, smoke=True, **changes)
    plain = S.build_cell(arch_id, shape, smoke=True)
    assert cell.cfg == dataclasses.replace(plain.cfg, **changes)
    assert get_arch(arch_id).smoke.n_layers == plain.cfg.n_layers
    cfg = cell.cfg
    if shape == "molecule":
        batch = smoke.joined_molecules(3, 8, "cpu")
    elif arch_id == "graphsage-reddit" and shape == "minibatch_lg":
        batch = smoke.sampled_blocks(
            {"n_nodes": 300, "batch_nodes": 8, "fanout": cfg.sample_sizes},
            cfg.d_in, cfg.n_classes, "cpu")
    else:
        batch = node_classification_data(0, 60, cfg.d_in, cfg.n_classes,
                                         device="cpu")
    return cell, batch


GNN_VARIANTS = [("gat-cora", "full_graph_sm", {}),
                ("graphsage-reddit", "full_graph_sm", {}),
                ("graphsage-reddit", "minibatch_lg", {}),
                ("nequip", "molecule", {}),
                ("nequip", "molecule", {"n_layers": 1}),
                ("equiformer-v2", "molecule", {}),
                ("equiformer-v2", "molecule", {"n_layers": 1}),
                ("equiformer-v2", "molecule", {"edge_chunk": 64})]


@pytest.mark.parametrize("arch_id,shape,changes", GNN_VARIANTS,
                         ids=lambda x: str(x))
def test_gnn_checks_hold_and_count_every_k7_launch(arch_id, shape, changes):
    """One step of each GNN cell on the CPU with every ``segment_sum``
    launch checked: as many as ``gnn_launches`` works out (a depth cut,
    EquiformerV2's edge chunks and the double backward's unreached sums
    included), and EquiformerV2's first aggregation kept
    at its ``[E, C (l_max+1)^2]`` width."""
    from repro_torch.kernels.segsum import ops as segsum_ops
    from repro_torch.kernels.segsum import ref as segsum_ref
    from repro_torch.train.optimizer import init_opt_state
    smoke = _smoke()
    cell, batch = _gnn_smoke_cell(smoke, arch_id, shape, **changes)
    params = cell.param_init(torch.Generator().manual_seed(0), device="cpu")
    state = init_opt_state(params, cell.opt_cfg)
    segsum_ref.sorted_segment_sum_ref.calls = 0
    new_p, new_s, checks, kept = smoke.gnn_checked(arch_id, shape, cell,
                                                   params, state, batch)
    want = smoke.gnn_launches(arch_id, cell.cfg, batch)
    assert checks.launches == {"sorted_segment_sum": want}
    assert checks.err["sorted_segment_sum"] == 0.0   # the same op on a CPU
    assert int(new_s["step"]) == 1
    assert segsum_ops.sorted_segment_sum.__name__ == "sorted_segment_sum"
    if arch_id == "equiformer-v2":
        (data, ids, n), _ = kept["args"]
        assert tuple(data.shape) == (len(batch["edge_src"]) if "edge_chunk"
                                     not in changes else 64,
                                     cell.cfg.d_hidden * cell.cfg.sph_dim)
        assert n == len(batch["species"]) and not data.requires_grad
    else:
        assert not kept
    expected = {"nequip": {(): 7, ("n_layers",): 3},
                "equiformer-v2": {(): 15, ("n_layers",): 7,
                                  ("edge_chunk",): 31}}
    if arch_id in expected:
        assert want == expected[arch_id][tuple(changes)]


@pytest.mark.parametrize("arch_id,shape", [("gat-cora", "full_graph_sm"),
                                           ("nequip", "molecule"),
                                           ("equiformer-v2", "molecule")])
def test_gnn_against_cpu_passes_the_same_step_and_stops_a_wrong_one(
        arch_id, shape, monkeypatch):
    """The card-against-CPU step with the CPU in the card's place passes;
    the forward's energy (the potentials') or logits (GAT's) scaled by 1 +
    1e-3 on the card's side fails it."""
    smoke = _smoke()
    cell, batch = _gnn_smoke_cell(smoke, arch_id, shape)
    smoke.gnn_against_cpu(arch_id, shape, cell, batch, card="cpu")
    mod = smoke.gnn_model(arch_id)
    fn, seen = mod.forward, []
    card_calls = 2 if "positions" in batch else 1      # loss, prediction

    def scaled_once(*a, **kw):
        out = fn(*a, **kw)
        seen.append(1)
        if len(seen) > card_calls:
            return out
        if isinstance(out, tuple):
            return (out[0] * (1 + 1e-3), *out[1:])
        return out * (1 + 1e-3)
    monkeypatch.setattr(mod, "forward", scaled_once)
    with pytest.raises(AssertionError, match="differs from the CPU's"):
        smoke.gnn_against_cpu(arch_id, shape, cell, batch, card="cpu")


def test_nearest_pairs_keep_the_molecule_shapes_edges():
    """Each molecule keeps its ``pairs`` nearest atom pairs, both ways;
    with every pair kept, the joined batch's edges as a set."""
    smoke = _smoke()
    b = smoke.joined_molecules(3, 6, "cpu")
    cut = smoke.nearest_pairs(b, 3, 6, 4)
    s, t = cut["edge_src"].long(), cut["edge_dst"].long()
    assert len(s) == 2 * 3 * 4 and cut["edge_src"].dtype == b["edge_src"].dtype
    assert bool((s // 6 == t // 6).all()) and bool((s != t).all())
    assert sorted(zip(s.tolist(), t.tolist())) == \
        sorted(zip(t.tolist(), s.tolist()))
    d = (b["positions"][s] - b["positions"][t]).norm(dim=-1)
    for m in range(3):
        p = b["positions"][6 * m:6 * m + 6]
        all_d = torch.pdist(p).sort().values
        torch.testing.assert_close(d[(s // 6 == m) & (s < t)].sort().values,
                                   all_d[:4])
    full = smoke.nearest_pairs(b, 3, 6, 15)
    assert sorted(zip(full["edge_src"].tolist(),
                      full["edge_dst"].tolist())) == \
        sorted(zip(b["edge_src"].tolist(), b["edge_dst"].tolist()))


@pytest.mark.parametrize("on", [False, True], ids=["plain", "remat"])
def test_layer_remat_sets_each_models_layers_and_restores_them(on):
    """``layer_remat`` runs each layer of either potential plainly or
    under one checkpoint, whichever the model does itself, and puts the
    model back."""
    import torch.utils.checkpoint as ckpt
    from repro_torch.models.gnn import equiformer_v2, nequip
    smoke = _smoke()
    for mod in (nequip, equiformer_v2):
        layer, own = mod._layer, getattr(mod, "checkpoint", None)
        with smoke.layer_remat(mod, on):
            assert (mod._layer is not layer) == on
            if own is not None:
                assert mod.checkpoint(lambda x: x + 1, 1,
                                      use_reentrant=False) == 2
        assert mod._layer is layer
        assert getattr(mod, "checkpoint", None) is own
    assert equiformer_v2.checkpoint is ckpt.checkpoint
    assert smoke.GNN_MEMORY[-1] == ("equiformer-v2", 12, 64)


def test_gnn_checks_stop_at_a_wrong_kernel(monkeypatch):
    from repro_torch.kernels.segsum import ops as segsum_ops
    from repro_torch.train.optimizer import init_opt_state
    smoke = _smoke()
    cell, batch = _gnn_smoke_cell(smoke, "nequip", "molecule")
    params = cell.param_init(torch.Generator().manual_seed(0), device="cpu")
    fn = segsum_ops.sorted_segment_sum

    def wrong(data, ids, n):
        out = fn(data, ids, n).clone()
        out[-1, -1] += 1e-3 * (1 + out[-1, -1].abs())
        return out
    monkeypatch.setattr(segsum_ops, "sorted_segment_sum", wrong)
    with pytest.raises(AssertionError, match="not close"):
        smoke.gnn_checked("nequip", "molecule", cell, params,
                          init_opt_state(params, cell.opt_cfg), batch)


def test_segsum_check_allows_rounding_and_stops_at_a_missing_term():
    """The f32 check's bound, 2.02 (n - 1) u S: the same terms summed in
    reverse order (large terms that cancel) pass; a sum missing one term
    fails; a one-row segment must be exact."""
    smoke = _smoke()
    from repro_torch.kernels.segsum import ref
    g = torch.Generator().manual_seed(0)
    data = torch.randn(400, 6, generator=g) * 1e4
    data[::40] = torch.randn(10, 6, generator=g)      # small terms too
    seg = torch.sort(torch.randint(0, 13, (400,), generator=g,
                                   dtype=torch.int32)).values
    want = ref.sorted_segment_sum_ref(data, seg, 13)
    rev = ref.sorted_segment_sum_ref(data.flip(0), seg.flip(0), 13)
    # the reversed order rounds differently, within the bound
    assert not torch.equal(rev, want)
    assert smoke.check_segsum((data, seg, 13), {}, rev) > 0
    # a missing large term is far outside it
    short = ref.sorted_segment_sum_ref(data[1:], seg[1:], 13)
    with pytest.raises(AssertionError, match="not close"):
        smoke.check_segsum((data, seg, 13), {}, short)
    # one row: exact
    one = torch.tensor([[1.5, -2.0]])
    ids = torch.tensor([0], dtype=torch.int32)
    assert smoke.check_segsum((one, ids, 1), {}, one.clone()) == 0.0
    with pytest.raises(AssertionError, match="not close"):
        smoke.check_segsum((one, ids, 1), {}, one + 1e-7)
    bound = smoke.segsum_bound(data, seg, 13)
    assert bound.shape == (13, 6) and bool((bound > 0).all())


@pytest.mark.parametrize("planted", [float("nan"), float("inf")])
def test_segsum_check_stops_at_a_nan_or_inf(planted):
    """A NaN or an infinity in the kernel's output, where the plain
    version's sum is finite, fails the f32 check; infinities that both
    sides give pass, as ``assert_close`` lets them."""
    smoke = _smoke()
    from repro_torch.kernels.segsum import ref
    g = torch.Generator().manual_seed(0)
    data = torch.randn(50, 4, generator=g)
    seg = torch.sort(torch.randint(0, 5, (50,), generator=g,
                                   dtype=torch.int32)).values
    got = ref.sorted_segment_sum_ref(data, seg, 5)
    got[2, 1] = planted
    with pytest.raises(AssertionError, match="not close.*flat index 9 "):
        smoke.check_segsum((data, seg, 5), {}, got)
    data[seg == 3] = float("inf")
    want = ref.sorted_segment_sum_ref(data, seg, 5)
    assert bool(torch.isinf(want[3]).all())
    smoke.check_segsum((data, seg, 5), {}, want.clone())


def test_joined_molecules_and_sampled_blocks_keep_the_shapes():
    smoke = _smoke()
    from repro_torch.data.pipeline import molecule_batch
    b = smoke.joined_molecules(3, 5, "cpu")
    assert tuple(b["positions"].shape) == (15, 3)
    assert len(b["edge_src"]) == 3 * 20 and int(b["edge_dst"].max()) == 14
    parts = [molecule_batch(0, i, 5, device="cpu") for i in range(3)]
    assert float(b["energy"]) == pytest.approx(
        sum(float(p["energy"]) for p in parts), rel=1e-6)
    assert torch.equal(b["edge_src"][20:40], parts[1]["edge_src"] + 5)
    blocks = smoke.sampled_blocks({"n_nodes": 200, "batch_nodes": 6,
                                   "fanout": (3, 2)}, 7, 4, "cpu")
    assert [tuple(x.shape) for x in blocks["feat_blocks"]] == [
        (6, 7), (18, 7), (36, 7)]
    assert tuple(blocks["labels"].shape) == (6,)


def test_gnn_cells_are_the_configs_widths_and_the_row_names_k7():
    """The phase's cells at CONFIG width, a depth cut and nothing else
    changed; EquiformerV2 at 2 layers on every joined edge and at all 12
    on the molecule shape's edges; its JSON row points at the segment-sum
    kernel."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    smoke = _smoke()
    assert [c[2:] for c in smoke.GNN_CELLS
            if c[0] == "equiformer-v2"] == [(2, None), (None, 64)]
    shp = get_arch("equiformer-v2").shapes["molecule"]
    assert 2 * shp["n_edges"] == 128 == 2 * smoke.GNN_CELLS[-1][3]
    for arch_id, shape, depth, _ in smoke.GNN_CELLS:
        cfg = smoke.gnn_cell(arch_id, shape,
                             **({"n_layers": depth} if depth else {})).cfg
        full = get_arch(arch_id).config
        assert cfg.n_layers == (depth or full.n_layers) <= full.n_layers
        keep = {f.name for f in dataclasses.fields(cfg)} - {
            "n_layers", "d_in", "sample_sizes"}
        assert all(getattr(cfg, k) == getattr(full, k) for k in keep)
    assert get_arch("equiformer-v2").config.n_layers == 12   # restored
    module = smoke.wrapper_module(smoke.GNN_ROW.split(":")[0])
    assert module.SOURCE.name == "segsum.cu"
