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
