"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the cuda and cuda-1p backends'
counts (and FSM codes and supports), and the fused triangle count,
against the plain backend's.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (Miner, make_cf_app, make_fsm_app, make_tc_app,
                              triangle_count_fused)
from repro_torch.core.api import (PredicateSpec, make_ctx,
                                  resolve_kernel_predicate)
from repro_torch.graph import generators as TG
from repro_torch.graph.csr import pack_adjacency
from repro_torch.kernels.extend_fused import ops, ref
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect import ref as intersect_ref

pytestmark = pytest.mark.gpu

VERTEX_KERNELS = ("extend_candidates", "extend_count", "extend_scatter")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, conn_mode, seed=5, n=60, n_emb=120, k=3):
    """Kernel inputs for random parent embeddings on an ER graph."""
    g = TG.erdos_renyi(n, 0.3, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.integers(-1, n, size=(n_emb, k)).astype(
        np.int32)).to(device)
    embc = emb.clamp(0, n - 1).reshape(-1).long()
    vlo, vhi = g.row_ptr[embc], g.row_ptr[embc + 1]
    deg = torch.where(emb.reshape(-1) >= 0, vhi - vlo, 0).to(torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    args = (g.col_idx, offsets, offsets - deg, emb.reshape(-1).contiguous(),
            vlo, vhi)
    if conn_mode == "bitmap":
        pg = pack_adjacency(g)
        bits, n_words = pg.words.reshape(-1), pg.n_words
    else:
        bits, n_words = torch.zeros(1, dtype=torch.int32, device=device), 1
    n_steps = int(np.ceil(np.log2(g.max_degree + 1)))
    return g, args, bits, n_words, n_steps, int(offsets[-1])


def _plain_pruned(*args, out_cap, **kw):
    counts = ref.extend_count_ref(*args, **kw)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    row, u = ref.extend_scatter_ref(*args, incl - counts, out_cap=out_cap,
                                    **kw)
    return row, u, incl[-1], counts


def test_extend_candidates_matches_plain(cuda):
    g, args, _, _, n_steps, total = _inputs(cuda, "search")
    for cand_cap in (total + 300, max(total // 3, 1)):
        kw = dict(k=3, cand_cap=cand_cap, n_steps=n_steps)
        ops.reset_counts()
        got = ops.extend_candidates(*args, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["extend_candidates"] == 1
        for a, b in zip(got, ref.extend_candidates_ref(*args, **kw)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("spec_name", ["clique", "alive", "dead",
                                       "straddle"])
def test_pruned_pair_matches_plain(cuda, conn_mode, spec_name):
    g, args, bits, n_words, n_steps, total = _inputs(cuda, conn_mode)
    spec = {"clique": resolve_kernel_predicate(make_cf_app(4), 3),
            "alive": PredicateSpec(), "dead": PredicateSpec(src_slot_eq=3),
            "straddle": PredicateSpec(src_slot_eq=0)}[spec_name]
    for out_cap in (total + 7, 100):                 # roomy, overflow
        kw = dict(k=3, cand_cap=total + 300, out_cap=out_cap,
                  n_steps=n_steps, n_vertices=g.n_vertices,
                  n_words=n_words, spec=spec, conn_mode=conn_mode)
        ops.reset_counts()
        got = ops.extend_pruned(*args, bits, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"extend_candidates": 0, "extend_count": 1,
                                "extend_scatter": 1, "extend_edge": 0,
                                "extend_pruned_1p": 0}
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
        for a, b in zip(got, _plain_pruned(*args, bits, **kw)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("spec_name", ["clique", "alive", "dead",
                                       "straddle"])
def test_extend_pruned_1p_matches_plain_and_pair(cuda, conn_mode, spec_name):
    # about 1,900 tiles, so the look-back spans many 32-tile windows
    g, args, bits, n_words, n_steps, total = _inputs(cuda, conn_mode, n=200,
                                                     n_emb=3000)
    spec = {"clique": resolve_kernel_predicate(make_cf_app(4), 3),
            "alive": PredicateSpec(), "dead": PredicateSpec(src_slot_eq=3),
            "straddle": PredicateSpec(src_slot_eq=0)}[spec_name]
    for out_cap in (total + 7, 1000):                # roomy, overflow
        kw = dict(k=3, cand_cap=total + 300, out_cap=out_cap,
                  n_steps=n_steps, n_vertices=g.n_vertices,
                  n_words=n_words, spec=spec, conn_mode=conn_mode)
        ops.reset_counts()
        got = ops.extend_pruned_1p(*args, bits, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["extend_pruned_1p"] == 1
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
        want = ref.extend_pruned_1p_ref(*args, bits, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip(got, ops.extend_pruned(*args, bits, **kw)):
            assert torch.equal(a, b)                 # the pair's buffers


def test_extend_pruned_1p_ignores_stale_tile_statuses(cuda):
    """A launch after a warm-up launch of the same size, whose freed status
    words the caching allocator hands back, still finds the right bases."""
    g, args, bits, n_words, n_steps, total = _inputs(cuda, "search", n=200,
                                                     n_emb=3000)
    kw = dict(k=3, cand_cap=total, out_cap=total, n_steps=n_steps,
              n_vertices=g.n_vertices, n_words=n_words, conn_mode="search")
    for spec in (PredicateSpec(), PredicateSpec(src_slot_eq=1),
                 PredicateSpec(src_slot_eq=3), PredicateSpec()):
        got = ops.extend_pruned_1p(*args, bits, spec=spec, **kw)
        want = ref.extend_pruned_1p_ref(*args, bits, spec=spec, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
@pytest.mark.parametrize("make_app", [make_tc_app, lambda: make_cf_app(4)],
                         ids=["tc", "4-cf"])
def test_cuda_miner_matches_plain_backend(cuda, make_app, backend):
    g = TG.rmat(10, 16, seed=0, device=cuda)
    want = Miner(g, make_app(), backend="torch-ref", device=cuda).run().count
    m = Miner(g, make_app(), backend=backend, device=cuda)
    ops.reset_counts()
    assert m.run().count == want                      # cold
    assert m.run().count == want                      # warm
    path = (VERTEX_KERNELS if backend == "cuda"
            else ("extend_candidates", "extend_pruned_1p"))
    assert min(ops.LAUNCHES[name] for name in path) >= 1
    assert sum(n for k, n in ops.LAUNCHES.items() if k not in path) == 0
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0


def _intersect_inputs(device, seed=4, n=60, n_pairs=1000):
    """Random vertex pairs of an ER graph, some with an empty segment."""
    g = TG.erdos_renyi(n, 0.25, seed=seed, device=device)
    rp = g.row_ptr.cpu().numpy()
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, n_pairs), rng.integers(0, n, n_pairs)
    lo_a, hi_a, lo_b, hi_b = (torch.from_numpy(x.astype(np.int32)).to(device)
                              for x in (rp[a], rp[a + 1], rp[b], rp[b + 1]))
    hi_b[::7] = lo_b[::7]                             # empty B
    hi_a[3::11] = lo_a[3::11]                         # empty A
    return g, (g.col_idx, lo_a, hi_a, lo_b, hi_b)


@pytest.mark.parametrize("case", ["full", "truncated", "one-step"])
def test_intersect_count_matches_plain(cuda, case):
    g, args = _intersect_inputs(cuda)
    n_steps = int(np.ceil(np.log2(g.max_degree + 1)))
    kw = {"full": dict(max_deg=g.max_degree, n_steps=n_steps),
          "truncated": dict(max_deg=5, n_steps=n_steps),
          "one-step": dict(max_deg=g.max_degree, n_steps=1)}[case]
    intersect_ops.reset_counts()
    got = intersect_ops.intersect_count(*args, **kw)
    torch.cuda.synchronize()
    assert intersect_ops.LAUNCHES["intersect_count"] == 1
    assert intersect_ref.intersect_count_ref.calls == 0
    assert torch.equal(got, intersect_ref.intersect_count_ref(*args, **kw))


def test_triangle_count_fused_matches_miner(cuda):
    g = TG.rmat(10, 16, seed=0, device=cuda)
    want = Miner(g, make_tc_app(), backend="torch-ref",
                 device=cuda).run().count
    intersect_ops.reset_counts()
    assert triangle_count_fused(g) == want
    assert intersect_ops.LAUNCHES["intersect_count"] == 1
    assert intersect_ref.intersect_count_ref.calls == 0
    assert triangle_count_fused(g, use_kernel=False) == want


def _edge_inputs(device, E, with_vmask, seed=3):
    """Edge-kernel inputs: random rows of E edge uids and E+1 vertex slots
    on a labeled ER graph, some slots masked to zero degree."""
    g = TG.erdos_renyi(200, 0.05, seed=seed, labels=3, device=device)
    ctx = make_ctx(g, with_edge_uids=True)
    rng = np.random.default_rng(seed + E)
    cap, n = 300, g.n_vertices
    slots = torch.from_numpy(rng.integers(0, n, size=cap * (E + 1)).astype(
        np.int32)).to(device)
    keep = torch.from_numpy(rng.random(cap * (E + 1)) < 0.7).to(device)
    deg = torch.where(keep, g.row_ptr[slots.long() + 1]
                      - g.row_ptr[slots.long()], 0).to(torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    eids = torch.from_numpy(rng.integers(-1, ctx.n_uedges, size=cap * E)
                            .astype(np.int32)).to(device)
    vmask = (torch.from_numpy((rng.random(n) < 0.6).astype(np.int32))
             .to(device) if with_vmask else None)
    args = (ctx.col_idx, ctx.edge_uid, offsets, offsets - deg, slots,
            g.row_ptr[slots.long()], eids, ctx.usrc, ctx.udst, vmask)
    kw = dict(n_slots=E + 1, n_uedges=ctx.n_uedges, n_vertices=n)
    return args, kw, int(offsets[-1])


@pytest.mark.parametrize("with_vmask", [False, True], ids=["nomask", "vmask"])
@pytest.mark.parametrize("E", [1, 2, 3, 7])
def test_extend_edge_matches_plain(cuda, E, with_vmask):
    args, kw, total = _edge_inputs(cuda, E, with_vmask)
    for cand_cap in (total + 300, max(total // 3, 1)):
        ops.reset_counts()
        got = ops.extend_edge(*args, cand_cap=cand_cap, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["extend_edge"] == 1
        want = ref.extend_edge_ref(*args, cand_cap=cand_cap, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_cuda_fsm_matches_plain_backend(cuda):
    g = TG.rmat(9, 8, seed=0, labels=4, device=cuda)
    freq = torch.bincount(g.labels, minlength=4)
    app = make_fsm_app(3, int(freq.min()) + 1)      # drops one label
    want = Miner(g, app, backend="torch-ref", device=cuda).run()
    m = Miner(g, app, backend="cuda", device=cuda)
    ops.reset_counts()
    cold = m.run()
    warm = m.run()
    for got in (cold, warm):
        assert np.array_equal(got.codes, want.codes)
        assert np.array_equal(got.supports, want.supports)
    assert ops.LAUNCHES["extend_edge"] == 3
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
    # the replay up to its one final read waits for the card nowhere
    (ex,) = m._executors.values()
    n = torch.tensor(m.ctx.n_uedges, dtype=torch.int32, device=cuda)
    args = m.edge_worklist()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes, supports, _ = ex._run_once(*args, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(codes.cpu().numpy(), want.codes)
