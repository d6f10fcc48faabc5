"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the cuda and cuda-1p backends'
counts (and FSM codes and supports), and the fused triangle count,
against the plain backend's; flash attention and the segment sum against
their plain versions, and the wrappers' refusals.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (Miner, Pattern, make_cf_app, make_fsm_app,
                              make_mc_app, make_tc_app, pattern_app,
                              pattern_set_app, triangle_count_fused)
from repro_torch.core.api import (CANONICAL, PredicateSpec, make_ctx,
                                  resolve_kernel_predicate)
from repro_torch.core.apps.psm import make_set_branch_spec
from repro_torch.core.patterns import compile_pattern_set, motif_patterns
from repro_torch.graph import generators as TG
from repro_torch.graph.csr import from_edge_list, pack_adjacency
from repro_torch.graph.dag import orient_dag
from repro_torch.kernels.extend_fused import ops, ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.segsum import ops as segsum_ops
from repro_torch.kernels.segsum import ref as segsum_ref
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


def _intersect_inputs(device, variant="plain", seed=4, n=60, n_pairs=1000):
    """Random vertex pairs of an ER graph, some with an empty segment, in
    one of the input classes that the kernel's gates split
    (``ops.kernel_paths``): pairs grouped by source (``grouped``), a run of
    one source longer than a CTA's tile (``straddle``), reversed rows
    (``unsorted-b``), repeated neighbours (``dup-a``), ids too wide for the
    bitmap (``wide-ids``), malformed and out-of-range bounds
    (``malformed``), pairs grouped by source whose rows alternate
    between narrow and too wide for the bitmap, so that one warp's runs go
    bitmap, list, bitmap (``mixed-ids``), and two hub rows of 3,000 ids,
    one inside the bitmap's span and one too wide for the bitmap and too
    long for the list (``hub``).  Returns (col_idx, the four bounds) on
    ``device`` and the longest row."""
    g = TG.erdos_renyi(n, 0.25, seed=seed, device="cpu")
    rp = g.row_ptr.numpy().astype(np.int64)
    col = g.col_idx.numpy().astype(np.int64)
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, n_pairs), rng.integers(0, n, n_pairs)
    if variant in ("grouped", "mixed-ids"):
        a = np.sort(a)
    elif variant == "straddle":                       # 2,500 pairs of A = 7
        a[100:2600] = 7
    elif variant == "hub":
        hubs = [np.sort(rng.choice(60_000, 3000, replace=False)),
                np.sort(rng.choice(1 << 24, 3000, replace=False))]
        col = np.concatenate([col, *hubs])
        rp = np.concatenate([rp, rp[-1] + np.array([3000, 6000])])
        a[::3] = n + a[::3] % 2                       # A: a hub row
        b[1::3] = n + b[1::3] % 2                     # B: a hub row
    bounds = [rp[a].copy(), rp[a + 1].copy(), rp[b].copy(), rp[b + 1].copy()]
    if variant == "unsorted-b":
        for v in range(0, n, 3):
            col[rp[v]:rp[v + 1]] = col[rp[v]:rp[v + 1]][::-1].copy()
    elif variant == "dup-a":
        for v in range(0, n, 4):
            if rp[v + 1] - rp[v] > 2:
                col[rp[v] + 1] = col[rp[v]]
    elif variant == "wide-ids":
        col = (1 << 20) + col * 4099
    elif variant == "mixed-ids":                      # odd rows widened
        for v in range(1, n, 2):
            col[rp[v]:rp[v + 1]] = (1 << 20) + col[rp[v]:rp[v + 1]] * 4099
    elif variant == "malformed":
        for lo, hi, at in ((0, 1, slice(0, None, 6)),
                           (2, 3, slice(3, None, 6))):
            bounds[lo][at], bounds[hi][at] = (bounds[hi][at] + 1,
                                              bounds[lo][at])
        bounds[2][1::10] -= 3
        bounds[1][5::10] = col.shape[0] + 2
    bounds[3][::7] = bounds[2][::7]                   # empty B
    if variant == "plain":
        bounds[1][3::11] = bounds[0][3::11]           # empty A
    return tuple(torch.from_numpy(x.astype(np.int32)).to(device)
                 for x in (col, *bounds)), int(np.diff(rp).max())


def _variant_spec(name: str, device):
    """(k, spec, state, labels) of one pruned-kernel variant: an induced
    conjunction, a labeled one, the canonical test, and trie levels of
    4-motif counting (k = 3) and of a directed set (k = 2, first_pair)."""
    rng = np.random.default_rng(7)
    if name == "conjunction":
        return 3, PredicateSpec(required=0b011, forbidden=0b100,
                                distinct=0b100, greater=0b001), None, None
    if name == "labeled":
        labels = torch.from_numpy(rng.integers(0, 3, 60).astype(
            np.int32)).to(device)
        return 3, PredicateSpec(required=0b001, forbidden=0b010,
                                distinct=0b110, label=1,
                                first_labels=(0, 2)), None, labels
    if name == "canonical":
        return 3, CANONICAL, None, None
    if name == "branches":
        plan = compile_pattern_set(motif_patterns(4))
        k, level = 3, plan.levels[1]
    else:                                   # "first_pair"
        plan = compile_pattern_set([Pattern.named(n) for n in
                                    ("diamond", "4-cycle", "4-star")])
        assert plan.directed
        k, level = 2, plan.levels[0]
    n_bits = max(br.parent for br in level) + 1
    state = torch.from_numpy(rng.integers(0, 1 << n_bits, 120).astype(
        np.int32)).to(device)
    return k, make_set_branch_spec(level), state, None


SPEC_VARIANTS = ("conjunction", "labeled", "canonical", "branches",
                 "first_pair")


@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("variant", SPEC_VARIANTS)
def test_pruned_kernels_match_plain_for_every_spec_kind(cuda, conn_mode,
                                                        variant):
    k, spec, state, labels = _variant_spec(variant, cuda)
    g, args, bits, n_words, n_steps, total = _inputs(cuda, conn_mode, k=k)
    for out_cap in (total + 7, 100):                 # roomy, overflow
        kw = dict(k=k, cand_cap=total + 300, out_cap=out_cap,
                  n_steps=n_steps, n_vertices=g.n_vertices,
                  n_words=n_words, spec=spec, conn_mode=conn_mode,
                  state=state, labels=labels)
        ops.reset_counts()
        pair = ops.extend_pruned(*args, bits, **kw)
        one = ops.extend_pruned_1p(*args, bits, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["extend_count"] == ops.LAUNCHES[
            "extend_pruned_1p"] == 1
        assert ops.VARIANT_LAUNCHES[spec.kind] == 3
        assert ops.VARIANT_LAUNCHES["labeled"] == 3 * (labels is not None)
        assert ops.VARIANT_LAUNCHES["state"] == 3 * (state is not None)
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
        counts = ref.extend_count_ref(*args, bits, **{
            n: v for n, v in kw.items() if n != "out_cap"})
        incl = torch.cumsum(counts, 0, dtype=torch.int32)
        want = ref.extend_scatter_ref(*args, bits, incl - counts, **kw)
        assert len(pair) == len(want) + 2 == 4 + spec.writes_state
        for a, b in zip(pair, (*want, incl[-1], counts)):
            assert torch.equal(a, b)
        want1 = ref.extend_pruned_1p_ref(*args, bits, **kw)
        for a, b in zip(one, want1):
            assert torch.equal(a, b)
        assert int(one[-1]) == int(incl[-1])


def test_pruned_kernels_refuse_missing_state_or_labels(cuda):
    g, args, bits, n_words, n_steps, total = _inputs(cuda, "search")
    k, spec, state, _ = _variant_spec("branches", cuda)
    kw = dict(k=3, cand_cap=total + 300, out_cap=64, n_steps=n_steps,
              n_vertices=g.n_vertices, n_words=n_words, conn_mode="search")
    with pytest.raises(ValueError, match="state"):
        ops.extend_pruned_1p(*args, bits, spec=spec, **kw)
    with pytest.raises(ValueError, match="rows"):
        ops.extend_pruned_1p(*args, bits, spec=spec, state=state[:7], **kw)
    _, lspec, _, labels = _variant_spec("labeled", cuda)
    with pytest.raises(ValueError, match="labels"):
        ops.extend_count(*args, bits, spec=lspec,
                         **{n: v for n, v in kw.items() if n != "out_cap"})


def _mixed_pack(g, pack: str):
    """The kernel arguments of a partial pack (20 of the 60 rows) or a core
    pack (rows and columns [0, 32), so candidates u >= 32 take the CSR
    branch) of ``g``: (bits, keyword arguments)."""
    pg = pack_adjacency(g, max_bytes=160, core=pack == "core")
    assert not pg.full
    assert (pg.n_packed, pg.n_cols) == ((20, 60) if pack == "partial"
                                        else (32, 32))
    return pg.words.reshape(-1), dict(
        n_words=pg.n_words, conn_mode="mixed", row_slot=pg.row_slot,
        n_rows=pg.n_packed, n_cols=pg.n_cols)


@pytest.mark.parametrize("pack", ["partial", "core"])
@pytest.mark.parametrize("variant", ("clique",) + SPEC_VARIANTS)
def test_mixed_kernels_match_plain_and_search(cuda, pack, variant):
    """K2 and K4 in mixed mode equal their plain versions and the search
    kernels' buffers bit for bit, for every spec kind, under a partial and
    a core pack (lanes with u >= n_cols included)."""
    if variant == "clique":
        k, spec, state, labels = (3, resolve_kernel_predicate(
            make_cf_app(4), 3), None, None)
    else:
        k, spec, state, labels = _variant_spec(variant, cuda)
    g, args, zbits, _, n_steps, total = _inputs(cuda, "search", k=k)
    bits, mixed = _mixed_pack(g, pack)
    u_all = ref.extend_candidates_ref(*args, k=k, cand_cap=total,
                                      n_steps=n_steps)[1]
    if pack == "core":
        assert int((u_all >= mixed["n_cols"]).sum()) > 0
    base = dict(k=k, cand_cap=total + 300, n_steps=n_steps,
                n_vertices=g.n_vertices, spec=spec, state=state,
                labels=labels)
    for out_cap in (total + 7, 100):                 # roomy, overflow
        kw = dict(base, out_cap=out_cap, **mixed)
        search = dict(base, out_cap=out_cap, n_words=1, conn_mode="search")
        ops.reset_counts()
        pair = ops.extend_pruned(*args, bits, **kw)
        one = ops.extend_pruned_1p(*args, bits, **kw)
        torch.cuda.synchronize()
        assert ops.mode_launches() == {"search": 0, "bitmap": 0, "mixed": 3}
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
        counts = ref.extend_count_ref(*args, bits, **{
            n: v for n, v in kw.items() if n != "out_cap"})
        incl = torch.cumsum(counts, 0, dtype=torch.int32)
        want = ref.extend_scatter_ref(*args, bits, incl - counts, **kw)
        for a, b in zip(pair, (*want, incl[-1], counts)):
            assert torch.equal(a, b)
        for a, b in zip(one, ref.extend_pruned_1p_ref(*args, bits, **kw)):
            assert torch.equal(a, b)
        for a, b in zip(pair, ops.extend_pruned(*args, zbits, **search)):
            assert torch.equal(a, b)                 # a mode changes nothing
        for a, b in zip(one, ops.extend_pruned_1p(*args, zbits, **search)):
            assert torch.equal(a, b)


def test_mixed_kernels_refuse_a_bad_pack(cuda):
    g, args, _, _, n_steps, total = _inputs(cuda, "search")
    bits, mixed = _mixed_pack(g, "core")
    kw = dict(k=3, cand_cap=total + 300, n_steps=n_steps,
              n_vertices=g.n_vertices, spec=PredicateSpec(), **mixed)
    with pytest.raises(ValueError, match="row_slot"):
        ops.extend_count(*args, bits, **{**kw, "row_slot": None})
    with pytest.raises(ValueError, match="row_slot"):
        ops.extend_count(*args, bits, **{**kw, "row_slot": kw["row_slot"][:9]})
    with pytest.raises(ValueError, match="words"):
        ops.extend_count(*args, bits[:5], **kw)
    with pytest.raises(ValueError, match="n_cols"):
        ops.extend_count(*args, bits, **{**kw, "n_cols": 61})
    with pytest.raises(ValueError, match="device"):
        ops.extend_count(*args, bits, **{**kw,
                                         "row_slot": kw["row_slot"].cpu()})


# -- the parent window of K2 and K4: a CTA stages the parent tables of its
# live slots in shared memory, or, when their span overflows the window,
# reads them from global memory with each search bounded to the span

WINDOW = 1024        # kWin in csrc/extend.cu: parent entries a CTA stages
N_WIN = 3000         # vertices of the window tests' graph


def _window_graph(device):
    """An ER graph on N_WIN vertices with a hub (vertex 0) adjacent to all
    the others."""
    rng = np.random.default_rng(11)
    er = rng.integers(0, N_WIN, (30000, 2))
    hub = np.stack([np.zeros(N_WIN - 1, np.int64), np.arange(1, N_WIN)], 1)
    return from_edge_list(np.concatenate([er, hub]), n_vertices=N_WIN,
                          device=device)


def _window_tables(g, case: str, k: int):
    """Parent tables of ``case``: "overflow" (live rows 400 rows apart,
    then a dense run), "hub" (a fifth of the slots on the hub, 2,999
    candidates each) or random rows."""
    rng = np.random.default_rng(12)
    n_rows = 6000 if case == "overflow" else 400
    emb = rng.integers(0, N_WIN, (n_rows, k))
    if case == "overflow":
        alive = (np.arange(n_rows) % 400 == 0)
        alive[3000:3200] = True
        emb[~alive] = -1
    elif case == "hub":
        emb[rng.random(emb.shape) < 0.2] = 0
    emb = torch.from_numpy(emb.astype(np.int32)).to(g.col_idx.device)
    embc = emb.clamp(0, N_WIN - 1).reshape(-1).long()
    vlo, vhi = g.row_ptr[embc], g.row_ptr[embc + 1]
    deg = torch.where(emb.reshape(-1) >= 0, vhi - vlo, 0).to(torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    return (g.col_idx, offsets, offsets - deg, emb.reshape(-1).contiguous(),
            vlo, vhi)


def _spans(offsets, k: int, cand_cap: int, tile: int) -> np.ndarray:
    """Per tile of ``tile`` slots, the parent entries its live slots' rows
    span (what a CTA would stage)."""
    off = offsets.cpu().numpy()
    end = min(cand_cap, int(off[-1]))
    s0 = np.arange(0, end, tile)
    s1 = np.minimum(s0 + tile, end) - 1
    first = np.searchsorted(off, s0, side="right") // k
    last = np.searchsorted(off, s1, side="right") // k
    return (last + 1 - first) * k


def _branches32(k: int, n_rows: int, device):
    """A random level of 32 branches over k slots (parent bits 0..31) and a
    random state column of full 32-bit words."""
    from repro_torch.core.api import Branch, BranchSetSpec
    rng = np.random.default_rng(13)
    masks = lambda: int(rng.integers(0, 1 << k)) & int(rng.integers(0, 1 << k))
    spec = BranchSetSpec(tuple(
        Branch(parent=b, anchor=int(rng.integers(0, k)), required=masks(),
               forbidden=masks() & ~1, distinct=masks(), smaller=masks(),
               first_pair=bool(rng.random() < 0.2)) for b in range(32)))
    state = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n_rows)
                             .astype(np.int32)).to(device)
    return spec, state


def _window_modes(g):
    """Per probe mode: (bits, keyword arguments); mixed reads a partial
    pack of a third of the rows, the hub's among them."""
    n_words = -(-N_WIN // 32)
    full = pack_adjacency(g)
    part = pack_adjacency(g, max_bytes=1000 * n_words * 4)
    assert full.full and not part.full and int(part.row_slot[0]) >= 0
    zeros = torch.zeros(1, dtype=torch.int32, device=g.col_idx.device)
    return {"search": (zeros, dict(n_words=1, conn_mode="search")),
            "bitmap": (full.words.reshape(-1),
                       dict(n_words=full.n_words, conn_mode="bitmap")),
            "mixed": (part.words.reshape(-1), dict(
                n_words=part.n_words, conn_mode="mixed",
                row_slot=part.row_slot, n_rows=part.n_packed,
                n_cols=part.n_cols))}


def _hold_pruned(args, bits, kw, out_caps):
    """The pair and extend_pruned_1p, one launch each per ``out_cap``,
    against the plain versions bit for bit."""
    for out_cap in out_caps:
        kwo = dict(kw, out_cap=out_cap)
        ops.reset_counts()
        pair = ops.extend_pruned(*args, bits, **kwo)
        one = ops.extend_pruned_1p(*args, bits, **kwo)
        torch.cuda.synchronize()
        assert ops.mode_launches()[kw["conn_mode"]] == 3
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
        counts = ref.extend_count_ref(*args, bits, **kw)
        incl = torch.cumsum(counts, 0, dtype=torch.int32)
        want = ref.extend_scatter_ref(*args, bits, incl - counts, **kwo)
        for a, b in zip(pair, (*want, incl[-1], counts)):
            assert torch.equal(a, b)
        for a, b in zip(one, ref.extend_pruned_1p_ref(*args, bits, **kwo)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("conn_mode", ["search", "bitmap", "mixed"])
@pytest.mark.parametrize("case", ["overflow", "hub", "ragged", "branches32",
                                  "out_cap"])
def test_parent_window_kernels_match_plain(cuda, case, conn_mode):
    """K2 (count, scatter) and K4 against their plain versions where the
    window is tested: a tile whose parent span overflows it (most parents
    without candidates), a hub whose candidates cross several tiles and K4
    sub-tiles (a window of one row), totals and cand_cap off the tile, a
    32-branch set at k = 5, and a K4 launch that overflows out_cap; each
    with the clique, the canonical test and a 32-branch set."""
    g = _window_graph(cuda)
    k = 5 if case == "branches32" else 3
    args = _window_tables(g, "ragged" if case in ("branches32", "out_cap")
                          else case, k)
    total = int(args[1][-1])
    bits, mode_kw = _window_modes(g)[conn_mode]
    n_steps = int(np.ceil(np.log2(g.max_degree + 1)))
    spec32, state = _branches32(k, args[1].shape[0] // k, cuda)
    specs = [(spec32, state)]
    if case != "branches32":
        specs += [(resolve_kernel_predicate(make_cf_app(4), 3), None),
                  (CANONICAL, None)]
    cand_caps = [total + 300, total - 333] if case == "ragged" else \
        [total + 300]
    for cand_cap in cand_caps:
        assert cand_cap % ref.BLOCK_C and total % ref.BLOCK_C
        spans = _spans(args[1], k, cand_cap, ref.BLOCK_C)
        if case == "overflow":      # both paths: staged and bounded global
            assert spans.max() > WINDOW >= spans.min()
        if case == "hub":           # a hub row spans 2,048-slot K4 tiles
            assert int((args[1] - args[2]).max()) > 4 * ref.BLOCK_C
            assert spans.min() == k
        for spec, st in specs:
            kw = dict(k=k, cand_cap=cand_cap, n_steps=n_steps,
                      n_vertices=N_WIN, spec=spec, state=st, **mode_kw)
            n = int(ref.extend_pruned_1p_ref(*args, bits, out_cap=1,
                                             **kw)[-1])
            assert n > 0
            out_caps = [n + 5]
            if case == "out_cap":
                out_caps += [n // 3, 1]
            _hold_pruned(args, bits, kw, out_caps)


# K3 and K5 take several 512-slot tiles a CTA under one window, and fill a
# CTA wholly in their constant tail without a search: K3's tail starts
# where every slot's parent is the last and its CSR pointer is clamped to
# m - 1, K5's at the total.  The cand_caps below place CTAs on each side of
# those bounds.

CAND_SPAN = 16 * ref.BLOCK_C     # kCandSpan in csrc/extend.cu
EDGE_SPAN = 8 * ref.BLOCK_C      # kEdgeSpan
N_HUB = 10000                    # vertices of the tail tests' graph
CAP_CASES = ("below", "past", "straddle-total", "straddle-clamp", "tail3")


def _hub_graph(device):
    """An ER graph on N_HUB vertices with a hub (vertex 0) adjacent to all
    the others, so one parent slot on it has 9,999 candidates."""
    rng = np.random.default_rng(21)
    er = rng.integers(0, N_HUB, (30000, 2))
    hub = np.stack([np.zeros(N_HUB - 1, np.int64), np.arange(1, N_HUB)], 1)
    return from_edge_list(np.concatenate([er, hub]), n_vertices=N_HUB,
                          device=device)


def _hub_slots(width: int, seed: int) -> np.ndarray:
    """[1000, width] parent vertices: random, a tenth -1, row 10 led by
    two hub slots (its candidates fill several CTAs), rows 100 .. 100 +
    1100 / width all -1 (more than kWin parents without candidates inside
    one CTA's span), and the last slot on the hub (vlo 0, so the clamp
    lies far past the total)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(1, N_HUB, (1000, width))
    slots[rng.random(slots.shape) < 0.1] = -1
    slots[10, :2] = 0
    slots[100:100 + 1100 // width + 1] = -1
    slots[-1, -1] = 0
    return slots.astype(np.int32)


def _cand_cap(case: str, total: int, uniform: int, span: int) -> int:
    """cand_cap of ``case``: below the total, 300 past it, past the CTA
    that straddles the total, past the CTA that straddles ``uniform``
    (where the tail begins), or three whole CTAs into the tail."""
    up = lambda x: -(-x // span) * span
    assert total % span and uniform % span
    return {"below": total * 2 // 3, "past": total + 300,
            "straddle-total": up(total) + span // 2,
            "straddle-clamp": up(uniform) + span // 3,
            "tail3": up(uniform) + 3 * span + 77}[case]


def _cta_spans(offsets, width: int, cand_cap: int, span: int) -> np.ndarray:
    """Per CTA of ``span`` slots below cand_cap, the parent entries its
    window would cover (the rows of its first and last slot's parents)."""
    off = offsets.cpu().numpy()
    s0 = np.arange(0, cand_cap, span)
    s1 = np.minimum(s0 + span, cand_cap) - 1
    last = off.shape[0] - 1
    first = np.minimum(np.searchsorted(off, s0, side="right"), last) // width
    end = np.minimum(np.searchsorted(off, s1, side="right"), last) // width
    return (end + 1 - first) * width


@pytest.mark.parametrize("case", CAP_CASES)
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_extend_candidates_window_and_tail_match_plain(cuda, k, case):
    """K3 against its plain version on every lane, on tables with a hub
    row, a run of parents without candidates wider than the window, and
    the clamp far past the total, at cand_caps on each side of the total
    and of the uniform tail's start."""
    g = _hub_graph(cuda)
    emb = torch.from_numpy(_hub_slots(k, seed=k)).to(cuda).reshape(-1)
    embc = emb.clamp(0, N_HUB - 1).long()
    vlo, vhi = g.row_ptr[embc], g.row_ptr[embc + 1]
    deg = torch.where(emb >= 0, vhi - vlo, 0).to(torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    args = (g.col_idx, offsets, offsets - deg, emb, vlo, vhi)
    total, m = int(offsets[-1]), g.col_idx.shape[0]
    uniform = max(total, int(offsets[-1] - deg[-1]) + m - 1 - int(vlo[-1]))
    assert uniform > total + CAND_SPAN
    cand_cap = _cand_cap(case, total, uniform, CAND_SPAN)
    spans = _cta_spans(offsets, k, min(cand_cap, total), CAND_SPAN)
    assert spans.max() > WINDOW and spans.min() == k   # global path, hub
    kw = dict(k=k, cand_cap=cand_cap, n_steps=int(np.ceil(np.log2(
        g.max_degree + 1))))
    ops.reset_counts()
    got = ops.extend_candidates(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["extend_candidates"] == 1
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
    for a, b in zip(got, ref.extend_candidates_ref(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CAP_CASES)
@pytest.mark.parametrize("E", [1, 2, 3, 7])
def test_extend_edge_window_and_tail_match_plain(cuda, E, case):
    """K5 against its plain version on every lane, on edge tables with a
    hub slot, a run of slot-parents without candidates wider than the
    window, and a vertex mask, at cand_caps on each side of the total (the
    dead tail) and of K3's clamp bound."""
    g = _hub_graph(cuda)
    ctx = make_ctx(g, with_edge_uids=True)
    rng = np.random.default_rng(30 + E)
    slots = torch.from_numpy(_hub_slots(E + 1, seed=E)).to(cuda).reshape(-1)
    live = slots >= 0
    slots = slots.clamp(0, N_HUB - 1)
    vlo = g.row_ptr[slots.long()]
    deg = torch.where(live, g.row_ptr[slots.long() + 1] - vlo, 0).to(
        torch.int32)
    offsets = torch.cumsum(deg, 0, dtype=torch.int32)
    eids = torch.from_numpy(rng.integers(-1, ctx.n_uedges, 1000 * E).astype(
        np.int32)).to(cuda)
    vmask = torch.from_numpy((rng.random(N_HUB) < 0.6).astype(np.int32)).to(
        cuda)
    args = (ctx.col_idx, ctx.edge_uid, offsets, offsets - deg, slots, vlo,
            eids, ctx.usrc, ctx.udst, vmask)
    total, m = int(offsets[-1]), g.col_idx.shape[0]
    clamp = int(offsets[-1] - deg[-1]) + m - 1 - int(vlo[-1])
    assert clamp > total + EDGE_SPAN
    cand_cap = _cand_cap(case, total, clamp, EDGE_SPAN)
    spans = _cta_spans(offsets, E + 1, min(cand_cap, total), EDGE_SPAN)
    assert spans.max() > WINDOW and spans.min() == E + 1
    kw = dict(n_slots=E + 1, cand_cap=cand_cap, n_uedges=ctx.n_uedges,
              n_vertices=N_HUB)
    ops.reset_counts()
    got = ops.extend_edge(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["extend_edge"] == 1
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
    want = ref.extend_edge_ref(*args, **kw)
    assert int(want[4].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


PACKED_MINERS = {
    "partial": dict(pack_partial=True, pack_max_bytes=4096),
    "relabel": dict(relabel=True, pack_max_bytes=4096),
}


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
@pytest.mark.parametrize("opts", sorted(PACKED_MINERS))
@pytest.mark.parametrize("app_name", ["tc", "4-cf", "mc3"])
def test_cuda_miner_in_mixed_mode_matches_search(cuda, app_name, opts,
                                                 backend):
    """A partial or core pack runs the mixed kernels: the counts, p_map and
    every level (vid, idx, state) equal the same Miner's search run, and
    the count the plain backend's."""
    make_app = {"tc": make_tc_app, "4-cf": lambda: make_cf_app(4),
                "mc3": lambda: make_mc_app(3)}[app_name]
    g = TG.rmat(10, 16, seed=0, device=cuda)
    kw = PACKED_MINERS[opts]
    want = Miner(g, make_app(), backend="torch-ref", device=cuda,
                 **kw).run()
    search = Miner(g, make_app(), backend=backend, device=cuda,
                   **{**kw, "pack_max_bytes": 0}).run()
    ops.reset_counts()
    m = Miner(g, make_app(), backend=backend, device=cuda, **kw)
    assert not m.ctx.packed.full
    got = m.run()
    assert m.run().count == got.count == want.count == search.count
    if want.p_map is not None:
        assert np.array_equal(got.p_map, want.p_map)
    modes = ops.mode_launches()
    assert modes["mixed"] >= 2 and modes["search"] == modes["bitmap"] == 0
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
    for x, y in zip(got.levels, search.levels):
        n = int(x.n)
        assert n == int(y.n)
        assert torch.equal(x.vid[:n], y.vid[:n])
        assert torch.equal(x.idx[:n], y.idx[:n])
        assert (x.state is None) == (y.state is None)
        if x.state is not None:
            assert torch.equal(x.state[:n], y.state[:n])


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
def test_cuda_unfused_filter_counts_as_fused(cuda, backend):
    g = TG.rmat(9, 16, seed=0, device=cuda)
    for make_app in (lambda: make_cf_app(4), lambda: make_mc_app(3)):
        fused = Miner(g, make_app(), backend=backend, device=cuda).run()
        ops.reset_counts()
        m = Miner(g, make_app(), backend=backend, fuse_filter=False,
                  device=cuda)
        for _ in ("cold", "warm"):
            got = m.run()
            assert got.count == fused.count
            if fused.p_map is not None:
                assert np.array_equal(got.p_map, fused.p_map)
        assert ops.LAUNCHES["extend_candidates"] >= 2
        assert ops.LAUNCHES["extend_count"] == ops.LAUNCHES[
            "extend_pruned_1p"] == 0
        assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0


MC_APPS = {
    "mc3": lambda: make_mc_app(3), "mc4": lambda: make_mc_app(4),
    "mc4-memo": lambda: make_mc_app(4, "memo"),
    "mc4-generic": lambda: make_mc_app(4, "generic"),
    "diamond": lambda: pattern_app(Pattern.named("diamond")),
    "lchain": lambda: pattern_app(Pattern.from_edges(
        [(0, 1), (1, 2)], labels=[0, 1, 2])),
    "directed-set": lambda: pattern_set_app(
        [Pattern.named(n) for n in ("diamond", "4-cycle", "4-star")]),
}


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
@pytest.mark.parametrize("app_name", sorted(MC_APPS))
def test_cuda_motifs_match_plain_backend(cuda, app_name, backend):
    g = TG.rmat(8, 8, seed=0, labels=3, device=cuda)
    want = Miner(g, MC_APPS[app_name](), backend="torch-ref",
                 device=cuda).run()
    ops.reset_counts()
    m = Miner(g, MC_APPS[app_name](), backend=backend, device=cuda)
    for run in ("cold", "warm"):
        got = m.run()
        assert got.count == want.count, run
        if want.p_map is None:
            assert got.p_map is None
        else:
            assert np.array_equal(got.p_map, want.p_map), run
    assert sum(f.calls for f in ops.PLAIN_VERSIONS) == 0
    assert sum(ops.VARIANT_LAUNCHES[n] for n in (
        "conjunction", "canonical", "branches")) >= 2


# each case's input class and the kernel paths (ops.PATHS) it must reach
INTERSECT_CASES = {"full": ("plain", {"bitmap"}),
                   "truncated": ("plain", {"bitmap"}),
                   "one-step": ("plain", {"search"}),
                   "grouped": ("grouped", {"bitmap"}),
                   "straddle": ("straddle", {"bitmap"}),
                   "unsorted-b": ("unsorted-b", {"bitmap", "search"}),
                   "dup-a": ("dup-a", {"bitmap", "search"}),
                   "wide-ids": ("wide-ids", {"list"}),
                   "mixed-ids": ("mixed-ids", {"bitmap", "list"}),
                   "malformed": ("malformed", {"empty", "search"}),
                   "hub": ("hub", {"bitmap", "search"}),
                   "rmat10-dag": (None, {"bitmap"})}


@pytest.mark.parametrize("case", sorted(INTERSECT_CASES))
def test_intersect_count_matches_plain(cuda, case):
    """Every pair of each input class equal to the plain version, in one
    launch: the classes that pass the kernel's gates (A' staged as a bitmap
    or a list) and those that fail one (the search), as ``kernel_paths``
    names them; ``rmat10-dag`` is ``triangle_count_fused``'s launch on
    RMAT-10."""
    variant, want_paths = INTERSECT_CASES[case]
    if variant is None:
        dag = orient_dag(TG.rmat(10, 16, seed=0, device=cuda))
        src, dst = (t.long() for t in dag.edge_list())
        rp = dag.row_ptr
        args = (dag.col_idx, rp[src], rp[src + 1], rp[dst], rp[dst + 1])
        max_deg = dag.max_degree
    else:
        args, max_deg = _intersect_inputs(
            cuda, variant, n_pairs=3000 if case == "straddle" else 1000)
    kw = dict(max_deg=max_deg, n_steps=int(np.ceil(np.log2(max_deg + 1))))
    if case == "truncated":
        kw["max_deg"] = 5
    elif case == "one-step":
        kw["n_steps"] = 1
    paths = {intersect_ops.PATHS[i] for i in
             intersect_ops.kernel_paths(*args, **kw).tolist()}
    assert want_paths <= paths, paths
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


# -- flash attention ---------------------------------------------------------

# b, hq, hkv, lq, lk, d, causal: the JAX package's CASES
# (tests/test_kernels.py), a ragged key length, and Qwen3-0.6B's prefill;
# then shapes across the tensor-core kernel's 128-row and 128-key tiles:
# ragged lq and lk, one query over 4,100 keys, lq < lk bidirectional, GQA
# groups of 4 and 8, d = 32 and 64 at 1,000 tokens, and an 8k prefill;
# then the f32 bench's shapes (check, chunk; long is Qwen3-0.6B's prefill
# above) and a ragged lq < lk that the f32 plan cuts into many chunks
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 256, 256, 64, True),
    (2, 4, 1, 64, 128, 32, False),
    (1, 2, 2, 128, 384, 64, True),
    (1, 4, 2, 1, 256, 64, True),
    (2, 4, 4, 64, 256, 128, True),
    (1, 4, 2, 100, 200, 64, True),
    (2, 4, 2, 37, 200, 32, False),
    (1, 16, 8, 4096, 4096, 128, True),
    (1, 4, 2, 200, 333, 128, True),
    (1, 4, 2, 1, 4100, 128, True),
    (1, 4, 2, 300, 700, 128, False),
    (2, 8, 2, 257, 385, 64, True),
    (1, 8, 1, 129, 1000, 128, True),
    (1, 4, 2, 1000, 1000, 32, True),
    (1, 4, 2, 1000, 1000, 64, True),
    (1, 16, 8, 8192, 8192, 128, True),
    (1, 16, 8, 512, 512, 128, True),
    (1, 16, 8, 512, 4096, 128, True),
    (1, 4, 2, 100, 4100, 64, True),
]
# the cases whose f32 plan keeps one chunk a query tile: their (batch,
# head, query tile)s fill two CTAs an SM
FMA_UNSPLIT = {(1, 16, 8, 4096, 4096, 128, True),
               (1, 16, 8, 8192, 8192, 128, True)}


def _qkv(device, b, hq, hkv, lq, lk, d, dtype, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((b, hq, lq, d), (b, hkv, lk, d),
                               (b, hkv, lk, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, b, hq, hkv, lq, lk, d, causal,
                                       dtype):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, b, hq, hkv, lq, lk, d, dt)
    flash_ops.reset_counts()
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == 1
    assert flash_ref.attention_ref.calls == 0
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == dt and got.shape == want.shape
    if dt == torch.float32:
        case = (b, hq, hkv, lq, lk, d, causal)
        plan = flash_ops.fma_plan(*case)
        assert plan.split == (case not in FMA_UNSPLIT)
        # f32 throughout, sums in another order: the JAX tests' 2e-5
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        # both sum in f32 and round once to bf16: bf16's default tolerance
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", [
    (1, 16, 8, 512, 512, 128, True), (1, 16, 8, 512, 4096, 128, True),
    (1, 4, 2, 100, 4100, 64, True), (2, 4, 2, 37, 200, 32, False)])
def test_flash_attention_f32_repeats_bit_for_bit(cuda, b, hq, hkv, lq, lk,
                                                d, causal):
    """The f32 kernel's chunks merge in a fixed order without atomics: two
    calls on the same inputs give the same bits."""
    q, k, v = _qkv(cuda, b, hq, hkv, lq, lk, d, torch.float32)
    assert flash_ops.fma_plan(b, hq, hkv, lq, lk, d, causal).split
    first = flash_ops.flash_attention(q, k, v, causal=causal)
    second = flash_ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_sm_scale(cuda, dtype):
    """A scale other than d^-0.5 reaches both variants (the tensor-core one
    folds it into its base-2 exponent)."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, 1, 4, 2, 150, 300, 64, dt)
    got = flash_ops.flash_attention(q, k, v, sm_scale=0.3)
    want = flash_ref.attention_ref(q, k, v, sm_scale=0.3)
    tol = dict(atol=2e-5, rtol=0) if dt == torch.float32 else {}
    torch.testing.assert_close(got, want, **tol)


def test_flash_attention_long_flat_sums_hold_bf16_tolerance(cuda):
    """Near-uniform attention over 32,768 keys whose values are +-(1 + u) in
    two halves: the running sums of P V reach ~16,000 while the outputs are
    near zero, where ``assert_close``'s bf16 atol of 1e-5 binds.  A kernel
    that kept all 256 tiles' sums in the tensor cores' accumulator, whose
    additions truncate, drifts past it; each tile's P V is added to O on
    the FMA pipes instead."""
    g = torch.Generator(cuda).manual_seed(0)
    lq, lk = 256, 32768
    q = (0.1 * torch.randn(1, 2, lq, 128, generator=g, device=cuda))
    k = torch.randn(1, 1, lk, 128, generator=g, device=cuda)
    sign = torch.where(torch.arange(lk, device=cuda) < lk // 2, 1.0, -1.0)
    v = sign[:, None] * (1 + 0.1 * torch.rand(1, 1, lk, 128, generator=g,
                                              device=cuda))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    got = flash_ops.flash_attention(q, k, v, causal=False)
    want = flash_ref.attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want)


def test_flash_attention_counts_each_variant(cuda):
    """A bf16 launch runs the tensor-core variant, an f32 launch the FMA
    one; ``reset_counts`` zeroes both counts."""
    flash_ops.reset_counts()
    for dt in (torch.bfloat16, torch.bfloat16, torch.float32):
        flash_ops.flash_attention(*_qkv(cuda, 1, 4, 2, 64, 200, 128, dt))
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == 3
    assert flash_ops.VARIANT_LAUNCHES == {"tensor_core": 2, "fma": 1}
    flash_ops.reset_counts()
    assert flash_ops.VARIANT_LAUNCHES == {"tensor_core": 0, "fma": 0}


def test_flash_attention_refuses(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 128, 64, torch.float32)
    call = flash_ops.flash_attention
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        call(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        call(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="on cpu"):
        call(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        call(*_qkv(cuda, 1, 4, 2, 64, 128, 48, torch.float32))
    with pytest.raises(ValueError, match="Lq <= Lk"):
        call(*_qkv(cuda, 1, 4, 2, 129, 128, 64, torch.float32))
    with pytest.raises(ValueError, match="key/value heads"):
        call(*_qkv(cuda, 1, 4, 3, 64, 128, 64, torch.float32))
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 64 + 1, device=cuda)
        call(flat[1:].reshape(1, 1, 64, 64), k[:, :1, :64], v[:, :1, :64])


# -- segment sum -------------------------------------------------------------


def _segsum_inputs(device, n, d, s, dtype, sort=True, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    data = torch.randn(n, d, generator=g, device=device).to(dtype)
    seg = torch.randint(-1, s + 1, (n,), generator=g, device=device,
                        dtype=torch.int32)         # -1 and s add nothing
    if sort:
        seg = torch.sort(seg).values
    return data, seg


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,s", [(1000, 64, 37), (257, 128, 5),
                                   (64, 8, 64), (100_000, 100, 4000),
                                   (3000, 200, 1), (5000, 1, 300),
                                   (5000, 7, 300), (5000, 8, 300),
                                   (5000, 32, 300), (3000, 160, 100),
                                   (700, 6272, 40)])
def test_sorted_segment_sum_matches_plain(cuda, n, d, s, dtype, sort):
    dt = getattr(torch, dtype)
    data, seg = _segsum_inputs(cuda, n, d, s, dt, sort)
    segsum_ops.reset_counts()
    got = segsum_ops.sorted_segment_sum(data, seg, s)
    torch.cuda.synchronize()
    assert segsum_ops.LAUNCHES["sorted_segment_sum"] == 1
    assert segsum_ref.sorted_segment_sum_ref.calls == 0
    want = segsum_ref.sorted_segment_sum_ref(data, seg, s)
    assert got.dtype == dt and got.shape == (s, d)
    # both sum in f32, in another order (atomic adds): sums of up to a few
    # thousand unit normals agree to 1e-4; bf16 rounds both once at the end
    tol = dict(atol=1e-4, rtol=1e-5) if dt == torch.float32 else {}
    torch.testing.assert_close(got, want, **tol)


def _exact_segsum_case(cuda, dt, n, d, s, ids, offset=0):
    """Integer-valued rows (sums exact in f32 in any order, and in bf16
    rounded once) at ``offset`` elements into their storage, the kernel's
    output against the plain version's, equal; one counted launch and no
    plain call."""
    g = torch.Generator(cuda).manual_seed(1)
    flat = torch.randint(-4, 5, (offset + n * d,), generator=g, device=cuda)
    data = flat.to(dt)[offset:].view(n, d)
    assert data.is_contiguous()
    segsum_ops.reset_counts()
    got = segsum_ops.sorted_segment_sum(data, ids, s)
    torch.cuda.synchronize()
    assert segsum_ops.LAUNCHES["sorted_segment_sum"] == 1
    assert segsum_ref.sorted_segment_sum_ref.calls == 0
    want = segsum_ref.sorted_segment_sum_ref(data, ids, s)
    assert got.dtype == dt and got.shape == (s, d)
    assert torch.equal(got, want)
    return data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [100, 6272, 7])
def test_sorted_segment_sum_runs_past_a_row_tile(cuda, dtype, d):
    """Three runs, each longer than the plan's row tile, so each is cut by
    tile edges and added from several CTAs; sorted and unsorted."""
    dt = getattr(torch, dtype)
    n = 3 * segsum_ops.tile_plan(20_000, d, dt.itemsize, 0).tile_rows + 17
    assert segsum_ops.tile_plan(n, d, dt.itemsize, 0).tile_rows < n // 3
    ids = torch.arange(n, device=cuda, dtype=torch.int32) * 3 // n
    _exact_segsum_case(cuda, dt, n, d, 3, ids)
    perm = torch.randperm(n, generator=torch.Generator(cuda).manual_seed(2),
                          device=cuda)
    _exact_segsum_case(cuda, dt, n, d, 3, ids[perm].contiguous())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_segment_sum_leaves_empty_segments_zero(cuda, dtype):
    """100,000 segments for 3,000 rows, most empty, with ids -1 and
    n_segments among them: every empty segment comes out zero."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(3)
    ids = torch.sort(torch.randint(-1, 100_001, (3000,), generator=g,
                                   device=cuda, dtype=torch.int32)).values
    _exact_segsum_case(cuda, dt, 3000, 64, 100_000, ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 100, 6272])
def test_sorted_segment_sum_takes_a_misaligned_view(cuda, dtype, d):
    """A contiguous view one element into its storage (4- or 2-byte but
    not 16-byte aligned) takes the scalar loads and sums right; the same
    rows at an aligned address take the 16-byte loads where a row is a
    whole number of 16-byte vectors."""
    dt = getattr(torch, dtype)
    n = 2000
    ids = torch.sort(torch.randint(0, 50, (n,), device=cuda,
                                   dtype=torch.int32)).values
    data = _exact_segsum_case(cuda, dt, n, d, 50, ids, offset=1)
    assert data.data_ptr() % 16 != 0
    assert not segsum_ops.tile_plan(n, d, dt.itemsize, data.data_ptr()).vector
    aligned = _exact_segsum_case(cuda, dt, n, d, 50, ids)
    assert segsum_ops.tile_plan(n, d, dt.itemsize, aligned.data_ptr()
                                ).vector == ((d * dt.itemsize) % 16 == 0)


def test_sorted_segment_sum_refuses(cuda):
    data, seg = _segsum_inputs(cuda, 100, 16, 5, torch.float32)
    call = segsum_ops.sorted_segment_sum
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(data.half(), seg, 5)
    with pytest.raises(ValueError, match="int32"):
        call(data, seg.long(), 5)
    with pytest.raises(ValueError, match="ids on cpu"):
        call(data, seg.cpu(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        call(data.t(), seg, 5)
    with pytest.raises(ValueError, match="ids for"):
        call(data, seg[:50], 5)
    with pytest.raises(ValueError, match="n_segments"):
        call(data, seg, -1)


def test_serve_lm_on_the_card_matches_the_cpu(cuda):
    """Qwen3's SMOKE widths in f32: serve_lm on the card (the flash kernel,
    2 launches) decodes the tokens that the CPU decodes from the same
    weights and prompt, and the prefill logits agree within 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as T

    arch = get_arch("qwen3-0.6b")
    cfg, b, s, gen = arch.smoke, 2, 100, 6
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (b, s)).astype(np.int32))
    flash_ops.reset_counts()
    got = serve_lm(arch, True, b, s, gen, seed=1, device=cuda, prompt=prompt)
    assert flash_ops.LAUNCHES["flash_attention"] == 2
    assert flash_ref.attention_ref.calls == 0
    # serve_lm's weights, on the CPU
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(1),
                           device="cpu")
    logits, cache = T.prefill(cfg, params, prompt, cache_len=s + gen)
    card, _ = T.prefill(cfg, T.init_params(
        cfg, torch.Generator(cuda).manual_seed(1), device=cuda),
        prompt.to(cuda))
    torch.testing.assert_close(card.cpu(), logits, atol=1e-4, rtol=0)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = T.decode_step(cfg, params, cache, tok, s + i)
        tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
        want.append(tok)
    assert torch.equal(got.cpu(), torch.cat(want, 1))
