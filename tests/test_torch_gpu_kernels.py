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
from repro_torch.graph.csr import pack_adjacency
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


# -- flash attention ---------------------------------------------------------

# b, hq, hkv, lq, lk, d, causal: the JAX package's CASES
# (tests/test_kernels.py), a ragged key length, and Qwen3-0.6B's prefill;
# then shapes across the tensor-core kernel's 128-row and 128-key tiles:
# ragged lq and lk, one query over 4,100 keys, lq < lk bidirectional, GQA
# groups of 4 and 8, d = 32 and 64 at 1,000 tokens, and an 8k prefill
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
]


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
        # f32 throughout, sums in another order: the JAX tests' 2e-5
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        # both sum in f32 and round once to bf16: bf16's default tolerance
        torch.testing.assert_close(got, want)


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
                                   (3000, 200, 1)])
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
