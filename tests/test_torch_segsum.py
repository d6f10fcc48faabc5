"""PyTorch port, segment sum: the port's ``sorted_segment_sum`` on CPU
tensors (its plain version) against the JAX package's Pallas kernel in
interpret mode and its ``segment_sum`` oracle, on the same inputs made with
numpy from a seed: ``tests/test_kernels.py``'s shapes and the GNN path's
narrow and wide rows in f32 and bf16, unsorted ids, and ids outside ``[0,
n_segments)``; and the kernel's host-side tile plan, whose grid must cover
every element once at the GNN path's and ogb_products' shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum.ops import sorted_segment_sum as jax_segsum
from repro.kernels.segsum.ref import sorted_segment_sum_ref as jax_ref
from repro_torch.kernels.segsum import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(data_j, seg):
    """The port's sum of the same values as the JAX array ``data_j``."""
    data = torch.from_numpy(np.array(data_j, np.float32)).to(
        torch.bfloat16 if data_j.dtype == jnp.bfloat16 else torch.float32)
    return data, torch.from_numpy(seg)


# tolerances of tests/test_kernels.py::test_segsum_kernel: the Pallas
# kernel sums bf16 data in bf16, the port in f32
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4),
                                       (jnp.bfloat16, 0.15)])
@pytest.mark.parametrize("n,d,s,block_n", [(1000, 64, 37, 256),
                                           (257, 128, 5, 128),
                                           (64, 8, 64, 64),
                                           (300, 1, 40, 128),
                                           (200, 8, 30, 64),
                                           (96, 784, 7, 32)])
def test_plain_matches_jax(n, d, s, block_n, dtype, tol):
    rng = np.random.default_rng(n + d)
    data_j = jnp.asarray(rng.standard_normal((n, d)), dtype)
    seg = np.sort(rng.integers(0, s, n).astype(np.int32))
    data, seg_t = _port(data_j, seg)
    ops.reset_counts()
    got = ops.sorted_segment_sum(data, seg_t, s)
    assert got.dtype == data.dtype and got.shape == (s, d)
    assert ref.sorted_segment_sum_ref.calls == 1
    assert ops.LAUNCHES["sorted_segment_sum"] == 0
    got = got.float().numpy()
    want_ref = jax_ref(data_j.astype(jnp.float32), jnp.asarray(seg), s)
    want_pal = jax_segsum(data_j, jnp.asarray(seg), s, block_n=block_n,
                          interpret=True)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_unsorted_and_out_of_range_ids_match_jax():
    """Unsorted ids sum as sorted ones do (the JAX test's bonus property);
    ids -1 and n_segments add nothing."""
    rng = np.random.default_rng(0)
    data_j = jnp.asarray(rng.standard_normal((300, 16)), jnp.float32)
    seg = rng.integers(-1, 12, 300).astype(np.int32)    # -1 .. 11, S = 11
    assert (seg == -1).any() and (seg == 11).any()
    data, seg_t = _port(data_j, seg)
    got = ops.sorted_segment_sum(data, seg_t, 11).numpy()
    want_pal = jax_segsum(data_j, jnp.asarray(seg), 11, block_n=128,
                          interpret=True)
    want_ref = jax_ref(data_j, jnp.asarray(seg), 11)
    for want in (want_pal, want_ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    keep = (seg >= 0) & (seg < 11)
    again = ops.sorted_segment_sum(data[torch.from_numpy(keep)],
                                   seg_t[torch.from_numpy(keep)], 11)
    np.testing.assert_allclose(got, again.numpy(), atol=1e-5)


def test_wrapper_refuses():
    data = torch.zeros(10, 4)
    seg = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.sorted_segment_sum(data, seg.long(), 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.sorted_segment_sum(data.double(), seg, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sorted_segment_sum(torch.zeros(4, 10).t(), seg, 3)
    with pytest.raises(ValueError, match="ids for"):
        ops.sorted_segment_sum(data, seg[:5], 3)


# -- the kernel's tile plan ---------------------------------------------------

# (n, d): EquiformerV2's aggregation on the joined molecules and on their
# nearest pairs, ogb_products, then the GNN path's narrow widths (a
# segment_mean count, GAT's softmax denominator and messages, NequIP's)
PLAN_SHAPES = [(111_360, 6_272), (16_384, 6_272), (61_859_140, 100),
               (111_360, 1), (21_622, 7), (21_622, 8), (111_360, 32),
               (21_622, 64), (111_360, 96), (111_360, 160), (1, 1), (0, 5)]


def _covered_once(plan, n, d):
    """Emulate ``segsum_kernel``'s index arithmetic over the whole grid:
    every row and every column of ``[n, d]`` is summed by exactly one
    (CTA, lane group, lane, column slot), and on the 16-byte path a lane's
    vector lies wholly inside the row or wholly past it."""
    groups = ops.THREADS // plan.lanes
    starts = (np.arange(plan.row_tiles * groups, dtype=np.int64)
              * plan.group_rows)
    starts = starts[starts < n]            # the kernel's early return
    rows = np.zeros(n + 1, np.int8)
    np.add.at(rows, starts, 1)
    np.add.at(rows, np.minimum(starts + plan.group_rows, n), -1)
    assert (np.cumsum(rows[:n], dtype=np.int8) == 1).all()
    by, sub, k = np.meshgrid(np.arange(plan.col_tiles), np.arange(plan.lanes),
                             np.arange(plan.per_lane), indexing="ij")
    c0 = by * plan.tile_cols
    if plan.vector:
        col = c0 + sub * plan.per_lane + k
        first = c0 + sub * plan.per_lane
        assert ((col < d) == (first < d)).all()
    else:
        col = c0 + sub + k * plan.lanes
    assert np.array_equal(np.bincount(col[col < d], minlength=d),
                          np.ones(d, np.int64))


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", PLAN_SHAPES)
@pytest.mark.parametrize("address", [0, 4], ids=["aligned", "offset4"])
def test_tile_plan_covers_once_and_fills_the_card(n, d, elem, address):
    plan = ops.tile_plan(n, d, elem, address)
    _covered_once(plan, n, d)
    # 16-byte loads only where a row is whole vectors and the data aligned
    assert plan.vector == ((d * elem) % 16 == 0 and address == 0)
    assert plan.per_lane * elem == 16
    # the fewest lanes that reach across the row, or 32 and column tiles
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes == 32 or plan.tile_cols >= d
    assert plan.lanes == 1 or (plan.lanes // 2) * plan.per_lane < d
    # a CTA reads at least 64 KB; four waves wherever n x d allows
    cta_bytes = plan.tile_rows * min(d, plan.tile_cols) * elem
    want = ops.WAVES * ops.SMS * ops.CTAS_PER_SM
    if d:
        assert cta_bytes >= ops.MIN_CTA_BYTES
        least = plan.group_rows == 1 or \
            cta_bytes // 2 < ops.MIN_CTA_BYTES
        assert plan.row_tiles * plan.col_tiles >= want or least
        assert plan.group_rows <= max(ops.MAX_GROUP_ROWS, 1 << 16)


def test_tile_plan_at_the_gnn_path_and_ogb_products():
    """The grids the redesign was sized for: a 6,272-wide f32 row is 49
    column tiles of 128 columns; at 111,360 rows 5.1 waves of 2,048-row
    tiles, at 16,384 rows 5.9 waves of 256-row tiles; ogb_products' 100
    columns one tile; GAT's 8-wide rows 16 to a warp."""
    P = ops.TilePlan
    assert ops.tile_plan(111_360, 6_272, 4, 0) == P(True, 4, 32, 256, 55, 49)
    assert ops.tile_plan(16_384, 6_272, 4, 0) == P(True, 4, 32, 32, 64, 49)
    assert ops.tile_plan(61_859_140, 100, 4, 0) == P(True, 4, 32, 256,
                                                     30_205, 1)
    assert ops.tile_plan(21_622, 8, 4, 0).lanes == 2
    assert ops.tile_plan(111_360, 1, 4, 0) == P(False, 4, 1, 64, 7, 1)


def test_tile_plan_sees_a_misaligned_view():
    """A contiguous view at a 4-byte offset is a legal input: its plan
    takes scalar loads, and the wrapper's CPU path sums it right."""
    flat = torch.randn(1 + 40 * 16, generator=torch.Generator().manual_seed(0))
    view = flat[1:].view(40, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    plan = ops.tile_plan(40, 16, 4, view.data_ptr())
    assert not plan.vector
    assert ops.tile_plan(40, 16, 4, flat.data_ptr()).vector == (
        flat.data_ptr() % 16 == 0)
    seg = torch.from_numpy(np.sort(
        np.random.default_rng(0).integers(0, 5, 40)).astype(np.int32))
    got = ops.sorted_segment_sum(view, seg, 5)
    want = torch.zeros(5, 16).index_add_(0, seg.long(), view)
    torch.testing.assert_close(got, want)


def test_bench_ids_follow_the_gnn_path():
    """``bench.py``'s ids: the joined molecules' every ordered pair sorted
    in runs of 29 over 3,840 atoms; their nearest pairs 64 a molecule both
    ways, each molecule's ids within its own 30 atoms, unsorted."""
    from repro_torch.kernels.segsum import bench
    dense = bench.molecule_ids()
    assert dense.shape == (111_360,) and (np.diff(dense) >= 0).all()
    assert (np.bincount(dense) == 29).all() and dense.max() == 3839
    near = bench.molecule_ids(pairs=64)
    assert near.shape == (16_384,) and (np.diff(near) < 0).any()
    mol = np.tile(np.repeat(np.arange(128), 64), 2)
    assert (near // 30 == mol).all()
