"""PyTorch port, segment sum: the port's ``sorted_segment_sum`` on CPU
tensors (its plain version) against the JAX package's Pallas kernel in
interpret mode and its ``segment_sum`` oracle, on the same inputs made with
numpy from a seed: ``tests/test_kernels.py``'s shapes in f32 and bf16,
unsorted ids, and ids outside ``[0, n_segments)``."""
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
                                           (64, 8, 64, 64)])
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
