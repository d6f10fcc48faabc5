"""PyTorch port, the GNN segment ops against the JAX package on the CPU.

``segment_sum``, ``segment_mean``, ``segment_max``, ``edge_softmax`` and
``embedding_bag`` (sum, mean and max, weighted or not) within 1e-6 of
``repro.sparse.ops`` on the same inputs, ids out of range included;
``segment_sum``'s first and second derivatives against JAX's ``grad`` and
grad-of-grad; its forward runs the segment-sum kernel's wrapper (on the
CPU its plain version), once a call, and its second derivative once
more.  Inputs are made from a seed with numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import ops as JO
from repro_torch import sparse as TSP
from repro_torch.kernels.segsum import ops as segsum_ops
from repro_torch.kernels.segsum import ref as segsum_ref
from repro_torch.sparse import ops as TO

N_SEG = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed: int, shape=(40, 3, 2), lo: int = -2, hi: int = N_SEG + 2):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(lo, hi, shape[0]).astype(np.int32)
    return data, ids


def _close(got: torch.Tensor, want, tol: float = 1e-6) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max"])
@pytest.mark.parametrize("shape", [(40,), (40, 5), (40, 3, 2)],
                         ids=["1d", "2d", "3d"])
def test_segment_ops_match_jax(name, shape):
    data, ids = _inputs(0, shape)
    want = getattr(JO, name)(jnp.asarray(data), jnp.asarray(ids), N_SEG)
    got = getattr(TO, name)(torch.from_numpy(data), torch.from_numpy(ids),
                            N_SEG)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_segment_max_keeps_jax_empty_segments():
    """A segment no id reaches holds -inf, as ``jax.ops.segment_max``."""
    data, ids = _inputs(1, (6, 2), lo=0, hi=3)
    got = TO.segment_max(torch.from_numpy(data), torch.from_numpy(ids), 5)
    want = np.asarray(JO.segment_max(jnp.asarray(data), jnp.asarray(ids), 5))
    assert np.isneginf(want[3:]).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("heads", [(), (4,)], ids=["flat", "heads"])
def test_edge_softmax_matches_jax(heads):
    rng = np.random.default_rng(2)
    scores = (3 * rng.standard_normal((50,) + heads)).astype(np.float32)
    dst = rng.integers(0, N_SEG, 50).astype(np.int32)
    want = JO.edge_softmax(jnp.asarray(scores), jnp.asarray(dst), N_SEG)
    got = TO.edge_softmax(torch.from_numpy(scores), torch.from_numpy(dst),
                          N_SEG)
    _close(got, want)
    # each destination's weights sum to one
    sums = TO.segment_sum(got, torch.from_numpy(dst), N_SEG)
    np.testing.assert_allclose(sums.numpy()[np.bincount(dst, minlength=N_SEG)
                                            > 0], 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, 45).astype(np.int32)
    bags = np.sort(rng.integers(-1, 9, 45)).astype(np.int32)
    w = rng.random(45).astype(np.float32) if weighted else None
    want = JO.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            jnp.asarray(bags), 8, mode,
                            None if w is None else jnp.asarray(w))
    got = TO.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(bags), 8, mode,
                           None if w is None else torch.from_numpy(w))
    _close(got, want)


def test_embedding_bag_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        TO.embedding_bag(torch.zeros(3, 2), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), 1, "median")


@functools.lru_cache(maxsize=None)
def _jax_derivatives(seed: int):
    """JAX's loss, gradient and gradient of the gradient's square norm for
    ``sum(sin(segment_sum(x)) * w)``, as numpy."""
    data, ids = _inputs(seed)
    w = np.random.default_rng(seed + 10).standard_normal(
        (N_SEG,) + data.shape[1:]).astype(np.float32)

    def loss(x):
        return jnp.sum(jnp.sin(JO.segment_sum(x, jnp.asarray(ids), N_SEG))
                       * w)

    grad = jax.grad(loss)

    def grad_sq(x):
        return jnp.sum(grad(x) ** 2)

    x = jnp.asarray(data)
    return (data, ids, w, float(loss(x)), np.asarray(grad(x)),
            np.asarray(jax.grad(grad_sq)(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_first_and_second_derivatives_match_jax(seed):
    data, ids, w, loss, g, gg = _jax_derivatives(seed)
    segsum_ops.reset_counts()
    x = torch.from_numpy(data).requires_grad_()
    ids_t = torch.from_numpy(ids)
    got = torch.sum(torch.sin(TO.segment_sum(x, ids_t, N_SEG))
                    * torch.from_numpy(w))
    (grad,) = torch.autograd.grad(got, x, create_graph=True)
    (grad2,) = torch.autograd.grad(torch.sum(grad ** 2), x)
    np.testing.assert_allclose(float(got.detach()), loss, atol=1e-6,
                               rtol=1e-6)
    _close(grad, g)
    _close(grad2, gg, 1e-5)
    # out-of-range ids take no gradient
    out = (ids < 0) | (ids >= N_SEG)
    assert out.any() and not grad.detach().numpy()[out].any()
    # the forward and the gradient of the gradient sum on the kernel's
    # wrapper, the gradient itself is a gather
    assert segsum_ref.sorted_segment_sum_ref.calls == 2


def test_segment_sum_runs_the_kernels_wrapper_on_rows(monkeypatch):
    """Each call reaches ``sorted_segment_sum`` once, looked up on the
    wrapper's module, with contiguous ``[N, -1]`` f32 rows and int32 ids
    (int64 ids converted)."""
    seen = []
    fn = segsum_ops.sorted_segment_sum

    def spy(data, ids, n):
        seen.append((tuple(data.shape), data.is_contiguous(), ids.dtype, n))
        return fn(data, ids, n)
    monkeypatch.setattr(segsum_ops, "sorted_segment_sum", spy)
    data, ids = _inputs(4, (12, 3, 5))
    x = torch.from_numpy(data).transpose(1, 2)          # not contiguous
    out = TSP.segment_sum(x, torch.from_numpy(ids).long(), N_SEG)
    assert seen == [((12, 15), True, torch.int32, N_SEG)]
    want = JO.segment_sum(jnp.asarray(data).transpose(0, 2, 1),
                          jnp.asarray(ids), N_SEG)
    _close(out, want)


def test_segment_sum_refuses_what_the_kernel_does_not_take():
    """No fallback: float64 data is refused by the wrapper's checks."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TO.segment_sum(torch.zeros(4, 2, dtype=torch.float64),
                       torch.zeros(4, dtype=torch.int32), 2)
