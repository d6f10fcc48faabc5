"""PyTorch port, the kernel-readable clique predicate.

``make_cf_app`` fills a :class:`PredicateSpec` per level for exactly the
rules of the JAX app's ``to_add_kernel``; evaluated on random batches of
``(emb_cols, u, src_slot, state, conn)`` the two must agree everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps.cf import make_cf_app as jax_make_cf_app
from repro_torch.core.api import PredicateSpec, resolve_kernel_predicate
from repro_torch.core.apps.cf import make_cf_app
from repro_torch.core.apps.tc import make_tc_app

VARIANTS = [(True, True), (True, False), (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng, kk, n=2000, n_vertices=12):
    emb = rng.integers(-1, n_vertices, size=(kk, n)).astype(np.int32)
    u = rng.integers(-1, n_vertices, size=n).astype(np.int32)
    src = rng.integers(0, kk, size=n).astype(np.int32)
    conn = rng.random((kk, n)) < 0.7
    return emb, u, src, conn


@pytest.mark.parametrize("use_dag,eager_prune", VARIANTS)
@pytest.mark.parametrize("k", [3, 4, 5])
def test_spec_equals_jax_to_add_kernel(k, use_dag, eager_prune):
    jax_pred = jax_make_cf_app(k, use_dag=use_dag,
                               eager_prune=eager_prune).to_add_kernel
    app = make_cf_app(k, use_dag=use_dag, eager_prune=eager_prune)
    rng = np.random.default_rng(k * 10 + 2 * use_dag + eager_prune)
    for kk in range(2, k):                       # every parent width
        spec = resolve_kernel_predicate(app, kk)
        assert isinstance(spec, PredicateSpec)
        emb, u, src, conn = _batch(rng, kk)
        want = jax_pred(tuple(jnp.asarray(c) for c in emb), jnp.asarray(u),
                        jnp.asarray(src), jnp.zeros(u.shape, jnp.int32),
                        tuple(jnp.asarray(c) for c in conn))
        got = spec(tuple(torch.from_numpy(c) for c in emb),
                   torch.from_numpy(u), torch.from_numpy(src),
                   torch.zeros(u.shape, dtype=torch.int32),
                   tuple(torch.from_numpy(c) for c in conn))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert 0 < int(got.sum()) < u.shape[0]   # both outcomes exercised


def test_canonical_variant_has_no_spec():
    """Without the DAG and without eager pruning the rule is the
    automorphism-canonical test, which no spec expresses."""
    app = make_cf_app(4, use_dag=False, eager_prune=False)
    assert app.to_add_spec is None
    assert resolve_kernel_predicate(app, 2) is None


def test_spec_fields_for_clique_rules():
    spec = resolve_kernel_predicate(make_tc_app(), 2)
    assert spec == PredicateSpec(required=0b11, distinct=0b11)
    spec = resolve_kernel_predicate(make_cf_app(5, use_dag=False), 4)
    assert spec == PredicateSpec(required=0b1111, greater=0b1000)
    spec = resolve_kernel_predicate(make_cf_app(4, eager_prune=False), 3)
    assert spec == PredicateSpec(required=0b111, distinct=0b111,
                                 src_slot_eq=2)


def test_per_level_spec_needs_the_level():
    app = make_cf_app(4)
    with pytest.raises(ValueError, match="parent embedding width"):
        resolve_kernel_predicate(app)
    with pytest.raises(ValueError, match="no to_add_spec entry"):
        resolve_kernel_predicate(app, 7)
