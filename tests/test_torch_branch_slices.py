"""PyTorch port: a branch set's sliced table, ``BranchSetSpec.slices(k)``,
the form the pruned CUDA kernels read a pattern-set trie level in.

A numpy emulation of the kernels' sliced formula (``BranchPred::eval`` in
``kernels/extend_fused/csrc/extend.cu``: the live set from the parent's
state bits and the anchor, the cheap terms, then the probes in slot order
while a surviving branch names the slot, stopping once none survives)
computes each lane's bitmap from the words alone.  On random branch sets
(1 to 32 branches, parent bit 31 and branch 31 included) and random
columns it must equal, bit for bit, the JAX package's
``make_set_branch_bits`` (jnp on the CPU) and the port's
``BranchSetSpec.bits``; it must also probe no slot that the old
formulation (every slot a live branch names) would not.  Malformed tables
are refused before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps.psm import make_set_branch_bits
from repro.core.patterns.compile import SetBranch
from repro_torch.core.api import (MAX_SLICE_SLOTS, SLOT_MASKS, Branch,
                                  BranchSetSpec)
from repro_torch.core.apps.psm import make_set_branch_spec
from repro_torch.core.patterns import compile_pattern_set, motif_patterns
from repro_torch.core.patterns import Pattern
from repro_torch.kernels.extend_fused import ops

SETS = 120          # random branch sets
LANES = 64          # lanes (candidates) per set
ALL = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sliced_bits(words, emb_cols, u, src_slot, state, conn):
    """The kernel's sliced formula on numpy columns: (bitmap uint32[N],
    the number of slots each lane probed)."""
    kind, labeled, n, k = words[:4]
    assert (kind, labeled) == (3, 0)
    tab = np.array(words[4:], dtype=np.int64).astype(np.uint32)
    first_pair, parent = tab[0], tab[1:33]
    slot = tab[33:].reshape(k, len(SLOT_MASKS))
    anchor, req, forb, dist, small = slot.T
    st = state.astype(np.int64) & 0xFFFFFFFF
    live = np.zeros(u.shape, np.uint32)
    for b in range(32):                       # the parent's set state bits
        live |= np.where((st >> b) & 1 == 1, parent[b], np.uint32(0))
    live &= anchor[src_slot]
    out = np.where(u >= 0, live, np.uint32(0))
    for j in range(k):                        # the cheap terms
        out &= np.where(u == emb_cols[j], ~dist[j], ALL)
        out &= np.where(u > emb_cols[j], ALL, ~small[j])
    out &= np.where(emb_cols[0] < emb_cols[1], ALL, ~first_pair)
    probes = np.zeros(u.shape, np.int64)
    for j in range(k):                        # slot order, early out
        need = (out & (req[j] | forb[j])) != 0
        probes += need
        out = np.where(need, out & np.where(conn[j], ~forb[j], ~req[j]), out)
    return out, probes


def _mask(slots) -> int:
    return sum(1 << j for j in slots)


def _random_set(rng, k: int):
    """A random level: (JAX SetBranches, the port's BranchSetSpec)."""
    n = int(rng.choice([1, 2, 5, 17, 31, 32])) if rng.random() < 0.4 \
        else int(rng.integers(1, 33))
    jax_br, port_br = [], []
    for b in range(n):
        sets = [tuple(j for j in range(k) if rng.random() < 0.3)
                for _ in range(4)]
        parent = 31 if rng.random() < 0.15 else int(rng.integers(0, 32))
        anchor = int(rng.integers(0, k + 1))  # k: anchored at no slot
        fp = bool(rng.random() < 0.2)
        jax_br.append(SetBranch(k, parent, anchor, *sets, first_pair=fp))
        port_br.append(Branch(parent, anchor, *map(_mask, sets),
                              first_pair=fp))
    return jax_br, BranchSetSpec(tuple(port_br))


def _columns(rng, k: int, n: int = LANES):
    emb = [rng.integers(-1, 8, n).astype(np.int32) for _ in range(k)]
    u = rng.integers(-1, 8, n).astype(np.int32)
    src = rng.integers(0, k, n).astype(np.int32)
    dense = rng.integers(0, 2, (n, 32)) * (rng.random((n, 1)) < 0.5)
    one = np.eye(32, dtype=np.int64)[rng.integers(0, 32, n)]
    bits = np.where(rng.random((n, 1)) < 0.5, dense, one)
    state = (bits << np.arange(32)).sum(1).astype(np.uint32).view(np.int32)
    conn = [rng.random(n) < 0.6 for _ in range(k)]
    return emb, u, src, state, conn


def _port_bits(spec, emb, u, src, state, conn):
    t = torch.from_numpy
    return spec.bits(tuple(map(t, emb)), t(u), t(src), t(state),
                     tuple(map(t, conn))).numpy()


def _old_probes(spec, k, u, src, state):
    """Probes of the old formulation: every slot some live branch (parent
    bit and anchor, u >= 0) requires or forbids."""
    need = np.zeros(u.shape, np.int64)
    st = state.astype(np.int64) & 0xFFFFFFFF
    for j in range(k):
        hit = np.zeros(u.shape, bool)
        for br in spec.branches:
            live = ((st >> br.parent) & 1 == 1) & (src == br.anchor) & (u >= 0)
            hit |= live & bool((br.required | br.forbidden) >> j & 1)
        need += hit
    return need


def test_sliced_formula_equals_jax_and_the_plain_bits():
    rng = np.random.default_rng(19)
    sizes, lanes = set(), 0
    for i in range(SETS):
        k = 2 + i % (MAX_SLICE_SLOTS - 1)
        jax_br, spec = _random_set(rng, k)
        emb, u, src, state, conn = _columns(rng, k)
        words = spec.slices(k)
        assert words[:4] == [3, 0, len(spec.branches), k]
        assert len(words) == 4 + 33 + len(SLOT_MASKS) * k
        assert all(-(1 << 31) <= w < 1 << 31 for w in words)
        got, probes = sliced_bits(words, emb, u, src, state, conn)
        want = np.asarray(make_set_branch_bits(jax_br)(
            tuple(map(jnp.asarray, emb)), jnp.asarray(u), jnp.asarray(src),
            jnp.asarray(state), tuple(map(jnp.asarray, conn))))
        np.testing.assert_array_equal(got.view(np.int32), want)
        np.testing.assert_array_equal(
            got.view(np.int32), _port_bits(spec, emb, u, src, state, conn))
        assert (probes <= _old_probes(spec, k, u, src, state)).all()
        sizes.add(len(spec.branches))
        lanes += u.shape[0]
    assert {1, 32} <= sizes and lanes >= 5000


def test_branch_31_and_parent_bit_31_set_the_sign_bit():
    spec = BranchSetSpec(tuple(Branch(parent=31 - b, anchor=0)
                               for b in range(32)))
    words = spec.slices(2)
    assert words[4 + 1 + 31] == 1                 # parent bit 31: branch 0
    assert words[4 + 1] == -(1 << 31)             # parent bit 0: branch 31
    emb = [np.array([3], np.int32)] * 2
    u, src = np.array([5], np.int32), np.array([0], np.int32)
    state = np.array([-(1 << 31) | 1], np.int32)  # bits 31 and 0
    conn = [np.array([True])] * 2
    got, _ = sliced_bits(words, emb, u, src, state, conn)
    assert got.view(np.int32)[0] == -(1 << 31) | 1
    np.testing.assert_array_equal(
        got.view(np.int32), _port_bits(spec, emb, u, src, state, conn))


@pytest.mark.parametrize("patterns", [
    lambda: motif_patterns(4), lambda: motif_patterns(5),
    lambda: [Pattern.named(n) for n in ("diamond", "4-cycle", "4-star")]],
    ids=["motifs4", "motifs5", "directed"])
def test_compiled_tries_slice_to_their_bits(patterns):
    rng = np.random.default_rng(3)
    for lvl in compile_pattern_set(patterns()).levels:
        spec, k = make_set_branch_spec(lvl), lvl[0].position
        emb, u, src, state, conn = _columns(rng, k, 512)
        got, _ = sliced_bits(spec.slices(k), emb, u, src, state, conn)
        np.testing.assert_array_equal(
            got.view(np.int32), _port_bits(spec, emb, u, src, state, conn))


@pytest.mark.parametrize("k", [0, MAX_SLICE_SLOTS + 1, 7])
def test_slices_refuse_a_parent_wider_than_five(k):
    spec = BranchSetSpec((Branch(parent=0, anchor=0),))
    with pytest.raises(ValueError, match="parent width"):
        spec.slices(k)


@pytest.mark.parametrize("branch,match", [
    (Branch(parent=32, anchor=0), "parent bit"),
    (Branch(parent=-1, anchor=0), "parent bit"),
    (Branch(parent=0, anchor=0, required=0b1000), "slot set"),
    (Branch(parent=0, anchor=0, smaller=-1), "slot set"),
    (Branch(parent=0, anchor=0, distinct=1 << 40), "slot set")])
def test_slices_refuse_malformed_tables(branch, match):
    spec = BranchSetSpec((Branch(parent=1, anchor=1), branch))
    with pytest.raises(ValueError, match=match):
        spec.slices(3)


def test_slices_refuse_first_pair_without_two_slots():
    spec = BranchSetSpec((Branch(parent=0, anchor=0, first_pair=True),))
    assert len(spec.slices(2)) == 4 + 33 + 2 * len(SLOT_MASKS)
    with pytest.raises(ValueError, match="first_pair"):
        spec.slices(1)


def test_branch_set_size_is_bounded():
    with pytest.raises(ValueError, match="branches"):
        BranchSetSpec(())
    with pytest.raises(ValueError, match="branches"):
        BranchSetSpec(tuple(Branch(parent=0, anchor=0) for _ in range(33)))


def test_wrapper_refuses_a_wide_parent_before_any_launch():
    """k = 6 has no slices: the wrapper raises while it builds the launch's
    words, on the CPU as on the card."""
    k = MAX_SLICE_SLOTS + 1
    spec = BranchSetSpec((Branch(parent=0, anchor=0, required=1),))
    offsets = torch.arange(1, k + 1, dtype=torch.int32)
    zeros = torch.zeros(k, dtype=torch.int32)
    col = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="parent width"):
        ops.extend_count(col, offsets, offsets - 1, zeros, zeros, zeros + 1,
                         col, k=k, cand_cap=k, n_steps=1, n_vertices=1,
                         n_words=1, spec=spec, conn_mode="search",
                         state=torch.ones(1, dtype=torch.int32))
