"""PyTorch port, flash attention: the port's ``flash_attention`` on CPU
tensors (its plain version, ``attention_ref``) against the JAX package's
three attention functions (the naive ``attention_ref``, the blockwise
``attention_flash_jnp`` and the Pallas kernel in interpret mode) on the
same inputs, made with numpy from a seed; the wrapper's refusals, and the
plain version's query-row pieces.  The f32 kernel's work list
(``ops.fma_plan``) on every shape the tests and the bench launch, and a
plain emulation of its split and merge against the JAX functions."""
import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import (attention_flash_jnp,
                                               attention_ref as jax_ref)
from repro_torch.kernels.flash_attention import bench, ops, ref
from test_torch_gpu_kernels import FLASH_CASES, FMA_UNSPLIT

# b, hq, hkv, lq, lk, d, causal: tests/test_kernels.py's CASES
CASES = [
    (2, 4, 2, 128, 128, 64, True),       # GQA causal
    (1, 8, 8, 256, 256, 64, True),       # MHA
    (2, 4, 1, 64, 128, 32, False),       # MQA bidirectional
    (1, 2, 2, 128, 384, 64, True),       # lq < lk (chunked prefill)
    (1, 4, 2, 1, 256, 64, True),         # decode: single query
    (2, 4, 4, 64, 256, 128, True),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, block=64):
    b, hq, hkv, lq, lk, d, causal = case
    q, k, v = (jnp.asarray(x) for x in _inputs(b, hq, hkv, lq, lk, d,
                                                lq + lk))
    return {
        "attention_ref": jax_ref(q, k, v, causal=causal),
        "flash_jnp": attention_flash_jnp(q, k, v, causal=causal,
                                         block_k=block),
        "pallas": jax_flash(q, k, v, causal=causal, impl="pallas",
                            interpret=True, block_q=block, block_k=block),
    }


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_impls(case):
    b, hq, hkv, lq, lk, d, causal = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, hq, hkv, lq, lk, d,
                                                     lq + lk))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, causal=causal).numpy()
    assert ref.attention_ref.calls == 1
    assert ops.LAUNCHES["flash_attention"] == 0
    for impl, want in _jax_outputs(case).items():
        # f32 throughout; the JAX test's own tolerance
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   err_msg=impl)


def test_plain_matches_jax_bf16():
    q, k, v = _inputs(1, 4, 2, 128, 128, 64, 1)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    # the same bf16 values on both sides
    qt, kt, vt = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (qj, kj, vj))
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (jax_ref(qj, kj, vj),
                 jax_flash(qj, kj, vj, impl="pallas", interpret=True)):
        # bf16 outputs, rounded from f32 sums taken in another order:
        # tests/test_kernels.py::test_flash_bf16's tolerance
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=0.05)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_on_a_ragged_key_length(causal):
    """Lk = 200 is no multiple of a block: ``flash_attention_pallas``
    refuses it, while the blockwise jnp version, the qwen3 config's
    default, masks the ragged edge."""
    q, k, v = _inputs(1, 4, 2, 72, 200, 64, 7)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal).numpy()
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    for want in (attention_flash_jnp(qj, kj, vj, causal=causal, block_k=64),
                 jax_ref(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_query_row_pieces_equal_the_whole():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 100, 160, 32, 3))
    whole = ref.attention_ref(q, k, v)
    pieces = [ref.attention_ref(q, k, v, q_rows=(lo, min(lo + 33, 100)))
              for lo in range(0, 100, 33)]
    torch.testing.assert_close(torch.cat(pieces, dim=2), whole, atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="q_rows"):
        ref.attention_ref(q, k, v, q_rows=(90, 101))


def test_wrapper_refuses():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 64, 128, 64, 0))
    with pytest.raises(ValueError, match="Lq <= Lk"):
        ops.flash_attention(k.repeat(1, 2, 2, 1), k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError, match="key/value heads"):
        ops.flash_attention(q[:, :3].contiguous(), k, v)


def test_cpu_calls_count_no_variant():
    """On CPU tensors the wrapper runs the plain version: neither kernel
    variant's count moves, for bf16 or f32."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16, 32, 32, 0))
    ops.reset_counts()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert ref.attention_ref.calls == 2
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.VARIANT_LAUNCHES == {"tensor_core": 0, "fma": 0}


def _emulate_tensor_core(q, k, v, split: bool, block_k: int = 64):
    """The bf16 kernel's arithmetic in plain PyTorch: S = Q K^T in f32 from
    bf16 (exact products), the online softmax over key tiles in f32, P V
    with P as bf16 (P_hi) or as P_hi + P_lo (``split``) and f32 sums, l
    summed from the f32 p, one rounding of O / l to bf16.  Causal, queries
    at the end of the keys."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    rows = torch.arange(lq)[:, None] + (lk - lq)
    m = torch.full((b, hq, lq, 1), -1e30)
    l = torch.zeros(b, hq, lq, 1)
    acc = torch.zeros(b, hq, lq, d)
    for k0 in range(0, lk, block_k):
        keys = torch.arange(k0, min(k0 + block_k, lk))
        s = q.float() @ kf[:, :, keys].transpose(-1, -2) * d ** -0.5
        s = torch.where(keys[None, :] <= rows, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, keys]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, keys]
        acc = alpha * acc + pv
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16()


def test_split_p_holds_bf16_tolerance_and_one_bf16_p_does_not():
    """Why the tensor-core kernel multiplies V by P in two bf16 halves: with
    P_hi + P_lo its arithmetic holds ``assert_close``'s bf16 defaults (atol
    1e-5, rtol 1.6e-2) against the plain version, the tolerance of the card
    tests and of chip_smoke.py's checks; with P rounded once to bf16 it does
    not, on the same inputs (GQA causal, [1, 4/2, 256, 64], seed 0)."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(1, 4, 2, 256, 256, 64, 0))
    want = ref.attention_ref(q, k, v)
    torch.testing.assert_close(_emulate_tensor_core(q, k, v, split=True),
                               want)
    with pytest.raises(AssertionError, match="Mismatched elements"):
        torch.testing.assert_close(
            _emulate_tensor_core(q, k, v, split=False), want)


# every (b, hq, hkv, lq, lk, d) that the CPU and card tests and the bench
# launch, each planned causal and not
PLAN_SHAPES = sorted({c[:6] for c in (*CASES, *FLASH_CASES,
                                      *bench.SHAPES.values())})


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_fma_plan_cuts_every_kept_tile_once_longest_first(shape, causal):
    b, hq, hkv, lq, lk, d = shape
    plan = ops.fma_plan(b, hq, hkv, lq, lk, d, causal)
    rows, keys = ops.FMA_ROWS, ops.FMA_KEYS
    n_qt = -(-lq // rows)

    def last_key(t):      # the last key the tile's last row sees
        return min(lq, (t + 1) * rows) - 1 + lk - lq if causal else lk - 1
    kept = {(t, kt) for t in range(n_qt) for kt in range(-(-lk // keys))
            if kt * keys <= last_key(t)}
    seen = collections.Counter()
    by_tile = collections.defaultdict(list)
    for t, c, lo, hi in plan.items:
        assert lo < hi                        # no item is empty
        assert lo * keys <= last_key(t)       # nor masked for every row
        assert c < plan.chunks(t)
        seen.update((t, kt) for kt in range(lo, hi))
        by_tile[t].append((c, hi - lo))
    assert set(seen) == kept and set(seen.values()) == {1}
    lengths = [hi - lo for _, _, lo, hi in plan.items]
    assert lengths == sorted(lengths, reverse=True)     # longest first
    for t, chunks in by_tile.items():     # nearly equal, within the cap
        assert sorted(c for c, _ in chunks) == list(range(plan.chunks(t)))
        sizes = [n for _, n in chunks]
        assert max(sizes) - min(sizes) <= 1
        assert max(sizes) <= plan.chunk_tiles
    items = plan.heads * len(plan.items)
    assert plan.heads == b * hq
    # two CTAs an SM wherever the work allows; a full grid is not cut
    assert items >= min(ops.FMA_SLOTS, plan.heads * len(kept))
    assert plan.split == (b * hq * n_qt < ops.FMA_SLOTS and items > b * hq
                          * n_qt)
    if shape == bench.SHAPES["long"][:6]:
        assert not plan.split and len(plan.items) == n_qt


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_fma_launch_args_pack_the_items_and_size_the_workspace(shape):
    """The kernel reads item z of the table as t | c << 16 (int32) and a
    split tile's chunks from slot ((bh * n_qt + t) * max_chunks + c) of
    the workspace; an unsplit call gets no table and no workspace."""
    b, hq, hkv, lq, lk, d = shape
    plan = ops.fma_plan(b, hq, hkv, lq, lk, d, True)
    chunk_tiles, n_items, packed, ws_floats = ops.fma_launch_args(plan, d)
    assert (chunk_tiles, n_items) == (plan.chunk_tiles, len(plan.items))
    if not plan.split:
        assert packed is None and ws_floats == 0
        return
    assert [(x & 0xFFFF, x >> 16) for x in packed] == [
        (t, c) for t, c, _, _ in plan.items]
    assert max(packed) < 2 ** 31
    slots = b * hq * -(-lq // ops.FMA_ROWS) * plan.max_chunks
    assert plan.max_chunks == max(plan.chunks(t) for t, *_ in plan.items)
    assert ws_floats == slots * ops.FMA_ROWS * (d + 2)


def test_fma_plan_splits_the_card_cases_as_they_expect():
    """The card tests assert each f32 case's split; the same here, so a
    change to the plan shows on the CPU first."""
    for case in FLASH_CASES:
        assert ops.fma_plan(*case).split == (case not in FMA_UNSPLIT), case


@pytest.mark.parametrize("chunk_tiles", [None, 2])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_emulation_matches_jax_impls(case, chunk_tiles):
    """The f32 kernel's split and merge, on its own plan (one key tile a
    chunk at these sizes) and on chunks of two key tiles (which leaves
    the smaller cases whole), against the JAX package's three
    functions."""
    b, hq, hkv, lq, lk, d, causal = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, hq, hkv, lq, lk, d,
                                                     lq + lk))
    plan = ops.fma_plan(*case, chunk_tiles=chunk_tiles)
    assert plan.split or chunk_tiles
    got = ref.attention_split_ref(q, k, v, plan, causal=causal).numpy()
    for impl, want in _jax_outputs(case).items():
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   err_msg=impl)


def test_split_emulation_weights_a_chunk_no_row_sees_by_zero():
    """96 queries over 128 keys (the queries from key 32 on), a key tile
    a chunk: query tile 0's second chunk (keys 64-127) is masked for its
    rows 0-31 (they see keys up to 32 + r), which keep m = -1e30 and sum
    p = 1 for each of the 64 keys into l.  The merge weights them by
    exp(-1e30 - m) = 0, and the result matches the JAX functions (blocks
    of 32, which these lengths take)."""
    case = (1, 2, 2, 96, 128, 64, True)
    q, k, v = (torch.from_numpy(x) for x in _inputs(*case[:6], 96 + 128))
    plan = ops.fma_plan(*case, chunk_tiles=1)
    assert (0, 1, 1, 2) in plan.items
    parts = {}
    got = ref.attention_split_ref(q, k, v, plan, parts=parts).numpy()
    m, l, acc = parts[0, 1]
    assert (m[:, :, :32] == ref.MASK_VALUE).all()
    assert (l[:, :, :32] == 64).all() and (m[:, :, 32:] > -1e29).all()
    assert acc[:, :, :32].abs().max() > 1      # the garbage is there
    for impl, want in _jax_outputs(case, block=32).items():
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   err_msg=impl)
