"""PyTorch port, flash attention: the port's ``flash_attention`` on CPU
tensors (its plain version, ``attention_ref``) against the JAX package's
three attention functions (the naive ``attention_ref``, the blockwise
``attention_flash_jnp`` and the Pallas kernel in interpret mode) on the
same inputs, made with numpy from a seed; the wrapper's refusals, and the
plain version's query-row pieces."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import (attention_flash_jnp,
                                               attention_ref as jax_ref)
from repro_torch.kernels.flash_attention import ops, ref

# b, hq, hkv, lq, lk, d, causal: tests/test_kernels.py's CASES
CASES = [
    (2, 4, 2, 128, 128, 64, True),       # GQA causal
    (1, 8, 8, 256, 256, 64, True),       # MHA
    (2, 4, 1, 64, 128, 32, False),       # MQA bidirectional
    (1, 2, 2, 128, 384, 64, True),       # lq < lk (chunked prefill)
    (1, 4, 2, 1, 256, 64, True),         # decode: single query
    (2, 4, 4, 64, 256, 128, True),
]


def _inputs(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_outputs(case):
    b, hq, hkv, lq, lk, d, causal = case
    q, k, v = (jnp.asarray(x) for x in _inputs(b, hq, hkv, lq, lk, d,
                                                lq + lk))
    return {
        "attention_ref": jax_ref(q, k, v, causal=causal),
        "flash_jnp": attention_flash_jnp(q, k, v, causal=causal, block_k=64),
        "pallas": jax_flash(q, k, v, causal=causal, impl="pallas",
                            interpret=True, block_q=64, block_k=64),
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
