"""Plain PyTorch version of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ref.attention_ref``).

It computes what ``csrc/flash.cu`` computes, with PyTorch ops, on any
device: the whole score matrix in f32, masked at -1e30 with the queries at
the end of the keys, softmax, then the product with V.  The wrapper in
``ops.py`` takes it for CPU tensors; the tests hold it against the JAX
package's three attention functions, and ``chip_smoke.py`` holds the
kernel against it on the card.  ``calls`` counts how often it ran.
"""
from __future__ import annotations

import torch

MASK_VALUE = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None, q_rows=None):
    """Attention with GQA: q [B, Hq, Lq, D]; k, v [B, Hkv, Lk, D]; query
    head h reads key/value head ``h // (Hq // Hkv)``.  Returns [B, Hq, Lq,
    D] in q's dtype.  With ``q_rows=(lo, hi)``, only query rows lo .. hi-1
    ([B, Hq, hi - lo, D]): the scores are [B, Hq, Lq, Lk] in f32, so a long
    sequence is checked piece by piece."""
    attention_ref.calls += 1
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    lo, hi = (0, lq) if q_rows is None else q_rows
    if not 0 <= lo < hi <= lq:
        raise ValueError(f"q_rows {q_rows} outside [0, {lq})")
    if sm_scale is None:
        sm_scale = d ** -0.5
    group = hq // hkv
    # head h = kv * group + g, so the grouped view reads K/V in place
    qg = q[:, :, lo:hi].float().reshape(b, hkv, group, hi - lo, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * sm_scale
    if causal:
        rows = torch.arange(lo, hi, device=q.device) + (lk - lq)
        keep = torch.arange(lk, device=q.device)[None, :] <= rows[:, None]
        s = torch.where(keep, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, hi - lo, d).to(q.dtype)


attention_ref.calls = 0
