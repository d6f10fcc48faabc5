"""Plain PyTorch version of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ref.attention_ref``).

It computes what ``csrc/flash.cu`` computes, with PyTorch ops, on any
device: the whole score matrix in f32, masked at -1e30 with the queries at
the end of the keys, softmax, then the product with V.  The wrapper in
``ops.py`` takes it for CPU tensors; the tests hold it against the JAX
package's three attention functions, and ``chip_smoke.py`` holds the
kernel against it on the card.  ``calls`` counts how often it ran.
``attention_split_ref``, used by tests only, repeats the f32 kernel's
split of the key range into ``ops.fma_plan``'s chunks and their merge.
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


def attention_split_ref(q, k, v, plan, *, causal: bool = True,
                        sm_scale: float | None = None, parts=None):
    """The f32 kernel's split of the keys on ``plan`` (``ops.fma_plan``'s)
    and its merge, in plain PyTorch with f32 products: each item's chunk
    of key tiles runs the online softmax from m = -1e30, l = 0 over whole
    tiles (keys past Lk zero and masked, masked scores -1e30, so a row that
    sees no key of the chunk keeps m = -1e30 and sums p = 1 a key into l
    and its accumulator); then each query tile's chunks are added in chunk
    order, weighted by exp(m_c - max m), and divided by l (l == 0 divides
    by 1).  Same arguments and result as :func:`attention_ref`; ``parts``,
    a dict if given, receives each (t, c)'s (m, l, accumulator) before the
    merge."""
    from repro_torch.kernels.flash_attention.ops import FMA_KEYS, FMA_ROWS

    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    n_keys = -(-lk // FMA_KEYS) * FMA_KEYS
    pad = (0, 0, 0, n_keys - lk)
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(
        hq // hkv, 1)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(
        hq // hkv, 1)
    parts = {} if parts is None else parts
    for t, c, lo, hi in plan.items:
        r0, r1 = t * FMA_ROWS, min((t + 1) * FMA_ROWS, lq)
        pos = torch.arange(r0, r1)[:, None] + (lk - lq)
        m = torch.full((b, hq, r1 - r0, 1), MASK_VALUE)
        l = torch.zeros(b, hq, r1 - r0, 1)
        acc = torch.zeros(b, hq, r1 - r0, d)
        for kt in range(lo, hi):
            keys = torch.arange(kt * FMA_KEYS, (kt + 1) * FMA_KEYS)
            s = q[:, :, r0:r1].float() @ kf[:, :, keys].transpose(-1, -2)
            keep = (keys < lk) & ((keys <= pos) if causal else True)
            s = torch.where(keep, s * sm_scale, MASK_VALUE)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + p @ vf[:, :, keys]
            m = m_new
        parts[t, c] = m, l, acc
    out = torch.empty(b, hq, lq, d)
    for t in range(len(plan.key_tiles)):
        chunks = [parts[t, c] for c in range(plan.chunks(t))]
        top = torch.stack([m for m, _, _ in chunks]).amax(0)
        l = torch.zeros_like(top)
        acc = torch.zeros_like(chunks[0][2])
        for m, lc, ac in chunks:
            w = torch.exp(m - top)
            l, acc = l + w * lc, acc + w * ac
        out[:, :, t * FMA_ROWS:(t + 1) * FMA_ROWS] = acc / torch.where(
            l == 0, 1.0, l)
    return out.to(q.dtype)
