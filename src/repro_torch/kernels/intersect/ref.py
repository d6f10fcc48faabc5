"""Plain PyTorch version of the intersection-count kernel (counterpart of
``repro.kernels.intersect.ref``).

It computes exactly what ``csrc/intersect.cu`` computes, with PyTorch ops,
on any device.  The wrapper in ``ops.py`` takes it for CPU tensors; the
tests hold it against the JAX package's ``intersect_count_sorted`` and its
Pallas kernel in interpret mode, and ``chip_smoke.py`` holds the kernel
against it on the card.  ``calls`` counts how often it ran.
"""
from __future__ import annotations

from repro_torch.sparse.intersect import intersect_count_sorted


def intersect_count_ref(col_idx, lo_a, hi_a, lo_b, hi_b, *, max_deg: int,
                        n_steps: int, pairs=None):
    """|N(a) ∩ N(b)| per pair, int32[n_pairs].  With ``pairs=(lo, hi)``,
    only pairs ``lo .. hi-1`` (int32[hi - lo]): the temporaries are
    ``[n_pairs, max_deg]``, so a large launch is checked piece by piece."""
    intersect_count_ref.calls += 1
    n = lo_a.shape[0]
    lo, hi = (0, n) if pairs is None else pairs
    if not 0 <= lo < hi <= n:
        raise ValueError(f"pairs {pairs} outside [0, {n})")
    return intersect_count_sorted(col_idx, lo_a[lo:hi], hi_a[lo:hi],
                                  lo_b[lo:hi], hi_b[lo:hi], max_deg=max_deg,
                                  n_steps=n_steps)


intersect_count_ref.calls = 0
