"""Connectivity checks on sorted CSR adjacency (paper §5.4; counterpart of
``repro.sparse.intersect``)."""
from __future__ import annotations

import torch


def binary_contains(sorted_arr: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, targets: torch.Tensor,
                    n_steps: int) -> torch.Tensor:
    """Is targets[i] in sorted_arr[lo[i]:hi[i]]?  ``n_steps`` branchless
    halvings, as the JAX version does, so the two agree bit for bit;
    ``n_steps >= ceil(log2(max segment length + 1))`` makes it exact.
    Empty segments return False."""
    last = sorted_arr.shape[0] - 1
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    low, high = lo, hi - 1
    for _ in range(max(n_steps, 1)):
        mid = (low + high) >> 1
        val = sorted_arr[mid.clamp(0, last).long()]
        go_right = val < targets
        low = torch.where(go_right, mid + 1, low)
        high = torch.where(go_right, high, mid - 1)
    probe = sorted_arr[low.clamp(0, last).long()]
    return (probe == targets) & (low < hi) & (lo < hi)


def linear_contains(sorted_arr: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, targets: torch.Tensor,
                    max_len: int) -> torch.Tensor:
    """Is targets[i] in sorted_arr[lo[i]:hi[i]]?  A scan of the first
    ``max_len`` entries of each segment (the paper's naive baseline, for
    the Fig. 13b ablation); the temporaries are ``[N, max_len]``."""
    offs = torch.arange(max_len, dtype=torch.int32, device=lo.device)
    idx = lo.to(torch.int32)[:, None] + offs[None, :]
    valid = idx < hi[:, None]
    vals = sorted_arr[idx.clamp(0, sorted_arr.shape[0] - 1).long()]
    return (valid & (vals == targets[:, None])).any(dim=1)


def adj_contains(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor, n_steps: int,
                 method: str = "binary") -> torch.Tensor:
    """isConnected(u, v): is v in the sorted adjacency of u?  ``method`` is
    "binary" (search) or "linear" (scan of ``2**n_steps`` entries).
    Negative u or v is padding and returns False."""
    if method not in ("binary", "linear"):
        raise ValueError(method)
    u_safe = u.clamp(0, row_ptr.shape[0] - 2).long()
    lo = row_ptr[u_safe]
    hi = row_ptr[u_safe + 1]
    if col_idx.shape[0] == 0:
        return torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    if method == "binary":
        found = binary_contains(col_idx, lo, hi, v, n_steps)
    else:
        found = linear_contains(col_idx, lo, hi, v, 1 << n_steps)
    return found & (u >= 0) & (v >= 0)


def intersect_count_sorted(col_idx: torch.Tensor, lo_a: torch.Tensor,
                           hi_a: torch.Tensor, lo_b: torch.Tensor,
                           hi_b: torch.Tensor, max_deg: int,
                           n_steps: int) -> torch.Tensor:
    """|col_idx[lo_a:hi_a] ∩ col_idx[lo_b:hi_b]| per pair, int32[n_pairs]
    (the TC hot loop; counterpart of the JAX ``intersect_count_sorted``).

    Each element of segment A is searched for in segment B with
    :func:`binary_contains`.  Only the first ``max_deg`` elements of A
    count, indices into ``col_idx`` clip at its last element, and an empty
    B counts 0, as in the JAX version, so the two agree bit for bit.  The
    temporaries are ``[n_pairs, max_deg]``.
    """
    m = col_idx.shape[0]
    offs = torch.arange(max_deg, dtype=torch.int32, device=col_idx.device)
    idx = lo_a.to(torch.int32)[:, None] + offs[None, :]
    valid = idx < hi_a[:, None]
    targets = col_idx[idx.clamp(0, m - 1).long()].reshape(-1)
    n = idx.shape[0]
    flat_lo = lo_b[:, None].expand(n, max_deg).reshape(-1)
    flat_hi = hi_b[:, None].expand(n, max_deg).reshape(-1)
    found = binary_contains(col_idx, flat_lo, flat_hi, targets, n_steps)
    return (found.reshape(n, max_deg) & valid).sum(dim=1, dtype=torch.int32)
