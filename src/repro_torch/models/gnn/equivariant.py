"""Equivariant substrate (counterpart of ``repro.models.gnn.equivariant``):
real spherical harmonics, Wigner rotation matrices and Clebsch-Gordan
couplings, shared by NequIP (tensor products) and EquiformerV2 (eSCN SO(2)
convolutions).

Conventions are the JAX package's: real SH ordered m = -l..l within each
l, no Condon-Shortley phase; Wigner matrices for that basis from the
Ivanic-Ruedenberg recursion, table-driven (three gathers and one sum a
level); CG couplings derived numerically as the one-dimensional null space
of the equivariance constraint built from this module's own f32 Wigner
matrices, so they agree with the SH and D conventions by construction.
The couplings and the recursion's tables are computed on the host once and
moved to each (device, dtype) once, not once a call.

The grad-safe substitutions for degenerate and padding edges are kept as
they are in JAX: ``torch.where`` turns an unselected ``inf`` into a NaN
gradient just as ``jnp.where`` does, so every branch stays finite.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Real spherical harmonics (recursive associated Legendre, CS-phase-free)


def real_sph_harm(vec: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real SH of unit vectors. vec: [..., 3] -> [..., (l_max+1)^2].

    Ordering: blocks l = 0..l_max, within block m = -l..l.
    Y_{1,(-1,0,1)} ∝ (y, z, x).
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    ct = z
    st = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    # grad-safe atan2: at x=y=0 (degenerate/self edges) the true gradient
    # is undefined (NaN); substitute x=1 there so autograd stays finite.
    degen = (torch.abs(x) + torch.abs(y)) < 1e-9
    phi = torch.atan2(torch.where(degen, 0.0, y), torch.where(degen, 1.0, x))
    # associated Legendre P_l^m(ct) (no CS phase), m >= 0
    P = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            K = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            if m > 0:
                val = math.sqrt(2.0) * K * torch.cos(m * phi) * P[(l, m)]
            elif m < 0:
                val = math.sqrt(2.0) * K * torch.sin(am * phi) * P[(l, am)]
            else:
                val = K * P[(l, 0)]
            out.append(val)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Wigner rotation matrices for real SH (Ivanic & Ruedenberg recursion)


def _r1_from_rot(R: torch.Tensor) -> torch.Tensor:
    """l=1 real-SH rotation from a 3x3 coordinate rotation (rows x,y,z).

    Basis (m=-1,0,1) = (y, z, x).
    """
    perm = [1, 2, 0]
    return R[..., perm, :][..., :, perm]


def _ir_coefs(l: int, m: int, n: int) -> tuple[float, float, float]:
    """The recursion's (u, v, w) at D^l[m, n]."""
    denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
    u = math.sqrt((l + m) * (l - m) / denom)
    d_m0 = 1.0 if m == 0 else 0.0
    v = 0.5 * math.sqrt((1 + d_m0) * (l + abs(m) - 1)
                        * (l + abs(m)) / denom) * (1 - 2 * d_m0)
    w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * \
        (1 - d_m0)
    return u, v, w


@functools.lru_cache(maxsize=None)
def _wigner_term_tables(l: int):
    """Static term tables for the IR recursion at level l.

    Every D^l entry is a short sum of coef * R1[flat] * D^{l-1}[flat]
    products; collecting the (coef, r1_idx, dp_idx) triples on the host
    turns the per-entry scalar recursion into 3 batched gathers and one
    reduction per level.  Returns (idx_r1 [(2l+1)^2, K], idx_dp
    [(2l+1)^2, K], coef [(2l+1)^2, K]).
    """
    def p_terms(i, m, n):
        # P_i(m, n) -> [(r1_col c, dp (m', n'), coef)]
        if abs(n) < l:
            return [((i, 0), (m, n), 1.0)]
        if n == l:
            return [((i, 1), (m, l - 1), 1.0),
                    ((i, -1), (m, -l + 1), -1.0)]
        return [((i, 1), (m, -l + 1), 1.0), ((i, -1), (m, l - 1), 1.0)]

    entries = []
    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            u, v, w = _ir_coefs(l, m, n)
            terms = []
            if u != 0.0:
                terms += [(r, d, u * c) for r, d, c in p_terms(0, m, n)]
            if v != 0.0:
                if m == 0:
                    vt = p_terms(1, 1, n) + p_terms(-1, -1, n)
                elif m > 0:
                    s1 = math.sqrt(1 + (1.0 if m == 1 else 0.0))
                    s2 = 0.0 if m == 1 else 1.0
                    vt = [(r, d, c * s1) for r, d, c in p_terms(1, m - 1, n)]
                    vt += [(r, d, -c * s2)
                           for r, d, c in p_terms(-1, -m + 1, n)]
                else:
                    s1 = 0.0 if m == -1 else 1.0
                    s2 = math.sqrt(1 + (1.0 if m == -1 else 0.0))
                    vt = [(r, d, c * s1) for r, d, c in p_terms(1, m + 1, n)]
                    vt += [(r, d, c * s2)
                           for r, d, c in p_terms(-1, -m - 1, n)]
                terms += [(r, d, v * c) for r, d, c in vt]
            if w != 0.0:
                if m > 0:
                    wt = p_terms(1, m + 1, n) + p_terms(-1, -m - 1, n)
                else:
                    wt = [(r, d, c) for r, d, c in p_terms(1, m - 1, n)]
                    wt += [(r, d, -c) for r, d, c in p_terms(-1, -m + 1, n)]
                terms += [(r, d, w * c) for r, d, c in wt]
            terms = [t for t in terms if t[2] != 0.0]
            entries.append(terms)
    K = max(len(t) for t in entries)
    n_e = (2 * l + 1) ** 2
    idx_r1 = np.zeros((n_e, K), np.int64)
    idx_dp = np.zeros((n_e, K), np.int64)
    coef = np.zeros((n_e, K), np.float32)
    for e, terms in enumerate(entries):
        for k, ((i, c), (mp, npp), cf) in enumerate(terms):
            idx_r1[e, k] = (i + 1) * 3 + (c + 1)
            idx_dp[e, k] = (mp + l - 1) * (2 * l - 1) + (npp + l - 1)
            coef[e, k] = cf
    return idx_r1, idx_dp, coef


@functools.lru_cache(maxsize=None)
def _tables_on(l: int, device: torch.device, dtype: torch.dtype):
    """Level l's tables on ``device``, the coefficients in ``dtype``."""
    idx_r1, idx_dp, coef = _wigner_term_tables(l)
    return (torch.from_numpy(idx_r1).to(device),
            torch.from_numpy(idx_dp).to(device),
            torch.from_numpy(coef).to(device=device, dtype=dtype))


def wigner_d_matrices(R: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """[D^0, D^1, ..., D^{l_max}] for rotation(s) R [..., 3, 3].

    Satisfies Y_l(R @ v) = D^l(R) @ Y_l(v) for the real SH above.
    Table-driven batched evaluation (see _wigner_term_tables).
    """
    batch = tuple(R.shape[:-2])
    Ds = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return Ds
    R1 = _r1_from_rot(R)
    Ds.append(R1)
    r1f = R1.reshape(batch + (9,))
    for l in range(2, l_max + 1):
        idx_r1, idx_dp, coef = _tables_on(l, R.device, R.dtype)
        dpf = Ds[l - 1].reshape(batch + ((2 * l - 1) ** 2,))
        terms = r1f[..., idx_r1] * dpf[..., idx_dp] * coef
        Ds.append(torch.sum(terms, dim=-1).reshape(
            batch + (2 * l + 1, 2 * l + 1)))
    return Ds


def wigner_d_matrices_reference(R: torch.Tensor, l_max: int
                                ) -> list[torch.Tensor]:
    """Entry-wise IR recursion (the readable version; test oracle for the
    table-driven path)."""
    batch = tuple(R.shape[:-2])
    Ds = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return Ds
    R1 = _r1_from_rot(R)
    Ds.append(R1)

    def get(Dl, l, m, n):
        return Dl[..., m + l, n + l]

    for l in range(2, l_max + 1):
        Dp = Ds[l - 1]                 # D^{l-1}

        def P(i, m, n):
            # helper P_i(m, n) of the IR paper
            if abs(n) < l:
                return get(R1, 1, i, 0) * get(Dp, l - 1, m, n)
            if n == l:
                return (get(R1, 1, i, 1) * get(Dp, l - 1, m, l - 1)
                        - get(R1, 1, i, -1) * get(Dp, l - 1, m, -l + 1))
            # n == -l
            return (get(R1, 1, i, 1) * get(Dp, l - 1, m, -l + 1)
                    + get(R1, 1, i, -1) * get(Dp, l - 1, m, l - 1))

        rows = []
        for m in range(-l, l + 1):
            row = []
            for n in range(-l, l + 1):
                u, v, w = _ir_coefs(l, m, n)
                term = 0.0
                if u != 0.0:
                    term = term + u * P(0, m, n)
                if v != 0.0:
                    if m == 0:
                        V = P(1, 1, n) + P(-1, -1, n)
                    elif m > 0:
                        V = P(1, m - 1, n) * math.sqrt(
                            1 + (1.0 if m == 1 else 0.0)) \
                            - P(-1, -m + 1, n) * (0.0 if m == 1 else 1.0)
                    else:
                        V = P(1, m + 1, n) * (0.0 if m == -1 else 1.0) \
                            + P(-1, -m - 1, n) * math.sqrt(
                                1 + (1.0 if m == -1 else 0.0))
                    term = term + v * V
                if w != 0.0:
                    if m > 0:
                        W = P(1, m + 1, n) + P(-1, -m - 1, n)
                    else:
                        W = P(1, m - 1, n) - P(-1, -m + 1, n)
                    term = term + w * W
                row.append(term)
            rows.append(torch.stack(row, dim=-1))
        Ds.append(torch.stack(rows, dim=-2))
    return Ds


def apply_wigner(Ds: list[torch.Tensor], x: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """Apply per-l Wigner blocks to SH-basis features.

    Ds: output of :func:`wigner_d_matrices` ([..., 2l+1, 2l+1] per l);
    x: [..., C, (l_max+1)^2].  Never materializes the block-diagonal
    [(L+1)^2, (L+1)^2] matrix.
    """
    eq = "...ji,...cj->...ci" if transpose else "...ij,...cj->...ci"
    out = []
    off = 0
    for l, D in enumerate(Ds):
        k = 2 * l + 1
        out.append(torch.einsum(eq, D, x[..., off:off + k]))
        off += k
    return torch.cat(out, dim=-1)


def block_diag_wigner(R: torch.Tensor, l_max: int) -> torch.Tensor:
    """Full [(l_max+1)^2, (l_max+1)^2] block-diagonal D(R) (per batch
    element)."""
    Ds = wigner_d_matrices(R, l_max)
    dim = (l_max + 1) ** 2
    out = R.new_zeros(tuple(R.shape[:-2]) + (dim, dim))
    off = 0
    for l, D in enumerate(Ds):
        k = 2 * l + 1
        out[..., off:off + k, off:off + k] = D
        off += k
    return out


def edge_align_rotation(vec: torch.Tensor) -> torch.Tensor:
    """Rotation R with R @ v_hat = z_hat (align edge to the z axis).

    R = Ry(-theta) @ Rz(-phi); vec: [..., 3] (need not be normalized).
    """
    # gradient-safe normalization: every sqrt sees a strictly-positive
    # argument and every where() branch is finite under autograd
    # (degenerate edges appear as padding; they must not NaN gradients).
    n = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-24)
    v = vec / torch.clamp_min(n, 1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rho2 = x * x + y * y
    degen = rho2 < 1e-18
    rho = torch.sqrt(torch.where(degen, 1.0, rho2))
    cphi = torch.where(degen, 1.0, x / rho)
    sphi = torch.where(degen, 0.0, y / rho)
    cth = z
    sth = torch.where(degen, 0.0, rho)
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    Rz = torch.stack([
        torch.stack([cphi, sphi, zeros], -1),
        torch.stack([-sphi, cphi, zeros], -1),
        torch.stack([zeros, zeros, ones], -1)], -2)
    Ry = torch.stack([
        torch.stack([cth, zeros, -sth], -1),
        torch.stack([zeros, ones, zeros], -1),
        torch.stack([sth, zeros, cth], -1)], -2)
    return Ry @ Rz


# ---------------------------------------------------------------------------
# Clebsch-Gordan couplings (numerical null-space derivation, cached)


@functools.lru_cache(maxsize=None)
def cg_coefficients(l1: int, l2: int, l3: int) -> np.ndarray:
    """Invariant coupling C[m3, m1, m2]: (h1 ⊗ h2)_l3 = C · h1 ⊗ h2.

    Unique (up to sign and scale) solution of
        D3(R) C = C (D1(R) ⊗ D2(R))  for all R;
    derived as the null space of constraints stacked over four seeded
    random rotations, using this module's f32 Wigner matrices (computed on
    the CPU) and an SVD in float64.  Normalized to unit Frobenius norm,
    the first significant entry positive.  Zero if the triangle inequality
    fails.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l3 + 1, 2 * l1 + 1, 2 * l2 + 1))
    rng = np.random.default_rng(l1 * 49 + l2 * 7 + l3)
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rows = []
    for _ in range(4):
        # random rotation via QR
        A = rng.standard_normal((3, 3))
        Q, _ = np.linalg.qr(A)
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        with torch.no_grad():
            Ds = wigner_d_matrices(torch.tensor(Q[None], dtype=torch.float32),
                                   max(l1, l2, l3))
        D1 = Ds[l1][0].numpy().astype(np.float64)
        D2 = Ds[l2][0].numpy().astype(np.float64)
        D3 = Ds[l3][0].numpy().astype(np.float64)
        # constraint: D3 C - C (D1 (x) D2) = 0, vectorized over C
        K = np.kron(D3, np.eye(d1 * d2)) - \
            np.kron(np.eye(d3), np.kron(D1, D2).T)
        rows.append(K)
    K = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(K)
    null = vt[-1]
    assert s[-1] < 1e-4, f"no invariant coupling for ({l1},{l2},{l3})"
    C = null.reshape(d3, d1, d2)
    C = C / np.linalg.norm(C)
    # deterministic sign: first significant entry positive
    flat = C.reshape(-1)
    idx = np.argmax(np.abs(flat) > 1e-8)
    if flat[idx] < 0:
        C = -C
    return C


@functools.lru_cache(maxsize=None)
def _cg_on(l1: int, l2: int, l3: int, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """``cg_coefficients(l1, l2, l3)`` on ``device`` in ``dtype``, moved
    there once."""
    return torch.from_numpy(cg_coefficients(l1, l2, l3)).to(device=device,
                                                             dtype=dtype)


def tensor_product(h1: torch.Tensor, h2: torch.Tensor, l1: int, l2: int,
                   l3: int) -> torch.Tensor:
    """CG contraction: h1 [..., 2l1+1] x h2 [..., 2l2+1] -> [..., 2l3+1]."""
    C = _cg_on(l1, l2, l3, h1.device, h1.dtype)
    return torch.einsum("...a,...b,cab->...c", h1, h2, C)
