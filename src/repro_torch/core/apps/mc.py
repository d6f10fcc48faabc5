"""k-motif counting (paper Listing 4, §4.2; counterpart of
``repro.core.apps.mc``).

The default for k <= 5 is the multi-pattern trie: every connected k-vertex
pattern (:func:`~repro_torch.core.patterns.motif_patterns`) compiles into
one common-prefix plan, counted in one traversal with a per-embedding
branch bitmap and no canonical labeling; ``p_map`` comes in the motif-enum
order for k = 3 / 4 and in canonical-code order for k = 5.

The other modes (the Fig. 12c ablation and parity oracles) extend with the
canonical test and classify in the reduce:
  * ``memo``    — the previous level's motif id and wedge centre carried in
    the state (``state = motif_id * 4 + center``); the new level is
    classified from three connectivity bits (Fig. 6).
  * ``custom``  — rebuild the k x k adjacency and classify by edge count
    and degree signature (Listing 6).
  * ``generic`` — canonical labeling over all k! permutations, by quick
    patterns first; also the path of k = 5 in the ``memo`` mode, and of
    k >= 6, where the 32-bit branch bitmap cannot hold the patterns.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pattern as P
from repro_torch.core.api import GraphCtx, MiningApp
from repro_torch.core.patterns import motif_patterns, n_connected_patterns
from repro_torch.core.phases.reference import build_adjacency

# the trie path threads a per-embedding branch bitmap in one i32
_MAX_SET_K = 5


def make_mc_set_app(k: int, backend: str | None = None) -> MiningApp:
    """mc(k) via the multi-pattern common-prefix trie (k <= 5)."""
    if k > _MAX_SET_K:
        raise ValueError(
            f"{k}-motif counting cannot use the multi-pattern trie: "
            f"{n_connected_patterns(k) if k <= 6 else 'too many'} patterns "
            f"exceed the 32-bit branch bitmap; use mode='generic' (the "
            "canonical-labeling reduce) instead")
    from repro_torch.core.apps.psm import pattern_set_app
    app = pattern_set_app(motif_patterns(k), induced=True, backend=backend)
    return dataclasses.replace(app, name=f"{k}-motif")


def make_mc_app(k: int, mode: str = "auto", use_quick: bool = True,
                max_patterns: int | None = None) -> MiningApp:
    if k in P.N_MOTIFS and P.N_MOTIFS[k] != n_connected_patterns(k):
        raise RuntimeError(
            f"P.N_MOTIFS[{k}] = {P.N_MOTIFS[k]} disagrees with the "
            f"exhaustive enumeration n_connected_patterns({k}) = "
            f"{n_connected_patterns(k)}")
    if mode == "auto":
        # the trie where the bitmap fits; an explicit max_patterns asks for
        # the classified-reduce table
        mode = "set" if (k <= _MAX_SET_K and max_patterns is None) \
            else "memo"
    if mode == "set":
        return make_mc_set_app(k)
    if max_patterns is None:
        # the table must hold every connected k-vertex graph; beyond the
        # enumeration's reach this raises rather than guess
        max_patterns = P.N_MOTIFS.get(k)
        if max_patterns is None:
            try:
                max_patterns = n_connected_patterns(k)
            except ValueError as e:
                raise ValueError(
                    f"{k}-motif counting needs an explicit max_patterns: "
                    f"{e}") from e

    def get_pattern(ctx: GraphCtx, emb: torch.Tensor, state, valid):
        kk = emb.shape[1]
        if mode == "generic" or kk not in (3, 4):
            adj = build_adjacency(ctx, emb)
            # the quick table must hold every identity-order code
            n_quick = 2 ** (kk * (kk - 1) // 2)
            if use_quick and n_quick <= 1024:
                codes = P.canonicalize_via_quick(adj, None, kk, 1,
                                                 max_unique=n_quick)
            else:
                codes = P.canonical_code(adj, None, kk)
            codes = torch.where(valid, codes, P.INT_MAX)
            _, pat = P.unique_fixed(codes, max_patterns + 1)
            return pat, pat
        if kk == 3:
            u = emb[:, 2]
            c0 = ctx.is_connected(u, emb[:, 0])
            c1 = ctx.is_connected(u, emb[:, 1])
            pat = torch.where(c0 & c1, P.TRIANGLE, P.WEDGE).to(torch.int32)
            # with edge (v0, v1) present the wedge's centre is v0 when u
            # is adjacent to v0 only, else v1
            center = torch.where(c0, 0, 1).to(torch.int32)
            return pat, pat * 4 + center
        if mode == "memo":
            conn = torch.stack([ctx.is_connected(emb[:, 3], emb[:, j])
                                for j in range(3)], dim=1)
            pat = P.classify_4motif_memoized(state // 4, state % 4, conn)
        else:
            pat = P.classify_4motif(build_adjacency(ctx, emb))
        return pat, pat * 4

    return MiningApp(name=f"{k}-motif", kind="vertex", max_size=k,
                     needs_reduce=True, max_patterns=max_patterns,
                     get_pattern=get_pattern)
