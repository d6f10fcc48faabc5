#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device   — the card's name and power limit.
2. build    — compile every CUDA source of the port with nvcc (all at
              once) and print each ``-Xptxas -v`` report.
3. kernels  — TC and 4-CF run cold and warm through ``Miner.run`` with
              every kernel launch held against its plain PyTorch version
              on the same inputs on the card, bit for bit, at the shapes
              the path gives it: at RMAT scale 12 (edge factor 16, seed 0)
              with the full bit-packed adjacency (``bitmap``) and without
              it (``search``), then at the main size, RMAT-16 (``search``,
              up to 2^30 candidate slots, where the plain version runs
              over tile-aligned slot ranges).  Each pass-2 launch is also
              replayed with half its ``out_cap`` (overflow).  Then each
              kernel and its plain version are timed with CUDA events on
              the arguments of the RMAT-16 TC level-2 launches, beside the
              kernel's memory bound.
4. main path — ``Miner(rmat(16, 16, seed=0), app, backend="cuda")`` runs
              cold, then warm, for TC and 4-CF.  Each count must equal an
              independent count computed here on the host with scipy, every
              kernel must have launched during the run, and no plain version
              may have run.  Then a warm-run profile of each.
5. fsm      — 3-FSM (``make_fsm_app(3, min_support, max_patterns=64)``),
              edge-induced, on the edge kernel ``extend_edge``.  Checked
              runs (every launch against its plain version, cold and warm)
              on ``rmat(12, 8, seed=0, labels=4)`` at a min_support that
              drops one label, and on the main graph ``rmat(15, 8, seed=0,
              labels=4)`` at 2500.  Then the kernel's timing on the main
              graph's level-2 launch, the counted main path on the main
              graph (frequent supports equal to a scipy count, 2 launches
              cold and 1 warm, no plain call, the warm replay free of
              device syncs up to its final read), and a warm-run profile.
6. tc-fused — the hand-optimised triangle count ``triangle_count_fused(g)``
              on the intersection kernel ``intersect_count``, on RMAT-12 and
              RMAT-16: each launch held against its plain version pair by
              pair (in pieces), the count against scipy, then the counted
              cold and warm calls (one launch and no plain call each).
7. cuda-1p  — TC and 4-CF cold and warm through ``Miner(...,
              backend="cuda-1p")``, the single-pass pruned extend
              ``extend_pruned_1p``, at the three sizes and modes of phase 3:
              each launch held against its plain version over its whole
              slot range (in pieces, the survivor offset carried from piece
              to piece), rerun at half its ``out_cap`` (overflow), and its
              buffers against the two-pass pair's on the same level.  Then
              its timing beside the pair's, the counted main path on RMAT-16
              (counts equal to scipy, no plain call and no launch of the
              pair, the warm replay free of device syncs), and a warm-run
              profile of 4-CF.
8. mc       — k-motif counting and compiled patterns, the state,
              canonical and labeled variants of the pruned kernels.
              Checked runs (every launch against its plain version, state
              buffers included, cold and warm, on ``cuda`` and
              ``cuda-1p``): 3-MC, 4-MC (the pattern-set trie: a branch set
              with its state column), 4-MC's ``memo`` mode (the canonical
              test), a directed and a symmetric pattern set on
              ``rmat(8, 16, seed=0)`` with and without the pack;
              ``pattern_app(diamond)`` on ``rmat(10, 16, seed=0)`` and the
              labeled chain 0-1-2 on ``rmat(12, 8, seed=0, labels=3)``.
              Then the main sizes, 3-MC on ``rmat(15, 16, seed=0)``
              (885,076,244 level-2 candidates), 4-MC and the diamond on
              ``rmat(10, 16, seed=0)``: checked the same way (the plain
              versions over 2^25-slot pieces), then counted, cold and warm
              on both backends, each count and p_map against a scipy
              census computed here, no plain call, and the two backends'
              levels (vid, idx, state) equal.  Then the branch-set + state variant
              of ``extend_count``, ``extend_scatter`` and
              ``extend_pruned_1p`` timed on 4-MC's level-3 arguments, and a
              warm-run profile of 4-MC.
9. lm       — Qwen3-0.6B at full width in bf16 (random weights from seed 0)
              served through ``serve_lm``: request set A (batch 4, prompt
              4,096 tokens, 32 new) and set B (batch 1, prompt 32,768, 8
              new), every ``flash_attention`` launch of both held against
              ``attention_ref`` on the card (in pieces of query rows), the
              kernel timed on set A's layer-0 arguments beside the plain
              version and ``scaled_dot_product_attention``, and on set B's
              beside the latter alone (the plain version's f32 scores
              would take 64 GB at 32k); then each set served again with
              the launches counted (28 per prefill, all of them the
              tensor-core variant, no plain call), its prefill time,
              decode rate and peak memory; a profile of set A's prefill
              and of one decode step; then the model in f32 (batch 1,
              prompt 512, TF32 off, the FMA variant): prefill on the
              kernel against prefill on the plain attention (last-token
              logits within 1e-3) and the same 8 greedy tokens.
10. segsum  — the segment sum ``sorted_segment_sum`` at ogb_products'
              scale (``configs/shapes.py``: 61,859,140 rows of 100 f32
              values into 2,449,029 sorted segments, 24.7 GB): sorted,
              unsorted and bf16 launches held against the plain version,
              the kernel timed beside it and ``index_add_``, then one
              counted launch.

The line before the last two is the kernels' JSON record; the line before
the last is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
TPU_KERNEL = "src/repro/kernels/extend_fused/extend.py"
REPLACES = {"extend_candidates": f"{TPU_KERNEL}:65",
            "extend_count": f"{TPU_KERNEL}:505",
            "extend_scatter": f"{TPU_KERNEL}:519"}
EDGE_REPLACES = {"extend_edge": f"{TPU_KERNEL}:658"}
LOOKBACK_REPLACES = {"extend_pruned_1p": f"{TPU_KERNEL}:322"}
INTERSECT_REPLACES = {
    "intersect_count": "src/repro/kernels/intersect/intersect.py:30"}
FLASH_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/flash.py:27"}
SEGSUM_REPLACES = {
    "sorted_segment_sum": "src/repro/kernels/segsum/segsum.py:26"}
# kernels with float outputs: their checks hold them to a tolerance
FLOAT_KERNELS = (*FLASH_REPLACES, *SEGSUM_REPLACES)
# the [lm] phase's request sets: (batch, prompt tokens, new tokens)
LM_SETS = {"A": (4, 4096, 32), "B": (1, 32768, 8)}
FSM_SUPPORT = 2500              # main FSM configuration's min_support
FSM_FREQUENT = 24               # its frequent 3-FSM patterns


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """Mean milliseconds per call from CUDA events, after one warm-up, and
    the last call's result."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        del out
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def int_args(kw: dict) -> dict:
    """A launch's integer keyword arguments (its shape), for messages."""
    return {k: v for k, v in kw.items() if type(v) is int}


def sync_free(fn):
    """``fn()`` after a device sync, with every device sync inside it an
    error."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching int tensors; raises on a shape
    mismatch."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max().item()))
    return err


# ---------------------------------------------------------------------------
# Kernel launches held against their plain versions


def wrapper_module(name: str):
    """The ``ops`` module that defines kernel wrapper ``name``."""
    if name in INTERSECT_REPLACES:
        from repro_torch.kernels.intersect import ops
    elif name in FLASH_REPLACES:
        from repro_torch.kernels.flash_attention import ops
    elif name in SEGSUM_REPLACES:
        from repro_torch.kernels.segsum import ops
    else:
        from repro_torch.kernels.extend_fused import ops
    return ops


class KernelChecks:
    """While active, every launch of a kernel wrapper on the port's path is
    held against the wrapper's plain version on the same inputs.

    The plain versions run over tile-aligned slot ranges of ``chunk``
    slots (``ref``'s ``slots=``), since at 2^30 candidate slots their
    temporaries would not fit beside the kernel's outputs; the pieces
    cover every output element (``intersect_count``: pieces of pairs
    holding about ``chunk`` lanes).  Each ``extend_scatter`` and
    ``extend_pruned_1p`` launch is also replayed with half its
    ``out_cap`` (an overflow case) and held against the plain version at
    that capacity; each ``extend_pruned_1p`` launch's buffers are also
    held against the two-pass pair's on the same inputs (``pair_matches``
    counts them).  While ``keep`` is set, the first launch of each kernel
    keeps its arguments (``kept``) for timing.  ``names`` are the kernels
    checked.  Each ``extend_edge`` launch also records ``(cand_cap,
    candidates, survivors, masked)`` in ``edge_levels``, ``masked``
    counting the live candidates that the app's vertex mask dropped.
    The float kernels (``FLOAT_KERNELS``) are held to a stated tolerance
    by their checks, which raise themselves; ``err`` keeps the largest
    absolute difference.
    """

    def __init__(self, chunk: int = 1 << 25, names=tuple(REPLACES)):
        from repro_torch.kernels.extend_fused import ref
        assert chunk % ref.BLOCK_C == 0
        self.chunk = chunk
        self.names = tuple(names)
        self.err = {name: 0 for name in self.names}
        self.launches = {name: 0 for name in self.names}
        self.modes: set[str] = set()
        self.overflow_cases = 0
        self.pair_matches = 0
        self.edge_levels: list[tuple[int, int, int, int]] = []
        self.kept: dict = {}
        self.keep = False

    def __enter__(self):
        self._saved = {name: getattr(wrapper_module(name), name)
                       for name in self.names}
        for name, fn in self._saved.items():
            setattr(wrapper_module(name), name, self._checked(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(wrapper_module(name), name, fn)

    def _checked(self, name, fn):
        check = getattr(self, f"_check_{name}")

        def run(*a, **kw):
            got = fn(*a, **kw)
            err = check(a, kw, got)
            self.err[name] = max(self.err[name], err)
            self.launches[name] += 1
            self.modes.add(kw.get("conn_mode", "-"))
            if self.keep and name not in self.kept:
                self.kept[name] = (a, kw)
            if err and name not in FLOAT_KERNELS:
                raise AssertionError(f"{name} ({int_args(kw)}) differs "
                                     f"from its plain version by {err}")
            return got
        return run

    def _ranges(self, cand_cap: int):
        for lo in range(0, cand_cap, self.chunk):
            yield lo, min(lo + self.chunk, cand_cap)

    def _check_extend_candidates(self, a, kw, got) -> int:
        from repro_torch.kernels.extend_fused import ref
        err = 0
        for lo, hi in self._ranges(kw["cand_cap"]):
            want = ref.extend_candidates_ref(*a, **kw, slots=(lo, hi))
            err = max(err, max_abs_err([g[lo:hi] for g in got], want))
        return err

    def _check_extend_count(self, a, kw, got) -> int:
        from repro_torch.kernels.extend_fused import ref
        err = 0
        for lo, hi in self._ranges(kw["cand_cap"]):
            want = ref.extend_count_ref(*a, **kw, slots=(lo, hi))
            t0 = lo // ref.BLOCK_C
            err = max(err, max_abs_err([got[t0:t0 + want.shape[0]]], [want]))
        return err

    def _scatter_err(self, a, kw, got, out_cap: int) -> int:
        """Piece by piece: the survivors of slots lo..hi-1 land in the
        output window from their first tile's base to the next piece's
        (the last piece's window runs to ``out_cap``, so it also covers the
        fill past the survivors)."""
        from repro_torch.kernels.extend_fused import ref
        bases = a[7].cpu()
        cand_cap = kw["cand_cap"]
        err = 0
        for lo, hi in self._ranges(cand_cap):
            w0 = min(int(bases[lo // ref.BLOCK_C]), out_cap)
            w1 = (min(int(bases[hi // ref.BLOCK_C]), out_cap)
                  if hi < cand_cap else out_cap)
            if w0 >= out_cap:
                break              # this piece and the rest write nothing
            want = ref.extend_scatter_ref(*a, **{**kw, "out_cap": out_cap},
                                          slots=(lo, hi))
            err = max(err, max_abs_err([g[w0:w1] for g in got],
                                       [w[w0:w1] for w in want]))
        return err

    def _check_extend_scatter(self, a, kw, got) -> int:
        err = self._scatter_err(a, kw, got, kw["out_cap"])
        small = max(kw["out_cap"] // 2, 1)
        if small < int(a[7][-1]):          # survivors reach past small
            self.overflow_cases += 1
        over = self._saved["extend_scatter"](*a, **{**kw, "out_cap": small})
        return max(err, self._scatter_err(a, kw, over, small))

    def _check_extend_edge(self, a, kw, got) -> int:
        from repro_torch.kernels.extend_fused import ref
        err = 0
        for lo, hi in self._ranges(kw["cand_cap"]):
            want = ref.extend_edge_ref(*a, **kw, slots=(lo, hi))
            err = max(err, max_abs_err([g[lo:hi] for g in got], want))
        u, vmask = got[2], a[9]
        masked = (0 if vmask is None else
                  int(((u >= 0) & (vmask[u.clamp(min=0).long()] == 0)).sum()))
        self.edge_levels.append((kw["cand_cap"], int(a[2][-1]),
                                 int(got[4].sum()), masked))
        return err

    def _lookback_err(self, a, kw, got, out_cap: int) -> int:
        """Piece by piece, the survivor offset carried from piece to piece:
        the survivors of slots lo..hi-1 land from the offset before the
        piece to the offset after it (the last piece's window runs to
        ``out_cap``, so it also covers the fill); then the true total.
        ``got`` is (row, u[, state], n_surv)."""
        from repro_torch.kernels.extend_fused import ref
        *bufs, n_surv = got
        cand_cap = kw["cand_cap"]
        base = err = 0
        for lo, hi in self._ranges(cand_cap):
            *want, n = ref.extend_pruned_1p_ref(
                *a, **{**kw, "out_cap": out_cap}, slots=(lo, hi), base=base)
            end = int(n)
            w0 = min(base, out_cap)
            w1 = min(end, out_cap) if hi < cand_cap else out_cap
            err = max(err, max_abs_err([b[w0:w1] for b in bufs],
                                       [w[w0:w1] for w in want]))
            base = end
        return max(err, abs(int(n_surv) - base))

    def _check_extend_pruned_1p(self, a, kw, got) -> int:
        from repro_torch.kernels.extend_fused import ops
        err = self._lookback_err(a, kw, got, kw["out_cap"])
        small = max(kw["out_cap"] // 2, 1)
        over = self._saved["extend_pruned_1p"](*a, **{**kw, "out_cap": small})
        if small < int(over[-1]):
            self.overflow_cases += 1
        err = max(err, self._lookback_err(a, kw, over, small))
        if not err:
            # the two-pass pair on the same inputs: the same buffers (its
            # tile counts dropped)
            pair = ops.extend_pruned(*a, **kw)[:-1]
            if max_abs_err(got, pair):
                raise AssertionError(
                    f"extend_pruned_1p (cand_cap={kw['cand_cap']}) differs "
                    "from the two-pass pair's buffers")
            self.pair_matches += 1
        return err

    def _check_intersect_count(self, a, kw, got) -> int:
        from repro_torch.kernels.intersect import ref
        n_pairs = a[1].shape[0]
        step = max(self.chunk // max(kw["max_deg"], 1), 1)
        err = 0
        for lo in range(0, n_pairs, step):
            hi = min(lo + step, n_pairs)
            want = ref.intersect_count_ref(*a, **kw, pairs=(lo, hi))
            err = max(err, max_abs_err([got[lo:hi]], [want]))
        return err

    def _check_flash_attention(self, a, kw, got) -> float:
        """Against ``attention_ref`` in pieces of query rows whose f32
        scores hold about 32 x ``chunk`` values (4 GiB by default); bf16
        at ``assert_close``'s bf16 defaults (both round one f32 result),
        f32 at the JAX tests' 2e-5."""
        import torch
        from repro_torch.kernels.flash_attention import ref
        q, k, _ = a
        b, hq, lq, _ = q.shape
        step = max(1, self.chunk * 32 // (b * hq * k.shape[2]))
        tol = {} if q.dtype == torch.bfloat16 else dict(atol=2e-5, rtol=0)
        err = 0.0
        for lo in range(0, lq, step):
            hi = min(lo + step, lq)
            want = ref.attention_ref(*a, **kw, q_rows=(lo, hi))
            piece = got[:, :, lo:hi]
            torch.testing.assert_close(
                piece, want, **tol,
                msg=lambda m: f"flash_attention {tuple(q.shape)} over "
                              f"{tuple(k.shape)}, rows {lo}..{hi}: {m}")
            err = max(err, float((piece.float() - want.float()).abs().max()))
        return err

    def _check_sorted_segment_sum(self, a, kw, got) -> float:
        """Against ``sorted_segment_sum_ref``: f32 sums in another order
        (atomic adds) within 1e-4; bf16 at ``assert_close``'s defaults."""
        import torch
        from repro_torch.kernels.segsum import ref
        want = ref.sorted_segment_sum_ref(*a, **kw)
        tol = ({} if a[0].dtype == torch.bfloat16
               else dict(atol=1e-4, rtol=1e-5))
        torch.testing.assert_close(got, want, **tol)
        return float((got.float() - want.float()).abs().max())

    def report(self, label: str) -> None:
        log(f"[check] {label}: launches {self.launches}, modes "
            f"{sorted(self.modes)}, overflow cases {self.overflow_cases}, "
            f"buffers equal to the pair's {self.pair_matches}, max_abs_err "
            f"{self.err}")


def checked_runs(graph, apps, expected: dict, label: str,
                 pack_max_bytes: int = 4 << 20, keep: str | None = None,
                 chunk: int = 1 << 25, backend: str = "cuda",
                 names=tuple(REPLACES)) -> KernelChecks:
    """Cold then warm ``Miner.run`` of each app on ``backend``, on the
    graph's device, every launch of the kernels ``names`` held against its
    plain version, and each count against ``expected``.  ``keep`` names the
    app whose first launch of each kernel keeps its arguments for
    timing."""
    import torch
    from repro_torch.core import Miner

    on_card = graph.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    checks = KernelChecks(chunk, names)
    with checks:
        for name, app in apps:
            checks.keep = name == keep
            miner = Miner(graph, app, backend=backend,
                          pack_max_bytes=pack_max_bytes, device=graph.device)
            for run in ("cold", "warm"):
                count = miner.run().count
                if count != expected[name]:
                    raise AssertionError(f"{label} {name} {run}: {count} != "
                                         f"scipy {expected[name]}")
            del miner
            torch.cuda.empty_cache()
    checks.report(label)
    if on_card:
        log(f"[check] {label}: peak {torch.cuda.max_memory_allocated()} B")
    if min(checks.launches.values()) < 1:
        raise AssertionError(f"{label}: a kernel was never checked")
    return checks


def bytes_moved(name: str, a, kw) -> int:
    """Compulsory bytes of one launch: each input read once, each output
    written once."""
    from repro_torch.kernels.extend_fused import ref
    if name == "extend_edge":            # every tensor argument is an input
        inputs = sum(t.numel() * 4 for t in a if t is not None)
        return inputs + 5 * kw["cand_cap"] * 4
    if name == "intersect_count":        # col, four bounds in, counts out
        return (a[0].shape[0] + 5 * a[1].shape[0]) * 4
    offsets, col, cand_cap = a[1], a[0], kw["cand_cap"]
    parents = 5 * offsets.shape[0] * 4
    if name == "extend_candidates":
        return parents + col.shape[0] * 4 + 4 * cand_cap * 4
    bits = a[6].shape[0] * 4 if kw["conn_mode"] == "bitmap" else 0
    # a branch set reads the parents' state and writes the survivors'; a
    # labeled spec reads the labels
    state, labels = kw.get("state"), kw.get("labels")
    reads = (parents + col.shape[0] * 4 + bits
             + (0 if state is None else state.numel() * 4)
             + (0 if labels is None else labels.numel() * 4))
    outs = 2 + (state is not None)       # row, u[, state] per survivor
    if name == "extend_pruned_1p":       # the buffers and the total out
        return reads + outs * kw["out_cap"] * 4 + 4
    tiles = -(-cand_cap // ref.BLOCK_C) * 4
    if name == "extend_count":
        return reads + tiles
    return reads + 2 * tiles + outs * kw["out_cap"] * 4   # bases in


def time_kernels(kept: dict) -> dict:
    """CUDA-event times of each kernel and its plain version on the
    arguments one main-path launch gave it, the two outputs compared, and
    the memory bound."""
    import torch
    from repro_torch.kernels.extend_fused import ref
    from repro_torch.kernels.intersect import ref as intersect_ref

    plain = {"extend_candidates": ref.extend_candidates_ref,
             "extend_count": ref.extend_count_ref,
             "extend_scatter": ref.extend_scatter_ref,
             "extend_edge": ref.extend_edge_ref,
             "extend_pruned_1p": ref.extend_pruned_1p_ref,
             "intersect_count": intersect_ref.intersect_count_ref}
    rows = {}
    for name in kept:
        a, kw = kept[name]
        wrapper = getattr(wrapper_module(name), name)
        ms, got = cuda_ms(lambda: wrapper(*a, **kw), reps=10)
        plain_ms, want = cuda_ms(lambda: plain[name](*a, **kw), reps=2)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        del got, want
        nbytes = bytes_moved(name, a, kw)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "max_abs_err": err}
        log(f"[timing] {name} ({int_args(kw)}): {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms from {nbytes} B), "
            f"max_abs_err {err}")
        if err:
            raise AssertionError(f"{name} differs from its plain version")
        torch.cuda.empty_cache()
    return rows


def scipy_counts(graph) -> tuple[int, int]:
    """Triangles and 4-cliques of ``graph``, counted on the host with scipy
    on a degree-ordered DAG built here: triangles as sum((A @ A) * A), and
    4-cliques as the triangles inside each vertex's out-neighbourhood."""
    import numpy as np
    import scipy.sparse as sp

    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    ci = graph.col_idx.cpu().numpy().astype(np.int64)
    n = rp.shape[0] - 1
    deg = np.diff(rp)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    rank = deg * n + np.arange(n, dtype=np.int64)
    keep = rank[src] < rank[ci]
    a = sp.csr_matrix((np.ones(int(keep.sum()), dtype=np.int64),
                       (src[keep], ci[keep])), shape=(n, n))
    a.sort_indices()
    triangles = int((a @ a).multiply(a).sum())
    cliques4 = 0
    for v in range(n):
        nb = a.indices[a.indptr[v]:a.indptr[v + 1]]
        if nb.shape[0] < 3:
            continue
        s = a[nb][:, nb]
        cliques4 += int((s @ s).multiply(s).sum())
    return triangles, cliques4


# The kernels each vertex backend's main path launches; no other kernel may
PATH_KERNELS = {"cuda": tuple(REPLACES),
                "cuda-1p": ("extend_candidates", "extend_pruned_1p")}


def main_path(graph, expected: dict, backend: str = "cuda") -> dict:
    """Cold then warm Miner.run for TC and 4-CF on ``backend``, the launches
    counted: every kernel of the backend's path must launch, no other
    kernel and no plain version may run; then the warm replay once more up
    to its final read, with every device sync an error."""
    import torch
    from repro_torch.core import Miner, make_cf_app, make_tc_app
    from repro_torch.kernels.extend_fused import ops

    path = PATH_KERNELS[backend]
    launches = dict.fromkeys(path, 0)
    for name, app in (("tc", make_tc_app()), ("4-cf", make_cf_app(4))):
        label = name if backend == "cuda" else f"{backend} {name}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        miner = Miner(graph, app, backend=backend)
        times, counts = {}, {}
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts[run] = miner.run().count
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
        peak = torch.cuda.max_memory_allocated()
        ex = next(iter(miner._executors.values()))
        log(f"[main] {label}: cold {counts['cold']} in {times['cold']:.3f} s, "
            f"warm {counts['warm']} in {times['warm']:.3f} s, plan "
            f"{list(ex.plan.caps)}, replans {ex.n_replans}, peak "
            f"{peak} B, launches {got}, plain calls {plain}")
        for run in ("cold", "warm"):
            if counts[run] != expected[name]:
                raise AssertionError(f"{label} {run}: {counts[run]} != scipy "
                                     f"{expected[name]}")
        if plain:
            raise AssertionError(f"{label}: plain versions ran {plain} times "
                                 "on the main path")
        if min(got[k] for k in path) < 1 or any(
                n for k, n in got.items() if k not in path):
            raise AssertionError(f"{label}: launches {got}, path {path}")
        for k in path:
            launches[k] += got[k]
        replay_without_sync(miner, expected[name], label)
        del miner
    return launches


def replay_without_sync(miner, want: int, label: str) -> None:
    """The warm vertex replay up to its final read, with every device sync
    an error; its count must be ``want``."""
    import torch
    import torch.nn.functional as F

    (ex,) = miner._executors.values()
    src, dst = miner.init_edges()
    m = int(src.shape[0])
    pad = (0, ex.cap0 - m)
    src, dst = F.pad(src, pad), F.pad(dst, pad)
    n = torch.tensor(m, dtype=torch.int32, device="cuda")
    count, _, ovf = sync_free(lambda: ex._run_once(src, dst, n))
    if (int(count), bool(ovf)) != (want, False):
        raise AssertionError(f"{label}: the sync-checked replay counted "
                             f"{int(count)} (overflow {bool(ovf)})")
    log(f"[main] {label}: the warm replay made no device sync before its "
        "final read")


# ---------------------------------------------------------------------------
# FSM: the edge-induced path


def scipy_fsm(graph, min_support: int):
    """MNI supports of 3-FSM on ``graph``, counted on the host with scipy.

    A 3-FSM pattern is a labeled wedge: center label c, end labels {a, b}.
    Its centers C are the vertices of label c with a neighbour of label a
    and one of label b (two of label a when a = b); an end's domain is the
    vertices of its label adjacent to C; the support is the least of the
    three domains.  Returns (sorted supports of the frequent wedges, the
    single-edge supports, the label frequencies).
    """
    import numpy as np
    import scipy.sparse as sp

    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    ci = graph.col_idx.cpu().numpy().astype(np.int64)
    lab = graph.labels.cpu().numpy()
    n = rp.shape[0] - 1
    adj = sp.csr_matrix((np.ones(ci.shape[0], dtype=np.int64), ci, rp),
                        shape=(n, n))
    n_labels = int(lab.max()) + 1
    is_lab = [lab == a for a in range(n_labels)]
    nbrs = [adj @ is_lab[a].astype(np.int64) for a in range(n_labels)]
    edges, wedges = {}, []
    for a in range(n_labels):
        for b in range(a, n_labels):
            edges[(a, b)] = min(int((is_lab[a] & (nbrs[b] > 0)).sum()),
                                int((is_lab[b] & (nbrs[a] > 0)).sum()))
            for c in range(n_labels):
                if a == b:
                    centers = is_lab[c] & (nbrs[a] >= 2)
                else:
                    centers = is_lab[c] & (nbrs[a] > 0) & (nbrs[b] > 0)
                near = (adj @ centers.astype(np.int64)) > 0
                wedges.append(min(int(centers.sum()),
                                  int((is_lab[a] & near).sum()),
                                  int((is_lab[b] & near).sum())))
    freq = [int(x.sum()) for x in is_lab]
    return sorted(s for s in wedges if s >= min_support), edges, freq


def frequent_supports(result, min_support: int) -> list[int]:
    import numpy as np
    keep = (result.supports >= min_support) & (result.codes != np.int32(
        2**31 - 1))
    return sorted(int(x) for x in result.supports[keep])


def fsm_checked(graph, min_support: int, label: str, keep: bool = False,
                chunk: int = 1 << 25):
    """Cold then warm 3-FSM on the cuda backend with every edge-kernel
    launch held against its plain version, and the frequent supports
    against the scipy count.  Returns the checks and the labels the app's
    vertex mask dropped."""
    import torch
    from repro_torch.core import Miner, make_fsm_app

    want, _, _ = scipy_fsm(graph, min_support)
    checks = KernelChecks(chunk, names=tuple(EDGE_REPLACES))
    checks.keep = keep
    with checks:
        miner = Miner(graph, make_fsm_app(3, min_support, max_patterns=64),
                      backend="cuda", device=graph.device)
        for run in ("cold", "warm"):
            got = frequent_supports(miner.run(), min_support)
            if got != want:
                raise AssertionError(f"{label} {run}: supports {got} != "
                                     f"scipy {want}")
    mask = miner.ops.app.to_add_vertex_mask(miner.ctx)
    dropped = sorted(set(graph.labels[~mask].tolist()))
    checks.report(label)
    log(f"[check] {label}: {len(want)} frequent patterns, labels dropped by "
        f"the mask {dropped}, level-2 launches (cand_cap, candidates, "
        f"survivors, masked) {checks.edge_levels}")
    if checks.launches["extend_edge"] != 3:
        raise AssertionError(f"{label}: {checks.launches} launches, not 3")
    del miner
    if graph.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks, dropped


def fsm_main_path(graph, min_support: int, want: list[int]) -> int:
    """Cold then warm 3-FSM through ``Miner.run`` on the cuda backend, the
    launches counted; then the warm replay re-run up to its final read with
    device syncs made errors.  Returns the run's ``extend_edge`` launches."""
    import numpy as np
    import torch
    from repro_torch.core import Miner, make_fsm_app
    from repro_torch.kernels.extend_fused import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    miner = Miner(graph, make_fsm_app(3, min_support, max_patterns=64),
                  backend="cuda")
    times, results, launches = {}, {}, {}
    for run in ("cold", "warm"):
        before = ops.LAUNCHES["extend_edge"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[run] = miner.run()
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        launches[run] = ops.LAUNCHES["extend_edge"] - before
        if run == "cold":          # the cold run returns its levels
            level1 = int(results[run].levels[0].n)
            results[run].levels = None
    plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
    peak = torch.cuda.max_memory_allocated()
    (ex,) = miner._executors.values()
    log(f"[main] 3-fsm: cold {results['cold'].count} patterns in "
        f"{times['cold']:.3f} s, warm {results['warm'].count} in "
        f"{times['warm']:.3f} s, plan caps {list(ex.plan.caps)} filter caps "
        f"{list(ex.plan.filter_caps)}, replans {ex.n_replans}, peak {peak} B, "
        f"launches {launches}, plain calls {plain}, level 1 {level1} edges")
    for run, r in results.items():
        got = frequent_supports(r, min_support)
        if got != want or r.count != FSM_FREQUENT:
            raise AssertionError(f"3-fsm {run}: {r.count} patterns, supports "
                                 f"{got} != scipy {want}")
    if level1 != miner.ctx.n_uedges:
        raise AssertionError(f"level 1 kept {level1} of "
                             f"{miner.ctx.n_uedges} edges")
    if launches != {"cold": 2, "warm": 1} or plain:
        raise AssertionError(f"3-fsm: launches {launches}, plain {plain}")
    count = sum(launches.values())
    # the warm replay up to its final read, with every device sync an error
    n = torch.tensor(miner.ctx.n_uedges, dtype=torch.int32, device="cuda")
    args = miner.edge_worklist()
    _, supports, _ = sync_free(lambda: ex._run_once(*args, n))
    if not np.array_equal(supports.cpu().numpy(), results["warm"].supports):
        raise AssertionError("3-fsm: the sync-checked replay differs")
    log("[main] 3-fsm: the warm replay made no device sync before its "
        "final read")
    del miner
    return count


def profile_call(fn, label: str) -> None:
    """Device time by kernel, the device's idle share and the count of
    device operations over one call of ``fn`` (``torch.profiler``; says so
    when it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device time")
        return
    log(f"[profile] {label}: wall {wall_us:.0f} us, device busy "
        f"{busy_us:.0f} us, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(r[2] for r in rows)} device operations")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"[profile]   {us:10.0f} us {100 * us / busy_us:5.1f}% "
            f"x{count:<3d} {key[:90]}")


def profile_warm(graph, app, label: str, backend: str = "cuda") -> None:
    """``profile_call`` over one warm run."""
    from repro_torch.core import Miner

    miner = Miner(graph, app, backend=backend)
    miner.run()
    miner.run()
    profile_call(miner.run, f"{label} warm")


# ---------------------------------------------------------------------------
# The hand-optimised triangle count


def tc_fused_checked(graph, want: int, label: str, keep: bool = False,
                     chunk: int = 1 << 25) -> KernelChecks:
    """``triangle_count_fused(graph)`` with its ``intersect_count`` launch
    held against the plain version, pair by pair in pieces, and the count
    against ``want``."""
    from repro_torch.core import triangle_count_fused

    checks = KernelChecks(chunk, names=tuple(INTERSECT_REPLACES))
    checks.keep = keep
    with checks:
        count = triangle_count_fused(graph)
    checks.report(label)
    if count != want or checks.launches["intersect_count"] != 1:
        raise AssertionError(f"{label}: fused TC {count} != scipy {want}, "
                             f"launches {checks.launches}")
    return checks


def tc_fused_main(graph, want: int) -> int:
    """Cold then warm ``triangle_count_fused`` on the card, launches
    counted: one launch and no plain call each.  Returns the launches."""
    import torch
    from repro_torch.core import triangle_count_fused
    from repro_torch.kernels.intersect import ops, ref

    ops.reset_counts()
    times, counts = {}, {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts[run] = triangle_count_fused(graph)
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
    launches = ops.LAUNCHES["intersect_count"]
    plain = ref.intersect_count_ref.calls
    log(f"[main] tc-fused: cold {counts['cold']} in {times['cold']:.3f} s, "
        f"warm {counts['warm']} in {times['warm']:.3f} s, launches "
        f"{launches}, plain calls {plain}")
    if set(counts.values()) != {want} or (launches, plain) != (2, 0):
        raise AssertionError(f"tc-fused: counts {counts} (scipy {want}), "
                             f"launches {launches}, plain calls {plain}")
    return launches


# ---------------------------------------------------------------------------
# Motif counting and compiled patterns: the state, canonical and labeled
# variants of the pruned kernels


# the timing rows of the branch-set + state variant (4-MC's level 3)
MC_REPLACES = {"extend_count:branches": f"{TPU_KERNEL}:505",
               "extend_scatter:branches": f"{TPU_KERNEL}:519",
               "extend_pruned_1p:branches": f"{TPU_KERNEL}:322"}
# the directed set: no first-pair symmetry for the 4-star, so the trie
# takes both edge orientations and checks v0 < v1 on the other branches
DIRECTED_SET = ("diamond", "4-cycle", "4-star")
SYMMETRIC_SET = ("diamond", "4-cycle", "4-clique")
# the [mc] main path's figures from the JAX reference backend on the host
# CPU (Miner(...).run(collect_stats=True)), quoted beside the census
MC_CPU_FIGURES = {
    "3-mc rmat10": [793479, 75783],
    "4-mc rmat10": [18023233, 43778500, 518702, 15655453, 2687323, 409588],
    "4-mc rmat8": [579583, 1390299, 23360, 762958, 188737, 38027]}


def _adjacency(graph):
    """The graph's symmetric 0/1 adjacency as a scipy CSR matrix (int64)."""
    import numpy as np
    import scipy.sparse as sp

    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    ci = graph.col_idx.cpu().numpy().astype(np.int64)
    n = rp.shape[0] - 1
    return sp.csr_matrix((np.ones(ci.shape[0], dtype=np.int64), ci, rp),
                         shape=(n, n))


def motif_census(graph, k: int) -> list[int]:
    """The induced k-motif census of ``graph`` (k = 3 or 4), counted on the
    host with scipy, in the motif-enum order of ``repro_torch.core.pattern``.

    k = 3: [open wedges, triangles], with wedges = sum C(d, 2) - 3T.  k = 4:
    the non-induced counts of the six connected 4-vertex graphs, from A, A^2
    and the triangles per edge and per vertex, turned into induced counts
    by inclusion-exclusion (each graph holds a fixed number of copies of
    each sparser one).
    """
    import numpy as np
    import scipy.sparse as sp

    a = _adjacency(graph)
    deg = np.asarray(a.sum(axis=1)).ravel()
    a2 = (a @ a).tocsr()
    tri_edge = a2.multiply(a).tocsr()            # triangles on each edge
    tri = int(tri_edge.sum()) // 6
    if k == 3:
        return [int((deg * (deg - 1) // 2).sum()) - 3 * tri, tri]
    tri_v = np.asarray(tri_edge.sum(axis=1)).ravel() // 2
    star = int((deg * (deg - 1) * (deg - 2) // 6).sum())
    src = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    dst = a.indices
    path = int(((deg[src] - 1) * (deg[dst] - 1)).sum()) // 2 - 3 * tri
    tailed = int((tri_v * (deg - 2)).sum())
    off = sp.triu(a2, k=1).tocsr()                # pairs u < v
    cycle = int((off.data * (off.data - 1) // 2).sum()) // 2
    te = sp.triu(tri_edge, k=1).tocsr()
    diamond = int((te.data * (te.data - 1) // 2).sum())
    clique = 0
    for v in range(a.shape[0]):
        nb = a.indices[a.indptr[v]:a.indptr[v + 1]]
        nb = nb[nb > v]
        if nb.shape[0] >= 3:
            s = a[nb][:, nb]
            clique += int((s @ s).multiply(s).sum()) // 6
    i_clique = clique
    i_diamond = diamond - 6 * i_clique
    i_cycle = cycle - i_diamond - 3 * i_clique
    i_tailed = tailed - 4 * i_diamond - 12 * i_clique
    i_path = path - 2 * i_tailed - 4 * i_cycle - 6 * i_diamond \
        - 12 * i_clique
    i_star = star - i_tailed - 2 * i_diamond - 4 * i_clique
    return [i_path, i_star, i_cycle, i_tailed, i_diamond, i_clique]


def labeled_chain_count(graph, labels=(0, 1, 2)) -> int:
    """Induced occurrences of the labeled path a - b - c (labels
    ``labels``, all distinct), counted with scipy: label-b centres times
    their label-a and label-c neighbours, less the closed ones."""
    import numpy as np
    import scipy.sparse as sp

    a = _adjacency(graph)
    lab = graph.labels.cpu().numpy()
    d = [sp.diags((lab == x).astype(np.int64), dtype=np.int64)
         for x in labels]
    n0 = a @ (lab == labels[0]).astype(np.int64)
    n2 = a @ (lab == labels[2]).astype(np.int64)
    paths = int(((lab == labels[1]) * n0 * n2).sum())
    closed = int((d[0] @ a @ d[2]).multiply(a @ d[1] @ a).sum())
    return paths - closed


MC_PATH_KERNELS = {"cuda": ("extend_candidates", "extend_count",
                            "extend_scatter"),
                   "cuda-1p": ("extend_candidates", "extend_pruned_1p")}


def mc_checked(graph, runs, label: str, pack_max_bytes: int = 4 << 20,
               backend: str = "cuda", chunk: int = 1 << 25,
               keep: str | None = None) -> KernelChecks:
    """Cold then warm ``Miner.run`` of each ``(name, app, count, p_map)``
    of ``runs`` on ``backend``, every launch of the backend's kernels held
    against its plain version (state buffers included), and each count and
    p_map against the expected ones."""
    import torch
    from repro_torch.core import Miner

    checks = KernelChecks(chunk, MC_PATH_KERNELS[backend])
    with checks:
        for name, app, count, p_map in runs:
            checks.keep = name == keep
            miner = Miner(graph, app, backend=backend,
                          pack_max_bytes=pack_max_bytes, device=graph.device)
            for run in ("cold", "warm"):
                r = miner.run()
                got = None if r.p_map is None else [int(x) for x in r.p_map]
                if r.count != count or got != p_map:
                    raise AssertionError(f"{label} {name} {run}: {r.count} "
                                         f"{got} != {count} {p_map}")
            del miner
            torch.cuda.empty_cache()
    checks.report(label)
    if min(checks.launches.values()) < 1:
        raise AssertionError(f"{label}: a kernel was never checked")
    return checks


def mc_main(graph, name: str, app, count: int, p_map, backend: str,
            keep_levels: bool = False):
    """Cold then warm ``Miner.run`` of ``app`` on ``backend``, the launches
    counted: every kernel of the backend's path launches, no other kernel
    and no plain version runs.  Returns the launches per kernel, per
    variant, and the cold run's levels when ``keep_levels``."""
    import torch
    from repro_torch.core import Miner
    from repro_torch.kernels.extend_fused import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    miner = Miner(graph, app, backend=backend)
    times, results = {}, {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[run] = miner.run()
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
    launches, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
    plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
    peak = torch.cuda.max_memory_allocated()
    (ex,) = miner._executors.values()
    got = {run: (r.count, None if r.p_map is None
                 else [int(x) for x in r.p_map])
           for run, r in results.items()}
    log(f"[main] {name} {backend}: cold {got['cold']} in {times['cold']:.3f} "
        f"s, warm {got['warm']} in {times['warm']:.3f} s, plan "
        f"{list(ex.plan.caps)}, replans {ex.n_replans}, peak {peak} B, "
        f"launches {launches}, variants {variants}, plain calls {plain}")
    for run in got:
        if got[run] != (count, p_map):
            raise AssertionError(f"{name} {backend} {run}: {got[run]} != "
                                 f"census {(count, p_map)}")
    path = MC_PATH_KERNELS[backend]
    if plain or min(launches[k] for k in path) < 1 or any(
            n for k, n in launches.items() if k not in path):
        raise AssertionError(f"{name} {backend}: launches {launches}, plain "
                             f"calls {plain}")
    levels = results["cold"].levels if keep_levels else None
    del miner, results
    return launches, variants, levels


def levels_equal(a, b) -> int:
    """Levels of two runs compared over each level's valid prefix: vid,
    idx and state bit for bit.  Returns the levels compared."""
    import torch
    for i, (x, y) in enumerate(zip(a, b)):
        n = int(x.n)
        if n != int(y.n):
            raise AssertionError(f"level {i}: {n} != {int(y.n)} embeddings")
        for col in ("vid", "idx", "state"):
            u, v = getattr(x, col), getattr(y, col)
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u[:n], v[:n])):
                raise AssertionError(f"level {i}: {col} differs")
    return len(a)


class ArgsKeeper:
    """While active, keeps the arguments of the first launch of each named
    wrapper whose parent width is ``k`` (the launch still runs as is)."""

    def __init__(self, names, k: int):
        self.names, self.k, self.kept = tuple(names), k, {}

    def __enter__(self):
        from repro_torch.kernels.extend_fused import ops
        self._saved = {name: getattr(ops, name) for name in self.names}
        for name, fn in self._saved.items():
            def run(*a, _name=name, _fn=fn, **kw):
                if kw.get("k") == self.k and _name not in self.kept:
                    self.kept[_name] = (a, kw)
                return _fn(*a, **kw)
            setattr(ops, name, run)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.extend_fused import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)


def mc_phase(timing: dict, launches: dict) -> dict:
    """The [mc] phase: checked runs, the counted main path, the timing of
    the branch-set + state variant.  Returns the checks' largest errors by
    kernel."""
    import torch
    from repro_torch.core import (Miner, Pattern, make_mc_app, pattern_app,
                                  pattern_set_app)
    from repro_torch.graph.generators import rmat

    errs: dict = {}

    def note(checks):
        for k, v in checks.err.items():
            errs[k] = max(errs.get(k, 0), v)

    def set_app(names):
        return pattern_set_app([Pattern.named(n) for n in names])

    # every launch checked: 3-MC and 4-MC (trie, branch set + state) on
    # RMAT-8 with and without the pack, the directed and the symmetric
    # sets, the canonical test (4-MC's memo mode)
    g8 = rmat(8, 16, seed=0)
    c3, c4 = motif_census(g8, 3), motif_census(g8, 4)
    log(f"[census] rmat(8, 16, seed=0): 3-motifs {c3}, 4-motifs {c4} (JAX "
        f"reference on the host CPU: {MC_CPU_FIGURES['4-mc rmat8']})")
    idx = {"diamond": 4, "4-cycle": 2, "4-star": 1, "4-clique": 5}
    runs8 = [("3-mc", make_mc_app(3), sum(c3), c3),
             ("4-mc", make_mc_app(4), sum(c4), c4),
             ("4-mc memo", make_mc_app(4, "memo"), sum(c4), c4)]
    for names in (DIRECTED_SET, SYMMETRIC_SET):
        want = [c4[idx[n]] for n in names]
        runs8.append(("+".join(names), set_app(names), sum(want), want))
    for backend in ("cuda", "cuda-1p"):
        for mode, pmb in (("bitmap", 4 << 20), ("search", 0)):
            checks = mc_checked(g8, runs8, f"mc rmat8 {mode} {backend}",
                                pack_max_bytes=pmb, backend=backend)
            if mode not in checks.modes:
                raise AssertionError(f"mc rmat8: modes {checks.modes}")
            if backend == "cuda-1p" and checks.pair_matches < 1:
                raise AssertionError("mc rmat8: no pair match")
            note(checks)

    # a compiled pattern (conjunction with forbidden slots) and the
    # labeled chain (conjunction with label equations), checked
    g10 = rmat(10, 16, seed=0)
    c3_10, c4_10 = motif_census(g10, 3), motif_census(g10, 4)
    log(f"[census] rmat(10, 16, seed=0): 3-motifs {c3_10} (JAX reference on "
        f"the host CPU: {MC_CPU_FIGURES['3-mc rmat10']}), 4-motifs {c4_10} "
        f"({MC_CPU_FIGURES['4-mc rmat10']})")
    diamond = pattern_app(Pattern.named("diamond"))
    g12l = rmat(12, 8, seed=0, labels=3)
    chain = pattern_app(Pattern.from_edges([(0, 1), (1, 2)],
                                           labels=[0, 1, 2]))
    n_chain = labeled_chain_count(g12l)
    log(f"[census] rmat(12, 8, seed=0, labels=3): labeled chain 0-1-2 "
        f"{n_chain}")
    for backend in ("cuda", "cuda-1p"):
        note(mc_checked(g10, [("psm-diamond", diamond, c4_10[4], None)],
                        f"mc rmat10 diamond {backend}", backend=backend))
        note(mc_checked(g12l, [("psm-lchain", chain, n_chain, None)],
                        f"mc rmat12 lchain {backend}", backend=backend))

    # the counted main path, cold and warm on both backends, the levels of
    # the two backends held equal; then the timing of 4-MC's level 3
    g15 = rmat(15, 16, seed=0)
    deg = g15.degrees().cpu().numpy().astype("int64")
    t0 = time.perf_counter()
    c3_15 = motif_census(g15, 3)
    log(f"[census] rmat(15, 16, seed=0): {g15.n_vertices} vertices, "
        f"{g15.n_edges // 2} undirected edges, level 2: "
        f"{2 * int((deg * deg).sum())} candidates; 3-motifs {c3_15} "
        f"({time.perf_counter() - t0:.1f} s)")
    mains = [("3-mc rmat15", g15, make_mc_app(3), c3_15),
             ("4-mc rmat10", g10, make_mc_app(4), c4_10),
             ("psm-diamond rmat10", g10, diamond, c4_10[4])]
    branch_launches = dict.fromkeys(MC_REPLACES, 0)
    for name, graph, app, want in mains:
        count, p_map = (want, None) if isinstance(want, int) else (
            sum(want), want)
        t0 = time.perf_counter()
        for backend in ("cuda", "cuda-1p"):
            note(mc_checked(graph, [(name, app, count, p_map)],
                            f"mc {name} {backend}", backend=backend))
        log(f"[check] {name}: {time.perf_counter() - t0:.1f} s")
        kept = {}
        for backend in ("cuda", "cuda-1p"):
            got, variants, levels = mc_main(graph, name, app, count, p_map,
                                            backend, keep_levels=True)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            if app.needs_reduce:           # the trie: every launch is a
                for k in MC_REPLACES:      # branch set with its state
                    branch_launches[k] += got[k.split(":")[0]]
            kept[backend] = levels
        n_levels = levels_equal(kept["cuda"], kept["cuda-1p"])
        log(f"[main] {name}: cuda and cuda-1p levels equal (vid, idx, state) "
            f"on {n_levels} levels")
        del kept
        torch.cuda.empty_cache()
    del g15
    torch.cuda.empty_cache()

    keeper = ArgsKeeper(("extend_count", "extend_scatter"), k=3)
    with keeper:
        Miner(g10, make_mc_app(4), backend="cuda").run()
    with ArgsKeeper(("extend_pruned_1p",), k=3) as keeper_1p:
        Miner(g10, make_mc_app(4), backend="cuda-1p").run()
    keeper.kept.update(keeper_1p.kept)
    rows = time_kernels(keeper.kept)
    for name in MC_REPLACES:
        timing[name] = rows[name.split(":")[0]]
        launches[name] = branch_launches[name]
        errs[name] = errs.get(name.split(":")[0], 0)
    del keeper, keeper_1p, rows
    torch.cuda.empty_cache()
    profile_warm(g10, make_mc_app(4), "rmat10 4-mc")
    return errs


# ---------------------------------------------------------------------------
# LM serving: Qwen3-0.6B through serve_lm on the flash-attention kernel


def attention_pairs(lq: int, lk: int, causal: bool = True) -> int:
    """(query, key) pairs a causal attention computes, queries at the end of
    the keys."""
    if not causal:
        return lq * lk
    off = lk - lq
    return sum(min(lk, i + off + 1) for i in range(lq))


def lm_checked(arch, sets=LM_SETS, smoke: bool = False, device=None,
               chunk: int = 1 << 25) -> "KernelChecks":
    """The request ``sets`` through ``serve_lm`` (at the arch's full width
    unless ``smoke``) with every ``flash_attention`` launch held against
    its plain version; keeps each set's first launch (its layer 0) in
    ``layer0`` by set, for timing."""
    import torch
    from repro_torch.launch.serve import serve_lm

    checks = KernelChecks(chunk, names=tuple(FLASH_REPLACES))
    checks.layer0 = {}
    with checks:
        for label, (batch, prompt, gen) in sets.items():
            checks.keep = True
            t0 = time.perf_counter()
            serve_lm(arch, smoke, batch, prompt, gen, seed=0, device=device)
            checks.layer0[label] = checks.kept.pop("flash_attention")
            log(f"[check] lm set {label}: served with every launch checked "
                f"in {time.perf_counter() - t0:.1f} s")
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    checks.report("lm")
    cfg = arch.smoke if smoke else arch.config
    want = cfg.n_layers * len(sets)
    if checks.launches["flash_attention"] != want:
        raise AssertionError(f"lm: {checks.launches} checked launches, not "
                             f"{want}")
    return checks


# the kernel variant a flash_attention launch of each dtype must run
FLASH_VARIANTS = {"bfloat16": "tensor_core", "float32": "fma"}


def time_flash(a, kw, plain: bool = True) -> dict:
    """CUDA-event times of the kernel, its plain version (unless ``plain``
    is False) and ``scaled_dot_product_attention`` on one launch's
    arguments, the kernel's output held against the plain version's, the
    variant the timed launches ran, and the bound: the larger of the flops
    at the bf16 tensor-core rate and the bytes at the memory rate.  The
    flops are 4 d per (query, key) pair: the tensor-core variant's extra
    product for the split P (P_lo V) is not counted as work."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = a
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    before = dict(ops.VARIANT_LAUNCHES)
    ms, got = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), reps=10)
    ran = [name for name, n in ops.VARIANT_LAUNCHES.items()
           if n != before[name]]
    want_variant = FLASH_VARIANTS[str(q.dtype).removeprefix("torch.")]
    if ran != [want_variant]:
        raise AssertionError(f"flash_attention {q.dtype}: ran {ran}, not "
                             f"{want_variant}")
    lib_ms, lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=kw.get("causal", True), enable_gqa=True), reps=10)
    plain_ms = err = None
    plain_msg = "plain not timed"
    if plain:
        plain_ms, want = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw),
                                 reps=2)
        err = float((got.float() - want.float()).abs().max())
        lib_err = float((lib.float() - want.float()).abs().max())
        torch.testing.assert_close(got, want)
        plain_msg = (f"plain {plain_ms:.3f} ms; scaled_dot_product_attention "
                     f"max_abs_err {lib_err:.3g} against the plain version")
        del want
    del got, lib
    flops = 4 * b * hq * d * attention_pairs(lq, lk, kw.get("causal", True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_s = {"operations": flops / BF16_FLOPS_PER_S,
               "bytes": nbytes / HBM_BYTES_PER_S}
    bound_by = max(bound_s, key=bound_s.get)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_s[bound_by] * 1e3, "bound_by": bound_by,
           "max_abs_err": err}
    log(f"[timing] flash_attention (q {tuple(q.shape)}, k {tuple(k.shape)}, "
        f"{q.dtype}, variant {want_variant}): {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.3f} of the "
        f"bound; scaled_dot_product_attention {lib_ms:.3f} ms, "
        f"{flops / lib_ms / 1e9:.1f} TFLOP/s; {plain_msg}), bound "
        f"{row['bound_ms']:.4f} ms by {bound_by}: {flops} flops, {nbytes} "
        f"B), max_abs_err {err if err is None else f'{err:.3g}'}")
    torch.cuda.empty_cache()
    return row


def lm_main(arch, label: str) -> int:
    """Request set ``label`` through ``serve_lm`` with the launches counted:
    one ``flash_attention`` launch per layer of the prefill and no plain
    call.  Returns the launches."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.serve import serve_lm

    batch, prompt, gen = LM_SETS[label]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    stats: dict = {}
    tokens = serve_lm(arch, False, batch, prompt, gen, seed=0, stats=stats)
    launches = ops.LAUNCHES["flash_attention"]
    variants = dict(ops.VARIANT_LAUNCHES)
    plain = ref.attention_ref.calls
    peak = torch.cuda.max_memory_allocated()
    rate = stats["decode_tokens"] / stats["decode_s"]
    log(f"[main] lm set {label} (batch {batch}, prompt {prompt}, {gen} new "
        f"tokens): prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_tokens']} tokens in {stats['decode_s']:.3f} s "
        f"({rate:.1f} tokens/s), peak {peak} B, launches {launches} "
        f"{variants}, plain calls {plain}, first tokens "
        f"{tokens[0, :8].tolist()}")
    vocab = arch.config.vocab
    if tuple(tokens.shape) != (batch, gen) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        raise AssertionError(f"lm set {label}: tokens {tuple(tokens.shape)} "
                             f"outside [0, {vocab})")
    n_layers = arch.config.n_layers
    if launches != n_layers or plain or variants != {"tensor_core": n_layers,
                                                     "fma": 0}:
        raise AssertionError(f"lm set {label}: {launches} launches "
                             f"{variants}, {plain} plain calls")
    return launches


def profile_lm(arch, label: str = "A") -> None:
    """``profile_call`` over request set ``label``'s prefill and over one of
    its decode steps, after one of each to warm up."""
    import torch
    from repro_torch.models import transformer as T

    batch, prompt_len, gen = LM_SETS[label]
    cfg = arch.config
    g = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device="cuda", dtype=torch.int32)
    total = prompt_len + gen
    logits, cache = T.prefill(cfg, params, prompt, cache_len=total)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    T.decode_step(cfg, params, cache, tok, prompt_len)
    profile_call(lambda: T.prefill(cfg, params, prompt, cache_len=total),
                 f"lm set {label} prefill")
    profile_call(lambda: T.decode_step(cfg, params, cache, tok,
                                       prompt_len + 1),
                 f"lm set {label} decode step")
    del params, cache
    torch.cuda.empty_cache()


def lm_f32_end_to_end(arch, prompt_len: int = 512, gen: int = 8) -> None:
    """The full-width model in f32 (TF32 off): prefill on the kernel against
    prefill on the plain attention, last-token logits within 1e-3, and the
    same greedy tokens from ``serve_lm``."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(arch.config, dtype="float32")
    arch32 = dataclasses.replace(arch, config=cfg)
    g = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    prompt = torch.randint(0, cfg.vocab, (1, prompt_len), generator=g,
                           device="cuda", dtype=torch.int32)
    kernel = ops.flash_attention
    runs = {}
    ops.reset_counts()
    for name, attention in (("kernel", kernel), ("plain", ref.attention_ref)):
        ops.flash_attention = attention
        try:
            logits, _ = T.prefill(cfg, params, prompt)
            tokens = serve_lm(arch32, False, 1, prompt_len, gen, seed=0,
                              prompt=prompt)
        finally:
            ops.flash_attention = kernel
        runs[name] = (logits, tokens)
    err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    same = torch.equal(runs["kernel"][1], runs["plain"][1])
    log(f"[main] lm f32 (TF32 off), prompt {prompt_len}: last-token logits "
        f"differ by {err:.3g} (logits range "
        f"{float(runs['plain'][0].abs().max()):.3g}), {gen} greedy tokens "
        f"equal: {same} {runs['kernel'][1][0].tolist()}, kernel launches "
        f"{ops.VARIANT_LAUNCHES}")
    if not err <= 1e-3 or not same:
        raise AssertionError("lm f32: the kernel's prefill differs from the "
                             "plain attention's")
    # the kernel's run: one launch a layer in T.prefill and in serve_lm
    if ops.VARIANT_LAUNCHES != {"tensor_core": 0, "fma": 2 * cfg.n_layers}:
        raise AssertionError(f"lm f32: kernel launches "
                             f"{ops.VARIANT_LAUNCHES}, not the FMA variant "
                             f"once a layer a prefill")
    del params, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The segment sum at ogb_products' scale


def segsum_phase() -> tuple[dict, int, float]:
    """``sorted_segment_sum`` at ogb_products' scale: sorted, unsorted and
    bf16 launches checked, the kernel timed, then one counted launch.
    Returns the timing row, the counted launches and the checks' largest
    error."""
    import torch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.kernels.segsum import ops, ref

    shape = GNN_SHAPES["ogb_products"]
    n, s, d = shape["n_edges"], shape["n_nodes"], shape["d_feat"]
    g = torch.Generator("cuda").manual_seed(0)
    data = torch.randn(n, d, generator=g, device="cuda")
    seg = torch.sort(torch.randint(0, s, (n,), generator=g, device="cuda",
                                   dtype=torch.int32)).values
    log(f"[segsum] ogb_products: data {tuple(data.shape)} f32 "
        f"({data.numel() * 4} B), {s} segments, sorted ids")
    checks = KernelChecks(names=tuple(SEGSUM_REPLACES))
    with checks:
        ops.sorted_segment_sum(data, seg, s)
        unsorted = seg[torch.randperm(n, generator=g, device="cuda")]
        ops.sorted_segment_sum(data, unsorted, s)
        del unsorted
        part = 1 << 22
        ops.sorted_segment_sum(data[:part].bfloat16(), seg[:part], s)
    checks.report("segsum (sorted, unsorted, bf16 on 2^22 rows)")
    torch.cuda.empty_cache()

    ms, got = cuda_ms(lambda: ops.sorted_segment_sum(data, seg, s), reps=5)
    plain_ms, want = cuda_ms(lambda: ref.sorted_segment_sum_ref(data, seg, s),
                             reps=2)
    lib_ms, lib = cuda_ms(lambda: torch.zeros(s, d, device="cuda").index_add_(
        0, seg, data), reps=5)
    err = float((got - want).abs().max())
    lib_err = float((lib - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    del got, want, lib
    nbytes = (data.numel() + n + s * d) * 4
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": err}
    log(f"[timing] sorted_segment_sum ({n} x {d} into {s}): {ms:.3f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s; plain {plain_ms:.3f} ms, index_add_ "
        f"{lib_ms:.3f} ms (max_abs_err {lib_err:.3g}), bound "
        f"{row['bound_ms']:.4f} ms from {nbytes} B), max_abs_err {err:.3g}")

    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ops.sorted_segment_sum(data, seg, s)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["sorted_segment_sum"]
    plain = ref.sorted_segment_sum_ref.calls
    # every id is in range, so the segments' column totals are the data's
    step = 1 << 22
    total = out.double().sum(0)
    want_total = sum(data[i:i + step].double().sum(0)
                     for i in range(0, n, step))
    col_err = float((total - want_total).abs().max())
    log(f"[main] segsum: {secs:.3f} s, launches {launches}, plain calls "
        f"{plain}, column totals within {col_err:.3g} of the data's")
    if launches != 1 or plain or not col_err <= 1e-2 or \
            not torch.isfinite(out).all():
        raise AssertionError("segsum: the counted launch failed")
    del data, seg, out
    torch.cuda.empty_cache()
    return row, launches, max(checks.err.values())



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from repro_torch.graph.generators import rmat
        from repro_torch.core import make_cf_app, make_fsm_app, make_tc_app
        from repro_torch.configs.registry import get_arch
        from repro_torch.kernels import build
        from repro_torch.kernels.extend_fused import ops
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    for src, report in build.build_all(build.sources()).items():
        log(f"[build] {src.name}:\n{report.strip()}")
    log(f"[build] {time.perf_counter() - t0:.1f} s")

    # every kernel launch of the main path against its plain version: at
    # scale 12 with the full pack (bitmap) and without it (search), then at
    # the main size, RMAT-16 (search), keeping TC's launches for timing
    tc_cf = (("tc", make_tc_app()), ("4-cf", make_cf_app(4)))
    g12 = rmat(12, 16, seed=0)
    expected12 = dict(zip(("tc", "4-cf"), scipy_counts(g12)))
    for mode, pmb in (("bitmap", 4 << 20), ("search", 0)):
        checks = checked_runs(g12, tc_cf, expected12, f"rmat12 {mode}",
                              pack_max_bytes=pmb)
        if mode not in checks.modes:
            raise AssertionError(f"rmat12: expected {mode} mode, got "
                                 f"{checks.modes}")
    del checks

    g16 = rmat(16, 16, seed=0)
    log(f"[graph] rmat(16, 16, seed=0): {g16.n_vertices} vertices, "
        f"{g16.n_edges // 2} undirected edges")
    t0 = time.perf_counter()
    tri, c4 = scipy_counts(g16)
    log(f"[scipy] triangles {tri}, 4-cliques {c4} "
        f"({time.perf_counter() - t0:.1f} s)")
    expected = {"tc": tri, "4-cf": c4}
    t0 = time.perf_counter()
    checks16 = checked_runs(g16, tc_cf, expected, "rmat16", keep="tc")
    log(f"[check] rmat16: {time.perf_counter() - t0:.1f} s")
    if checks16.overflow_cases < 1:
        raise AssertionError("no overflow case was checked")
    timing = time_kernels(checks16.kept)
    checks16.kept.clear()
    torch.cuda.empty_cache()

    launches = main_path(g16, expected)
    profile_warm(g16, make_tc_app(), "rmat16 tc")
    profile_warm(g16, make_cf_app(4), "rmat16 4-cf")

    # the hand-optimised TC on the intersection kernel: every launch
    # checked at scale 12 and at the main size, keeping the latter for
    # timing; then the counted cold and warm calls
    t_phase = time.perf_counter()
    tc_fused_checked(g12, expected12["tc"], "rmat12 tc-fused")
    checks_tc = tc_fused_checked(g16, tri, "rmat16 tc-fused", keep=True)
    timing.update(time_kernels(checks_tc.kept))
    checks_tc.kept.clear()
    launches["intersect_count"] = tc_fused_main(g16, tri)
    log(f"[tc-fused] phase {time.perf_counter() - t_phase:.1f} s")

    # the single-pass pruned extend: every launch checked at the sizes and
    # modes of the pair's checks, keeping RMAT-16 TC's for timing beside
    # the pair on the same arguments; then the counted main path
    t_phase = time.perf_counter()
    lookback = dict(backend="cuda-1p", names=tuple(LOOKBACK_REPLACES))
    for mode, pmb in (("bitmap", 4 << 20), ("search", 0)):
        checks = checked_runs(g12, tc_cf, expected12,
                              f"rmat12 {mode} cuda-1p", pack_max_bytes=pmb,
                              **lookback)
        if mode not in checks.modes or checks.pair_matches < 1:
            raise AssertionError(f"rmat12 cuda-1p: modes {checks.modes}, "
                                 f"{checks.pair_matches} pair matches")
    checks_1p = checked_runs(g16, tc_cf, expected, "rmat16 cuda-1p",
                             keep="tc", **lookback)
    if checks_1p.overflow_cases < 1:
        raise AssertionError("cuda-1p: no overflow case was checked")
    timing.update(time_kernels(checks_1p.kept))
    a, kw = checks_1p.kept.pop("extend_pruned_1p")
    pair_ms, _ = cuda_ms(lambda: ops.extend_pruned(*a, **kw), reps=10)
    log(f"[timing] extend_pruned, the pair with its cumsum, on the same "
        f"arguments: {pair_ms:.3f} ms")
    del a, kw
    torch.cuda.empty_cache()
    for k, n in main_path(g16, expected, backend="cuda-1p").items():
        launches[k] = launches.get(k, 0) + n
    profile_warm(g16, make_cf_app(4), "rmat16 4-cf cuda-1p",
                 backend="cuda-1p")
    log(f"[cuda-1p] phase {time.perf_counter() - t_phase:.1f} s")
    del g16
    torch.cuda.empty_cache()

    # FSM, the edge-induced path: every launch checked at scale 12 with a
    # min_support that makes the label mask drop one label, then at the
    # main size, keeping the level-2 launch for timing
    t_fsm = time.perf_counter()
    g12l = rmat(12, 8, seed=0, labels=4)
    for skewed in (False, True):
        if skewed:
            # with four even labels, no pattern passes level 1 once a label
            # is rare enough to drop, so level 2 has no live candidate;
            # fold 7 in 8 vertices of label 3 into label 0, and the mask
            # drops label 3 while the other patterns stay frequent
            lab = g12l.labels
            fold = (lab == 3) & (torch.arange(lab.shape[0],
                                              device=lab.device) % 8 != 0)
            g12l = dataclasses.replace(g12l, labels=torch.where(fold, 0, lab))
        ms12 = min(scipy_fsm(g12l, 0)[2]) + 1
        checks, dropped = fsm_checked(
            g12l, ms12, f"rmat12 3-fsm ms={ms12}{' skewed' * skewed}")
        live = checks.edge_levels[0]
        if len(dropped) != 1 or (skewed and min(live[1], live[3]) < 1):
            raise AssertionError(f"rmat12 3-fsm: the mask dropped labels "
                                 f"{dropped}, level 2 {live}")
    g15 = rmat(15, 8, seed=0, labels=4)
    want15, edges15, freq15 = scipy_fsm(g15, FSM_SUPPORT)
    deg = g15.degrees().cpu().numpy().astype(np.int64)
    n_cand, n_wedges = int((deg * deg).sum()), int((deg * (deg - 1) // 2)
                                                   .sum())
    log(f"[graph] rmat(15, 8, seed=0, labels=4): {g15.n_vertices} vertices, "
        f"{g15.n_edges // 2} undirected edges, max degree {int(deg.max())}, "
        f"label frequencies {freq15}, edge supports "
        f"{sorted(edges15.values())}, level 2: {n_cand} candidates, "
        f"{n_wedges} wedges")
    log(f"[scipy] 3-fsm at {FSM_SUPPORT}: {len(want15)} frequent, supports "
        f"{want15}")
    checks15, _ = fsm_checked(g15, FSM_SUPPORT, "rmat15 3-fsm", keep=True)
    for cand_cap, total, surv, _ in checks15.edge_levels:
        if (total, surv) != (n_cand, n_wedges):
            raise AssertionError(f"rmat15 level 2: {total} candidates and "
                                 f"{surv} survivors at cand_cap {cand_cap}")
    timing.update(time_kernels(checks15.kept))
    checks15.kept.clear()
    torch.cuda.empty_cache()
    launches["extend_edge"] = fsm_main_path(g15, FSM_SUPPORT, want15)
    profile_warm(g15, make_fsm_app(3, FSM_SUPPORT, max_patterns=64),
                 "rmat15 3-fsm")
    log(f"[fsm] phase {time.perf_counter() - t_fsm:.1f} s")
    del g15
    torch.cuda.empty_cache()

    # motif counting and compiled patterns: the state, canonical and
    # labeled variants of the pruned kernels
    t_phase = time.perf_counter()
    mc_errs = mc_phase(timing, launches)
    log(f"[mc] phase {time.perf_counter() - t_phase:.1f} s")

    # LM serving: every flash-attention launch of sets A and B checked,
    # the kernel timed on set A's layer 0, the counted sets, then f32
    t_phase = time.perf_counter()
    arch = get_arch("qwen3-0.6b")
    checks_lm = lm_checked(arch)
    a, kw = checks_lm.layer0.pop("A")
    timing["flash_attention"] = time_flash(a, kw)
    a, kw = checks_lm.layer0.pop("B")
    time_flash(a, kw, plain=False)
    del a, kw
    launches["flash_attention"] = sum(lm_main(arch, label)
                                      for label in LM_SETS)
    profile_lm(arch)
    lm_f32_end_to_end(arch)
    log(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    timing["sorted_segment_sum"], launches["sorted_segment_sum"], seg_err = \
        segsum_phase()
    log(f"[segsum] phase {time.perf_counter() - t_phase:.1f} s")

    kernels = []
    errs = {**checks16.err, **checks15.err, **checks_tc.err, **checks_1p.err,
            **checks_lm.err, "sorted_segment_sum": seg_err}
    for name, err in mc_errs.items():
        errs[name] = max(errs.get(name, 0), err)
    for name, replaces in {**REPLACES, **EDGE_REPLACES, **LOOKBACK_REPLACES,
                           **MC_REPLACES, **INTERSECT_REPLACES,
                           **FLASH_REPLACES, **SEGSUM_REPLACES}.items():
        t = timing[name]
        module = wrapper_module(name.split(":")[0])
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(module.SOURCE.relative_to(ROOT)),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
