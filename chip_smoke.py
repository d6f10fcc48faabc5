#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device   — the card's name and power limit; then ``[lint]``, the
              port's contract linter (``repro_torch.analysis``) over the
              ``repro_torch`` this script imports, its ``.py`` and ``.cu``
              sources: any finding fails the run.
2. build    — compile every CUDA source of the port with nvcc (all at
              once) and print each ``-Xptxas -v`` report, then the
              registers, spills, stack and shared memory of each of the 45
              pruned-kernel instantiations (wrapper, predicate, probe
              mode), which the timing lines and the kernels' JSON record
              repeat beside each timed instantiation, and of each of the
              segment sum's kernels.
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
              kernel's memory bound, and ``extend_candidates`` also on
              4-CF's level-3 launch (2^30 slots, its plain version in
              pieces), each K3 and K5 timing with its live slots, its
              uniform-tail slots (the constant tail the kernel stores
              without a search) and its registers and spills.
4. main path — ``Miner(rmat(16, 16, seed=0), app, backend="cuda")`` runs
              cold, then warm, for TC and 4-CF.  Each count must equal an
              independent count computed here on the host with scipy, every
              kernel must have launched during the run, and no plain version
              may have run; K3's launches are also counted by (k,
              cand_cap), and its row at 4-CF's level 3 gives those at that
              shape.  Then the cold and warm times of five fresh Miners of
              each (``[e2e]``: median, least and largest; the same after
              the main paths of phases 5, 7 and 8 for 3-FSM, ``cuda-1p``,
              3-MC and 4-MC), and a warm-run profile of each.
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
              pair (in pieces), the count against scipy; the share of
              RMAT-16's pairs that each of the kernel's paths takes
              (``[k6]``, from the arguments); the kernel timed on those
              pairs and on the same pairs shuffled (checked too); then the
              counted cold and warm calls (one launch and no plain call
              each).
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
              ``rmat(10, 16, seed=0)``, 4-MC's ``memo`` mode (the
              canonical test) on RMAT-10 and the labeled chain on RMAT-12:
              checked the same way (the plain versions over 2^25-slot
              pieces), then counted, cold and warm on both backends, each
              count and p_map against a scipy census computed here, no
              plain call, the warm replay once more free of device syncs
              up to its final read (count and p_map again), and the two
              backends' levels (vid, idx, state) equal.  Then
              ``extend_count``, ``extend_scatter`` and
              ``extend_pruned_1p`` timed in each spec kind's instantiation
              on a main-path level (the branch set + state on 4-MC's level
              3, the conjunction on the diamond's, the canonical test on
              4-MC memo's, the labeled conjunction on the chain's), and a
              warm-run profile of 4-MC.
9. mixed    — partial and core packs, K1's mixed connectivity probe.  At
              ``rmat(16, 16, seed=0)`` with a budget of 134,217,728 B (a
              quarter of the full pack): ``relabel=True`` (the core pack,
              32,768 rows and columns) and ``pack_partial=True`` (16,384
              rows), each pack's ``pack_hit_rate`` against the JAX
              package's.  TC and 4-CF cold and warm on ``cuda`` and
              ``cuda-1p`` with every launch checked, the mixed kernels
              timed on TC's level-2 arguments beside search mode on the
              same arguments, then the counted main path: counts equal to
              scipy, every pruned launch in mixed mode, no plain call, and
              every level (vid, idx) equal to the same Miner's run without
              a pack.  Then 3-MC on ``rmat(15, 16, seed=0)`` with
              ``relabel=True`` at 33,554,432 B (the branch set + state in
              mixed mode) the same way, and each other predicate in mixed
              mode under a partial and a core pack, checked small: the
              diamond on RMAT-10, the labeled chain on RMAT-12, 3-MC
              ``memo`` on RMAT-8; and one ``search="linear"`` Miner on
              ``torch-ref``.
10. plan    — the sampled estimator and plan transfer
              (``plan_source="estimate"`` and ``"cache"``).  Checked small:
              TC, 4-CF and 3-MC on RMAT-12 and 3-FSM on ``rmat(12, 8,
              seed=0, labels=4)``, estimated, cold and warm on ``cuda`` and
              ``cuda-1p``, every launch (the estimator's probe at 2^15
              slots included) held against its plain version and the
              estimated caps printed beside the inspection's.  Then the
              counted main paths, estimated: RMAT-16 TC and 4-CF and 3-FSM
              on ``rmat(15, 8, seed=0, labels=4)`` at 2500 on both
              backends, counts and supports against scipy, the plans'
              source, replans and caps (clipped to 2^30 slots), no plain
              call and no K3 launch, each with its ``[e2e]`` line, each
              estimated vertex replay once more free of device syncs.  Then
              RMAT-15 4-CF's inspected plan recorded in a plan cache under
              the ignored ``build/plan_cache/`` and RMAT-16 4-CF mined from
              it with ``plan_source="cache"`` (source ``transfer``).
11. blocks  — edge blocks (``block_size``, ``block_bytes``,
              ``checkpoint_cb``, ``resume_from``).  Checked small: TC, 4-CF
              and 3-MC on RMAT-12 in six blocks on both backends, and a
              3-MC run killed after block 1 and resumed.  The out-of-core
              row (the JAX package's tc-oocore): RMAT-16 TC and 4-CF
              relabeled under a 134,217,728 B core pack, estimated
              unblocked, then blocked at a quarter of its
              ``peak_live_bytes`` (cold, estimated) and re-streamed warm,
              with both runs' ``max_memory_allocated``, the queue's
              ``stage_s`` / ``mine_s`` and the block count.  Then 3-MC on
              ``rmat(16, 16, seed=0)``, whose 2.48 G level-2 candidates
              pass the 2^30 slots of one level, at a 16 GiB budget on both
              backends: the block size, each block's candidates counted on
              the host, the final plan and its replans, the count and p_map
              against the census (wedges from the degrees, triangles from
              scipy), no plain call.
12. sharded — ``mine_sharded`` over a ``torch.distributed`` process group.
              World size 1 over ``nccl`` in this process (a real
              communicator, its collectives on the card): RMAT-16 TC and
              4-CF on ``cuda`` and ``cuda-1p`` and 3-FSM on ``rmat(15, 8,
              seed=0, labels=4)`` at 2500, at the caps of the single-card
              inspected plan, every launch held against its plain version,
              then the launches counted (every kernel of the path, no
              plain call), each answer against ``Miner.run``'s and
              scipy's, with the wall time, the ``shard.mine`` and
              ``shard.merge`` spans (the card synchronised at their ends)
              and the warm ``Miner.run`` time beside it; then 3-FSM's
              packed reduce (``reduce_domain_sharded(packed=True)`` over
              the nccl group) free of device syncs, equal to the dense
              path's.  Then four
              ``gloo`` ranks sharing the card (NCCL refuses two ranks on
              one card), spawned after the build: RMAT-16 TC and the
              RMAT-15 3-FSM from the single-card caps scaled to their
              block (safety 2), doubled while any rank overflows; each
              rank's answer against world size 1's, its launches, rounds,
              ``max_memory_allocated`` and wall time.
13. cli     — ``repro_torch.launch.mine.main`` in this process on the card:
              ``--graph rmat:16`` (edge factor 8, the CLI's spec) with
              ``--app tc`` and ``--app 4-cf`` under ``--trace`` and
              ``--metrics`` (both files under the ignored ``build/cli/``
              checked by ``repro_torch.obs.validate``) and ``--fused-tc``;
              ``serve --mine --queries tc,4-cf``; every count against
              scipy, the launches counted; then a warm replay under
              tracing shown free of device syncs up to its final read, and
              a traced warm run that records no level and no op span.
14. lm      — Qwen3-0.6B at full width in bf16 (random weights from seed 0)
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
              logits within 1e-3) and the same 8 greedy tokens, and the FMA
              variant timed on that prefill's layer-0 arguments beside the
              plain version and ``scaled_dot_product_attention``, its bound
              on the f32 FMA pipes.
15. moe     — DeepSeek-MoE-16B at full width in bf16 (random weights from
              seed 0; 16,669,853,696 parameters, 33.3 GB) through
              ``serve_lm``: sets A and B with every ``flash_attention``
              launch held against ``attention_ref`` (Hq = Hkv = 16, group
              1), the kernel timed on set A's layer 0 beside the plain
              version and ``scaled_dot_product_attention`` (the JSON row
              ``flash_attention:group1``), then each set served again with
              the launches counted (28 a prefill, the tensor-core variant,
              no plain call), its prefill time, decode rate, peak memory
              and first tokens, and a profile of set A's prefill and of one
              decode step; one MoE layer (``apply_moe`` on the first 512
              tokens of set A's layer-0 input, f32, with no device sync)
              against the same on the CPU: dispatch integers equal, y
              within 1e-4; then the first 4 of the 28 layers at full width
              in f32, kernel against plain attention, last-token logits
              within 1e-3 and the same 8 greedy tokens unless a router
              near-tie flipped a (token, layer) expert set, whose count is
              printed either way.
16. recsys  — DIEN's full config (10M-item table, f32, TF32 off) through
              ``serve_recsys`` at serve_p99 (512) and serve_bulk (262,144)
              requests, three calls each, and ``score_candidates`` over
              retrieval_cand's 1,000,000 candidates: wall times and peak
              memory; batch 512's scores and the first 65,536 candidates'
              against the CPU on the same weights and inputs (1e-4); a
              profile of one batch-512 forward.
17. train   — Qwen3-0.6B at full width in bf16 (random weights from seed
              0, 596,042,752 parameters) through ``launch.train.main``
              with the JAX package's train policy (4 microbatches, CE in
              chunks of 512, f32 gradient accumulation, AdamW with
              ``scan_update``) at train_4k's sequence of 4,096 and a global
              batch of 16 (train_4k's 256 cut): one step with every
              ``flash_attention`` launch (one a layer a microbatch in the
              forward, one more in the remat recompute) held against
              ``attention_ref``; the kernel timed on the first launch's
              arguments (the JSON row ``flash_attention:train``) and the
              backward ``attention_grad`` (PyTorch ops, no TPU
              counterpart) on the same, against autograd through the plain
              version in f32, beside autograd through
              ``scaled_dot_product_attention``; then the counted run of 3
              steps: each step's loss (the first within 1.0 of
              ln(151,936)), wall time, tokens/s and peak, 672 launches of
              the tensor-core variant and no plain call, and a profile of
              one microbatch's forward and backward.  Then Qwen3's widths
              with 2 of its layers in f32, one train step on the card
              against the CPU (loss within 1e-4, gradients within 1e-3 of
              their norms, parameters within 1e-5, every FMA-variant
              launch checked);
              the SMOKE model killed at step 6, resumed from its
              checkpoint under the ignored ``build/train_restart/`` and
              held against a clean run (1e-5); and DIEN's train cell at
              train_batch's 65,536 requests, 2 steps and a profiled third.
18. segsum  — the segment sum ``sorted_segment_sum`` at ogb_products'
              scale (``configs/shapes.py``: 61,859,140 rows of 100 f32
              values into 2,449,029 sorted segments, 24.7 GB): sorted,
              unsorted and bf16 launches held against the plain version,
              the kernel timed beside it and ``index_add_``, then one
              counted launch.
19. gnn     — GNN training through ``build_cell(...).fn`` at CONFIG width
              in f32 (TF32 off, seed 0), the message passing's
              ``segment_sum`` on the segment-sum kernel: GAT (cora,
              full_graph_sm: 2,708 nodes, 1,433 features, 7 classes, from
              ``node_classification_data``), GraphSAGE full_graph_sm and
              minibatch_lg (1,024 seeds, fanouts 15-10, 602 features, 41
              classes, blocks from ``sample_fanout`` over 232,965 nodes at
              the data's average degree of 8), NequIP and EquiformerV2
              (2 of its 12 layers) on 128 molecules of 30 atoms joined as
              one graph (3,840 atoms, 111,360 edges), and EquiformerV2 at
              all 12 layers on the molecule shape's 16,384 edges (each
              molecule's 64 nearest pairs).  For each cell: one step with
              every kernel launch held against its plain version (f32
              within the summation bound of ``check_segsum``), 3 counted
              steps (loss, wall time, peak, the launches a step equal to
              ``gnn_launches``, no plain call), a profile of one
              2-layer EquiformerV2 step (the segment sum's share
              printed), and one step on the card against the CPU (the
              molecules cut to 8, 1 and 1): losses within 1e-4 (relative), unclipped gradients
              and the update within 1e-3 of their norms, the potentials'
              energy and forces within 1e-4.  The kernel timed beside its
              plain version and ``index_add_`` on EquiformerV2's layer-0
              aggregation over the 111,360 edges (the JSON row
              ``sorted_segment_sum:gnn``) and over the 12-layer cell's
              16,384, and on NequIP's widest message (``[111,360,
              160]``).

The line before the last two is the kernels' JSON record; the line before
the last is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around this file, it exits non-zero and prints no result.

``python3 chip_smoke.py --gnn-memory`` runs only the potentials' train
steps of ``GNN_MEMORY`` (the layers run plainly and under
``torch.utils.checkpoint``, on the joined molecules and on the molecule
shape's edge count) and prints their times, K7 launches and peaks, and a
profile of a step of each run the way the model runs its layers.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor
                                # cores (the FMA pipes)
TPU_KERNEL = "src/repro/kernels/extend_fused/extend.py"
REPLACES = {"extend_candidates": f"{TPU_KERNEL}:65",
            "extend_count": f"{TPU_KERNEL}:505",
            "extend_scatter": f"{TPU_KERNEL}:519"}
EDGE_REPLACES = {"extend_edge": f"{TPU_KERNEL}:658"}
# K3's second timed launch: 4-CF's level 3 on RMAT-16, 2^30 slots
K3_CF_ROW = "extend_candidates:4-cf-l3"
K3_ROWS = {K3_CF_ROW: REPLACES["extend_candidates"]}
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


# extend_candidates calls of the counted main paths that the kernels' JSON
# counts (phases 4, 7 and 8) by (k, cand_cap): the launches at each K3
# timing row's shape
K3_SHAPES: collections.Counter = collections.Counter()


@contextlib.contextmanager
def counting_k3_shapes():
    """While active, each ``extend_candidates`` call adds one to
    ``K3_SHAPES[(k, cand_cap)]``; the call runs as is."""
    from repro_torch.kernels.extend_fused import ops
    fn = ops.extend_candidates

    def run(*a, **kw):
        K3_SHAPES[kw["k"], kw["cand_cap"]] += 1
        return fn(*a, **kw)
    ops.extend_candidates = run
    try:
        yield
    finally:
        ops.extend_candidates = fn


# Fresh Miners over which a main path's cold and warm times are sampled
E2E_SAMPLES = 5


def e2e_samples(graph, name: str, app, want: int, backend: str,
                n: int = E2E_SAMPLES, run_kw: dict | None = None,
                **miner_kw) -> dict:
    """Cold then warm ``Miner.run(**run_kw)`` wall times of ``n`` fresh
    Miners of ``app`` on ``backend``, each made after emptying the
    allocator's cache as the counted main paths do; every count must be
    ``want``.  Logs and returns each run's median, least and largest
    time."""
    import statistics

    import torch
    from repro_torch.core import Miner

    on_card = graph.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    times: dict = {"cold": [], "warm": []}
    for _ in range(n):
        if on_card:
            torch.cuda.empty_cache()
        miner = Miner(graph, app, backend=backend, device=graph.device,
                      **miner_kw)
        for run in ("cold", "warm"):
            sync()
            t0 = time.perf_counter()
            count = miner.run(**(run_kw or {})).count
            sync()
            times[run].append(time.perf_counter() - t0)
            if count != want:
                raise AssertionError(f"{name} {backend} {run}: {count} != "
                                     f"{want}")
        del miner
    out = {run: (statistics.median(t), min(t), max(t))
           for run, t in times.items()}
    log(f"[e2e] {name} {backend}: " + ", ".join(
        f"{run} median {med:.4f} s ({lo:.4f}-{hi:.4f})"
        for run, (med, lo, hi) in out.items()) + f" over {n} Miners")
    return out


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


SEGSUM_PIECE = 1 << 16          # rows a piece of segsum_bound's sums


def segsum_bound(data, seg, n_segments: int):
    """Per element of a segment sum of f32 rows, ``2.02 (n - 1) u S``: n
    the segment's rows, S the sum of their magnitudes, u = 2^-24.  Any
    two orders of adding the same n terms in f32 give sums within twice
    the recursive-summation bound (n - 1) u S of the exact one, so within
    this of each other (2.02: second-order terms and S's own rounding);
    a segment of one row sums exactly.  S and n come from the plain
    version, in pieces of ``SEGSUM_PIECE`` rows."""
    import torch
    from repro_torch.kernels.segsum import ref

    mag = torch.zeros(n_segments, data.shape[1], device=data.device)
    rows = torch.zeros(n_segments, 1, device=data.device)
    for i in range(0, data.shape[0], SEGSUM_PIECE):
        part = data[i:i + SEGSUM_PIECE].float().abs()
        ids = seg[i:i + SEGSUM_PIECE]
        mag += ref.sorted_segment_sum_ref(part, ids, n_segments)
        rows += ref.sorted_segment_sum_ref(
            torch.ones(part.shape[0], 1, device=data.device), ids,
            n_segments)
    return 2.02 * (rows - 1).clamp_min(0) * 2.0 ** -24 * mag


def check_segsum(a, kw, got) -> float:
    """A ``sorted_segment_sum`` launch's output against
    ``sorted_segment_sum_ref`` on the same inputs.  bf16 at
    ``assert_close``'s defaults; f32 element by element within
    ``segsum_bound`` (plus the smallest normal f32), since the kernel adds
    the same terms in another order (atomic adds): rounding apart, a
    missing, extra or wrong term shows, and so does a NaN (as in
    ``assert_close``).  Returns the largest absolute difference."""
    import torch
    from repro_torch.kernels.segsum import ref

    want = ref.sorted_segment_sum_ref(*a, **kw)
    if a[0].dtype == torch.bfloat16:
        torch.testing.assert_close(got, want)
        return float((got.float() - want.float()).abs().max())
    diff = (got - want).abs()
    bound = segsum_bound(*a, **kw) + torch.finfo(torch.float32).tiny
    # a NaN in either is never within the bound; equal infinities are
    bad = ~((diff <= bound) | (got == want))
    if bool(bad.any()):
        i = int(torch.argmax(torch.where(
            bad, (diff - bound).nan_to_num(torch.inf), -torch.inf)))
        raise AssertionError(
            f"sorted_segment_sum: not close to the plain version: "
            f"{int(bad.sum())} of {diff.numel()} elements past 2.02 (n - 1) "
            f"u S; at flat index {i} |got - want| = "
            f"{float(diff.view(-1)[i]):.3g}, the bound "
            f"{float(bound.view(-1)[i]):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


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
    While ``largest`` names an app, its ``extend_candidates`` launch with
    the largest ``cand_cap`` is kept as ``extend_candidates:<app>``.
    The float kernels (``FLOAT_KERNELS``) are held to a stated tolerance
    by their checks, which raise themselves; ``err`` keeps the largest
    absolute difference.  ``plain_ms`` sums the CUDA-event times of the
    pruned kernels' plain calls.
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
        self.largest: str | None = None
        self.plain_ms = 0.0
        # per checked run: its executors' plans (plans_of)
        self.plans: dict = {}
        # checked launches by cand_cap
        self.cand_caps: collections.Counter = collections.Counter()

    def _plain(self, a, fn):
        """``fn()``, a plain version's call on inputs ``a``, its time added
        to ``plain_ms`` when they lie on the card."""
        import torch
        if a[0].device.type != "cuda":
            return fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.plain_ms += start.elapsed_time(end)
        return out

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
            self.cand_caps[kw.get("cand_cap")] += 1
            self.modes.add(kw.get("conn_mode", "-"))
            if self.keep and name not in self.kept:
                self.kept[name] = (a, kw)
            key = f"{name}:{self.largest}"
            if name == "extend_candidates" and self.largest and (
                    key not in self.kept
                    or kw["cand_cap"] > self.kept[key][1]["cand_cap"]):
                self.kept[key] = (a, kw)
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
            want = self._plain(a, lambda: ref.extend_candidates_ref(
                *a, **kw, slots=(lo, hi)))
            err = max(err, max_abs_err([g[lo:hi] for g in got], want))
        return err

    def _check_extend_count(self, a, kw, got) -> int:
        from repro_torch.kernels.extend_fused import ref
        err = 0
        for lo, hi in self._ranges(kw["cand_cap"]):
            want = self._plain(a, lambda: ref.extend_count_ref(
                *a, **kw, slots=(lo, hi)))
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
            want = self._plain(a, lambda: ref.extend_scatter_ref(
                *a, **{**kw, "out_cap": out_cap}, slots=(lo, hi)))
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
            want = self._plain(a, lambda: ref.extend_edge_ref(
                *a, **kw, slots=(lo, hi)))
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
            *want, n = self._plain(a, lambda: ref.extend_pruned_1p_ref(
                *a, **{**kw, "out_cap": out_cap}, slots=(lo, hi),
                base=base))
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
        """Against ``sorted_segment_sum_ref`` (``check_segsum``)."""
        return check_segsum(a, kw, got)

    def report(self, label: str) -> None:
        log(f"[check] {label}: launches {self.launches}, modes "
            f"{sorted(self.modes)}, overflow cases {self.overflow_cases}, "
            f"buffers equal to the pair's {self.pair_matches}, max_abs_err "
            f"{self.err}")


def checked_runs(graph, apps, expected: dict, label: str,
                 pack_max_bytes: int = 4 << 20, keep: str | None = None,
                 chunk: int = 1 << 25, backend: str = "cuda",
                 names=tuple(REPLACES), largest: str | None = None,
                 **miner_kw) -> KernelChecks:
    """Cold then warm ``Miner.run`` of each app on ``backend``, on the
    graph's device, every launch of the kernels ``names`` held against its
    plain version, and each count against ``expected``.
    ``keep`` names the app whose first launch of each kernel keeps its
    arguments for timing, ``largest`` the app whose largest
    ``extend_candidates`` launch does; ``miner_kw`` are further ``Miner``
    options (``relabel``, ``pack_partial``)."""
    import torch
    from repro_torch.core import Miner

    on_card = graph.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    checks = KernelChecks(chunk, names)
    with checks:
        for name, app in apps:
            checks.keep = name == keep
            checks.largest = name if name == largest else None
            miner = Miner(graph, app, backend=backend,
                          pack_max_bytes=pack_max_bytes, device=graph.device,
                          **miner_kw)
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
    # the full pack is read in bitmap mode.  A partial or core pack is not
    # counted: a probe reads only the words it addresses, and the CSR,
    # which the gather reads in full, answers every probe too, so mixed
    # mode moves search mode's bytes and the row map
    bits = a[6].shape[0] * 4 if kw["conn_mode"] == "bitmap" else 0
    if kw["conn_mode"] == "mixed":
        bits = kw["row_slot"].numel() * 4
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


# The pruned kernels' instantiations in extend.cu's -Xptxas -v report: the
# wrapper and probe mode from the kernel's symbol, the predicate (as
# ops.INSTANCE_LAUNCHES names it) from its template argument
INSTANCE_SYMBOL = re.compile(
    r"(extend_count|extend_scatter|extend_pruned_1p)_kernelILi(\d)E")
PRED_SYMBOLS = {"CliquePred": "clique", "ConjPredILb0E": "conjunction",
                "ConjPredILb1E": "labeled", "CanonPred": "canonical",
                "BranchPred": "branches"}
RESOURCE_KEYS = ("registers", "spill_stores", "spill_loads")
# (wrapper, predicate, mode) -> build.kernel_resources' entry, filled by
# the build phase
RESOURCES: dict = {}
# The enumerators' kernels in the same report: K3, and K5 by its edge count
ENUM_SYMBOL = re.compile(
    r"(extend_candidates)_kernel|(extend_edge)_kernelILi(\d)E")
# (wrapper, E or None) -> build.kernel_resources' entry, filled by the
# build phase
ENUM_RESOURCES: dict = {}
# the intersection kernel's build.kernel_resources entry, filled by the
# build phase
K6_RESOURCES: dict = {}
# K7's kernels (mangled names) in segsum.cu's report
K7_RESOURCES: dict = {}


def instance_resources(report: str) -> dict:
    """The pruned instantiations' resources in extend.cu's ``-Xptxas -v``
    report, by (wrapper, predicate, probe mode)."""
    from repro_torch.kernels.build import kernel_resources
    from repro_torch.kernels.extend_fused.ops import CONN_MODES
    modes = {v: k for k, v in CONN_MODES.items()}
    out = {}
    for name, res in kernel_resources(report).items():
        m = INSTANCE_SYMBOL.search(name)
        pred = next((p for sym, p in PRED_SYMBOLS.items() if sym in name),
                    None)
        if m and pred:
            out[m.group(1), pred, modes[int(m.group(2))]] = res
    return out


def enumerator_resources(report: str) -> dict:
    """K3's and K5's kernels' resources in extend.cu's ``-Xptxas -v``
    report, by (wrapper, E), E None for K3."""
    from repro_torch.kernels.build import kernel_resources
    out = {}
    for name, res in kernel_resources(report).items():
        if m := ENUM_SYMBOL.search(name):
            key = ((m.group(1), None) if m.group(1)
                   else (m.group(2), int(m.group(3))))
            out[key] = res
    return out


def enumerator_of(name: str, kw: dict) -> tuple:
    """The ENUM_RESOURCES key of a K3 or K5 launch."""
    return (name, kw["n_slots"] - 1 if name == "extend_edge" else None)


def tail_slots(name: str, a, kw) -> int:
    """Slots of a K3 or K5 launch in its constant tail, where every output
    is one value: K5's from the total on; K3's from where, past the total,
    the last parent's CSR pointer reaches its clamp at m - 1
    (``uniform_from`` in extend.cu)."""
    cand_cap = kw["cand_cap"]
    if name == "extend_edge":
        return max(0, cand_cap - int(a[2][-1]))
    col, offsets, starts, vlo = a[0], a[1], a[2], a[4]
    start = max(int(offsets[-1]),
                int(starts[-1]) + col.shape[0] - 1 - int(vlo[-1]))
    return max(0, cand_cap - start)


def instance_of(name: str, kw: dict) -> tuple:
    """The instantiation a pruned launch with keyword arguments ``kw``
    runs, as ``ops.INSTANCE_LAUNCHES`` keys it."""
    spec = kw["spec"]
    return (name, "labeled" if spec.needs_labels else spec.kind,
            kw["conn_mode"])


# The enumerators, each with the index of its offsets among its arguments
ENUM_KERNELS = {"extend_candidates": 1, "extend_edge": 2}
# Candidate slots up to which a timed plain version runs in one call; a
# larger pruned launch's plain version runs (and is timed) in pieces of
# this many slots, each piece compared with its window of the kernel's
# output, as KernelChecks does
PLAIN_WHOLE = 1 << 28


def time_kernels(kept: dict, tag: str = "") -> dict:
    """CUDA-event times of each kernel and its plain version on the
    arguments one main-path launch gave it, the two outputs compared, and
    the memory bound; ``tag`` follows the kernel's name in the log."""
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
        if (name in PRUNED_REPLACES or name in ENUM_KERNELS) and \
                kw["cand_cap"] > PLAIN_WHOLE:
            pieces = KernelChecks(PLAIN_WHOLE, names=())
            if name == "extend_scatter":
                err = pieces._scatter_err(a, kw, got, kw["out_cap"])
            elif name == "extend_pruned_1p":
                err = pieces._lookback_err(a, kw, got, kw["out_cap"])
            else:
                err = getattr(pieces, f"_check_{name}")(a, kw, got)
            plain_ms = pieces.plain_ms
        else:
            plain_ms, want = cuda_ms(lambda: plain[name](*a, **kw), reps=2)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max_abs_err(got, want)
            del want
        del got
        nbytes = bytes_moved(name, a, kw)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "max_abs_err": err}
        extra = ""
        if name in PRUNED_REPLACES:
            # live slots: those below cand_cap and the true total
            live = min(kw["cand_cap"], int(a[1][-1]))
            inst = instance_of(name, kw)
            res = RESOURCES.get(inst, dict.fromkeys(RESOURCE_KEYS))
            rows[name].update(live_slots=live, **{
                key: res[key] for key in RESOURCE_KEYS})
            extra = (f", {live} live slots, {live / ms * 1e3:.4e} live "
                     f"slots/s, {' '.join(inst[1:])}: {res['registers']} "
                     f"registers, spills {res['spill_stores']} / "
                     f"{res['spill_loads']} B")
        elif name in ENUM_KERNELS:
            # live slots: below cand_cap and the true total; tail slots:
            # those whose outputs are the one constant of the tail
            live = min(kw["cand_cap"], int(a[ENUM_KERNELS[name]][-1]))
            tail = tail_slots(name, a, kw)
            res = ENUM_RESOURCES.get(enumerator_of(name, kw),
                                     dict.fromkeys(RESOURCE_KEYS))
            rows[name].update(live_slots=live, tail_slots=tail, **{
                key: res[key] for key in RESOURCE_KEYS})
            extra = (f", {live} live slots, {tail} uniform-tail slots, "
                     f"{res['registers']} registers, spills "
                     f"{res['spill_stores']} / {res['spill_loads']} B")
        elif name in INTERSECT_REPLACES:
            res = K6_RESOURCES or dict.fromkeys(RESOURCE_KEYS)
            rows[name].update({key: res[key] for key in RESOURCE_KEYS})
            extra = (f", {res['registers']} registers, spills "
                     f"{res['spill_stores']} / {res['spill_loads']} B")
        log(f"[timing] {name}{tag} ({int_args(kw)}): {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms from {nbytes} B), "
            f"max_abs_err {err}{extra}")
        if err:
            raise AssertionError(f"{name} differs from its plain version")
        torch.cuda.empty_cache()
    return rows


def time_with_k3_l3(kept: dict) -> dict:
    """``time_kernels`` on ``kept``, with K3's 4-CF launch (kept as
    ``extend_candidates:4-cf``, its level 3) timed as a row of its own,
    ``K3_CF_ROW``, which also keeps its ``shape`` (k, cand_cap)."""
    cf = kept.pop("extend_candidates:4-cf")
    if cf[1]["k"] != 3:
        raise AssertionError(f"4-cf's largest K3 launch is at k={cf[1]['k']}")
    rows = time_kernels(kept)
    rows[K3_CF_ROW] = time_kernels({"extend_candidates": cf})[
        "extend_candidates"]
    rows[K3_CF_ROW]["shape"] = (3, cf[1]["cand_cap"])
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


def replay_without_sync(miner, want: int, label: str, p_map=None) -> None:
    """The warm vertex replay up to its final read, with every device sync
    an error; its count must be ``want`` (and its pattern map ``p_map``,
    where given)."""
    import torch
    import torch.nn.functional as F

    (ex,) = miner._executors.values()
    src, dst = miner.init_edges()
    m = int(src.shape[0])
    pad = (0, ex.cap0 - m)
    src, dst = F.pad(src, pad), F.pad(dst, pad)
    n = torch.tensor(m, dtype=torch.int32, device="cuda")
    count, got_map, ovf = sync_free(lambda: ex._run_once(src, dst, n))
    if (int(count), bool(ovf)) != (want, False) or (
            p_map is not None and got_map.tolist() != list(p_map)):
        raise AssertionError(f"{label}: the sync-checked replay counted "
                             f"{int(count)} {got_map.tolist()} (overflow "
                             f"{bool(ovf)})")
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
                chunk: int = 1 << 25, backend: str = "cuda",
                run_kw: dict | None = None, n_launches: int | None = 3):
    """Cold then warm 3-FSM (``Miner.run(**run_kw)``) on ``backend`` with
    every edge-kernel launch held against its plain version, and the
    frequent supports against the scipy count; ``n_launches`` (unless
    None) is the edge kernel's launches the two runs make.  Returns the
    checks and the labels the app's vertex mask dropped."""
    import torch
    from repro_torch.core import Miner, make_fsm_app

    want, _, _ = scipy_fsm(graph, min_support)
    checks = KernelChecks(chunk, names=tuple(EDGE_REPLACES))
    checks.keep = keep
    with checks:
        miner = Miner(graph, make_fsm_app(3, min_support, max_patterns=64),
                      backend=backend, device=graph.device)
        for run in ("cold", "warm"):
            got = frequent_supports(miner.run(**(run_kw or {})),
                                    min_support)
            if got != want:
                raise AssertionError(f"{label} {run}: supports {got} != "
                                     f"scipy {want}")
    checks.plans[label] = plans_of(miner)
    mask = miner.ops.app.to_add_vertex_mask(miner.ctx)
    dropped = sorted(set(graph.labels[~mask].tolist()))
    checks.report(label)
    log(f"[check] {label}: {len(want)} frequent patterns, labels dropped by "
        f"the mask {dropped}, level-2 launches (cand_cap, candidates, "
        f"survivors, masked) {checks.edge_levels}")
    if n_launches is not None and \
            checks.launches["extend_edge"] != n_launches:
        raise AssertionError(f"{label}: {checks.launches} launches, not "
                             f"{n_launches}")
    del miner
    if graph.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks, dropped


def fsm_main_path(graph, min_support: int, want: list[int],
                  backend: str = "cuda", run_kw: dict | None = None,
                  label: str = "3-fsm") -> int:
    """Cold then warm 3-FSM through ``Miner.run(**run_kw)`` on ``backend``,
    the launches counted (2 cold: the inspection's or the estimator's probe
    and the extension; 1 warm); then the warm replay re-run up to its final
    read with device syncs made errors.  Returns the run's ``extend_edge``
    launches."""
    import numpy as np
    import torch
    from repro_torch.core import Miner, make_fsm_app
    from repro_torch.kernels.extend_fused import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    miner = Miner(graph, make_fsm_app(3, min_support, max_patterns=64),
                  backend=backend)
    times, results, launches = {}, {}, {}
    level1 = None
    for run in ("cold", "warm"):
        before = ops.LAUNCHES["extend_edge"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[run] = miner.run(**(run_kw or {}))
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        launches[run] = ops.LAUNCHES["extend_edge"] - before
        if results[run].levels is not None:   # an inspection's levels
            level1 = int(results[run].levels[0].n)
            results[run].levels = None
    plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
    peak = torch.cuda.max_memory_allocated()
    (ex,) = miner._executors.values()
    log(f"[main] {label}: cold {results['cold'].count} patterns in "
        f"{times['cold']:.3f} s, warm {results['warm'].count} in "
        f"{times['warm']:.3f} s, plan caps {list(ex.plan.caps)} filter caps "
        f"{list(ex.plan.filter_caps)} ({ex.plan.source}), replans "
        f"{ex.n_replans}, peak {peak} B, launches {launches}, plain calls "
        f"{plain}" + ("" if level1 is None else f", level 1 {level1} edges"))
    for run, r in results.items():
        got = frequent_supports(r, min_support)
        if got != want or r.count != FSM_FREQUENT:
            raise AssertionError(f"{label} {run}: {r.count} patterns, "
                                 f"supports {got} != scipy {want}")
    if level1 is not None and level1 != miner.ctx.n_uedges:
        raise AssertionError(f"level 1 kept {level1} of "
                             f"{miner.ctx.n_uedges} edges")
    if launches != {"cold": 2, "warm": 1} or plain:
        raise AssertionError(f"{label}: launches {launches}, plain {plain}")
    count = sum(launches.values())
    # the warm replay up to its final read, with every device sync an error
    n = torch.tensor(miner.ctx.n_uedges, dtype=torch.int32, device="cuda")
    args = miner.edge_worklist()
    _, supports, _ = sync_free(lambda: ex._run_once(*args, n))
    if not np.array_equal(supports.cpu().numpy(), results["warm"].supports):
        raise AssertionError(f"{label}: the sync-checked replay differs")
    log(f"[main] {label}: the warm replay made no device sync before its "
        "final read")
    plans = plans_of(miner)
    del miner
    return count, plans


def profile_call(fn, label: str, also: str = "") -> None:
    """Device time by kernel, the device's idle share and the count of
    device operations over one call of ``fn`` (``torch.profiler``; says so
    when it records no device time): the ten kernels that take the most,
    then any other whose name holds ``also``."""
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
    rows.sort(key=lambda r: -r[1])
    for i, (key, us, count) in enumerate(rows):
        if i < 10 or also and also in key:
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


def k6_paths(a, kw, label: str) -> dict:
    """How many of a launch's pairs take each path of the intersection
    kernel (``ops.kernel_paths``, from the arguments alone), logged with
    the share that fails a gate (the search), and the elements of A' and
    of B over all pairs (B's are the words the kernel streams)."""
    from repro_torch.kernels.intersect import ops
    counts = ops.kernel_paths(*a, **kw).long().bincount(
        minlength=len(ops.PATHS)).tolist()
    paths = dict(zip(ops.PATHS, counts))
    lo_a, hi_a, lo_b, hi_b = (t.long() for t in a[1:])
    sum_a = int((hi_a - lo_a).clamp(0, kw["max_deg"]).sum())
    sum_b = int((hi_b - lo_b).clamp(min=0).sum())
    log(f"[k6] {label}: {a[1].shape[0]} pairs, paths {paths}, "
        f"gate-failing share {paths['search'] / a[1].shape[0]:.6f}, "
        f"sum |A'| {sum_a}, sum |B| {sum_b}")
    return paths


def shuffled_pairs(a, seed: int = 0) -> tuple:
    """A launch's arguments with its pairs in a random order (``seed``),
    col_idx unchanged."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(a[1].shape[0], generator=gen).to(a[1].device)
    return (a[0], *(t[order].contiguous() for t in a[1:]))


def tc_fused_phase(g12, tri12: int, g16, tri16: int) -> tuple:
    """Phase 6: every ``triangle_count_fused`` launch checked at RMAT-12
    and RMAT-16, the RMAT-16 launch's paths, the kernel timed on its
    arguments and on the same pairs shuffled, then the counted cold and
    warm calls.  Returns (timing row, launches, checks)."""
    import torch
    tc_fused_checked(g12, tri12, "rmat12 tc-fused")
    checks = tc_fused_checked(g16, tri16, "rmat16 tc-fused", keep=True)
    a, kw = checks.kept.pop("intersect_count")
    k6_paths(a, kw, "rmat16 tc-fused")
    shuffled = shuffled_pairs(a)
    k6_paths(shuffled, kw, "rmat16 tc-fused shuffled")
    row = time_kernels({"intersect_count": (a, kw)})["intersect_count"]
    time_kernels({"intersect_count": (shuffled, kw)}, tag=" shuffled")
    del a, shuffled
    torch.cuda.empty_cache()
    return row, tc_fused_main(g16, tri16), checks


# ---------------------------------------------------------------------------
# Motif counting and compiled patterns: the state, canonical and labeled
# variants of the pruned kernels


# the pruned kernels' TPU counterparts, by wrapper
PRUNED_REPLACES = {"extend_count": f"{TPU_KERNEL}:505",
                   "extend_scatter": f"{TPU_KERNEL}:519",
                   "extend_pruned_1p": f"{TPU_KERNEL}:322"}
# the timing rows of the spec-kind variants: the branch set + state (4-MC's
# level 3), the conjunction (psm-diamond's level 3), the canonical test
# (4-MC memo's level 3), all on RMAT-10, and the labeled conjunction (the
# labeled chain's level 2 on rmat(12, 8, labels=3)); each row's launches
# are its instantiation's on the [mc] main path, in any probe mode
MC_KINDS = ("branches", "conjunction", "canonical", "labeled")
MC_REPLACES = {f"{name}:{kind}": line for kind in MC_KINDS
               for name, line in PRUNED_REPLACES.items()}
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
               keep: str | None = None, run_kw: dict | None = None,
               names=None, **miner_kw) -> KernelChecks:
    """Cold then warm ``Miner.run(**run_kw)`` of each ``(name, app, count,
    p_map)`` of ``runs`` on ``backend``, every launch of the kernels
    ``names`` (by default the backend's) held against its plain version
    (state buffers included), and each count and p_map against the
    expected ones; ``miner_kw`` are further ``Miner`` options.  Each run's
    plans are kept in ``checks.plans[name]``."""
    import torch
    from repro_torch.core import Miner

    checks = KernelChecks(chunk, names or MC_PATH_KERNELS[backend])
    with checks:
        for name, app, count, p_map in runs:
            checks.keep = name == keep
            miner = Miner(graph, app, backend=backend,
                          pack_max_bytes=pack_max_bytes, device=graph.device,
                          **miner_kw)
            for run in ("cold", "warm"):
                r = miner.run(**(run_kw or {}))
                got = None if r.p_map is None else [int(x) for x in r.p_map]
                if r.count != count or got != p_map:
                    raise AssertionError(f"{label} {name} {run}: {r.count} "
                                         f"{got} != {count} {p_map}")
            checks.plans[name] = plans_of(miner)
            del miner
            torch.cuda.empty_cache()
    checks.report(label)
    if min(checks.launches.values()) < 1:
        raise AssertionError(f"{label}: a kernel was never checked")
    return checks


def mc_main(graph, name: str, app, count: int, p_map, backend: str,
            keep_levels: bool = False, mode: str | None = None,
            run_kw: dict | None = None, path=None, **miner_kw):
    """Cold then warm ``Miner.run(**run_kw)`` of ``app`` on ``backend``
    (with Miner options ``miner_kw``), the launches counted: every kernel
    of the path (by default the backend's) launches, no other kernel and
    no plain version runs, and with ``mode`` every pruned launch probes in
    that mode; then the warm replay once more up to its final read, with
    every device sync an error.  Returns the launches per kernel, per
    template instantiation (``ops.INSTANCE_LAUNCHES``), and the cold run's
    levels when ``keep_levels`` (else the Miner's plans, ``plans_of``)."""
    import torch
    from repro_torch.core import Miner
    from repro_torch.kernels.extend_fused import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    miner = Miner(graph, app, backend=backend, **miner_kw)
    times, results = {}, {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[run] = miner.run(**(run_kw or {}))
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
    launches, variants = dict(ops.LAUNCHES), dict(ops.VARIANT_LAUNCHES)
    modes, instances = ops.mode_launches(), dict(ops.INSTANCE_LAUNCHES)
    plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
    peak = torch.cuda.max_memory_allocated()
    (ex,) = miner._executors.values()
    got = {run: (r.count, None if r.p_map is None
                 else [int(x) for x in r.p_map])
           for run, r in results.items()}
    log(f"[main] {name} {backend}: cold {got['cold']} in {times['cold']:.3f} "
        f"s, warm {got['warm']} in {times['warm']:.3f} s, plan "
        f"{list(ex.plan.caps)} ({ex.plan.source}), replans {ex.n_replans}, "
        f"peak {peak} B, launches {launches}, variants {variants}, modes "
        f"{modes}, plain calls {plain}")
    if mode is not None and modes[mode] != sum(modes.values()):
        raise AssertionError(f"{name} {backend}: modes {modes}, not all "
                             f"{mode}")
    for run in got:
        if got[run] != (count, p_map):
            raise AssertionError(f"{name} {backend} {run}: {got[run]} != "
                                 f"census {(count, p_map)}")
    path = path or MC_PATH_KERNELS[backend]
    if plain or min(launches[k] for k in path) < 1 or any(
            n for k, n in launches.items() if k not in path):
        raise AssertionError(f"{name} {backend}: launches {launches}, plain "
                             f"calls {plain}")
    replay_without_sync(miner, count, f"{name} {backend}", p_map)
    levels = results["cold"].levels if keep_levels else plans_of(miner)
    del miner, results
    return launches, instances, levels


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


# The [mc] main paths whose cold and warm times are also sampled
E2E_MC = ("3-mc rmat15", "4-mc rmat10")


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
    memo = make_mc_app(4, "memo")
    mains = [("3-mc rmat15", g15, make_mc_app(3), c3_15),
             ("4-mc rmat10", g10, make_mc_app(4), c4_10),
             ("4-mc memo rmat10", g10, memo, c4_10),
             ("psm-diamond rmat10", g10, diamond, c4_10[4]),
             ("psm-lchain rmat12", g12l, chain, n_chain)]
    kind_launches = dict.fromkeys(MC_REPLACES, 0)
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
            with counting_k3_shapes():
                got, instances, levels = mc_main(graph, name, app, count,
                                                 p_map, backend,
                                                 keep_levels=True)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            for (wrapper, kind, _), n in instances.items():
                if f"{wrapper}:{kind}" in kind_launches:
                    kind_launches[f"{wrapper}:{kind}"] += n
            kept[backend] = levels
            if name in E2E_MC:
                e2e_samples(graph, name, app, count, backend)
        n_levels = levels_equal(kept["cuda"], kept["cuda-1p"])
        log(f"[main] {name}: cuda and cuda-1p levels equal (vid, idx, state) "
            f"on {n_levels} levels")
        del kept
        torch.cuda.empty_cache()
    del g15
    torch.cuda.empty_cache()

    # each spec kind's three kernels timed on one main-path level
    timed = {"branches": (g10, make_mc_app(4), 3),
             "conjunction": (g10, diamond, 3),
             "canonical": (g10, memo, 3), "labeled": (g12l, chain, 2)}
    for kind, (graph, app, k) in timed.items():
        log(f"[timing] {kind} variant (k {k}):")
        rows = time_kernels(kept_args(graph, app, k))
        for name in PRUNED_REPLACES:
            timing[f"{name}:{kind}"] = rows[name]
            errs[f"{name}:{kind}"] = errs.get(name, 0)
        del rows
        torch.cuda.empty_cache()
    launches.update(kind_launches)
    profile_warm(g10, make_mc_app(4), "rmat10 4-mc")
    return errs, {"c3_8": c3, "c4_10": c4_10, "n_chain": n_chain,
                  "c3_15": c3_15}


def kept_args(graph, app, k: int, **miner_kw) -> dict:
    """The arguments of the first launch at parent width ``k`` of each
    pruned kernel in cold runs of ``app`` on ``cuda`` (the pair) and
    ``cuda-1p``."""
    from repro_torch.core import Miner

    keeper = ArgsKeeper(("extend_count", "extend_scatter"), k=k)
    with keeper:
        Miner(graph, app, backend="cuda", **miner_kw).run()
    with ArgsKeeper(("extend_pruned_1p",), k=k) as keeper_1p:
        Miner(graph, app, backend="cuda-1p", **miner_kw).run()
    return {**keeper.kept, **keeper_1p.kept}


# ---------------------------------------------------------------------------
# Partial and core packs: K1's mixed connectivity probe in K2 and K4


# The TPU kernel's mixed probe (the select in _tile_enumerate)
MIXED_PROBE = f"{TPU_KERNEL}:258"
# A quarter of RMAT-16's full pack (536,870,912 B), the budget of the JAX
# package's out-of-core row (benchmarks/bench_backends.py, tc-oocore), and
# the same quarter of RMAT-15's 3-MC pack (134,217,728 B)
MIXED_BUDGET16 = 134_217_728
MIXED_BUDGET15 = 33_554_432
# RMAT-15 3-MC's core pack after relabeling: (rows, columns), hit rate
MIXED_MC_PACK = ((16384, 16384), 0.972)
# Per configuration: the Miner options, the same Miner's options with no
# pack (the run every level is held to), the pack's (rows, columns), and
# the JAX package's pack_hit_rate at three decimals
MIXED_CONFIGS = {
    "core": (dict(relabel=True, pack_max_bytes=MIXED_BUDGET16),
             dict(relabel=True, pack_max_bytes=0), (32768, 32768), 0.958),
    "partial": (dict(pack_partial=True, pack_max_bytes=MIXED_BUDGET16),
                dict(pack_max_bytes=0), (16384, 65536), 0.874)}
# the mixed instantiations timed and counted: clique at RMAT-16 TC's level 2
# under each configuration, the branch set at RMAT-15 3-MC's level 2 under
# the core pack
MIXED_ROWS = ("clique-mixed-core", "clique-mixed-partial",
              "branches-mixed-core")
MIXED_REPLACES = {f"{name}:{row}": MIXED_PROBE for row in MIXED_ROWS
                  for name in PRUNED_REPLACES}


def search_twin(kw: dict) -> dict:
    """A mixed launch's keyword arguments in search mode."""
    out = {k: v for k, v in kw.items()
           if k not in ("row_slot", "n_rows", "n_cols")}
    return {**out, "conn_mode": "search", "n_words": 1}


def time_mixed(kept: dict, label: str) -> dict:
    """``time_kernels`` on mixed launches' arguments, and beside each the
    search mode's time and bound on the same arguments, whose buffers must
    equal the mixed launch's."""
    rows = time_kernels(kept)
    for name, (a, kw) in kept.items():
        wrapper = getattr(wrapper_module(name), name)
        kw_s = search_twin(kw)
        ms, got = cuda_ms(lambda: wrapper(*a, **kw_s), reps=10)
        want = wrapper(*a, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if max_abs_err(got, want):
            raise AssertionError(f"{label} {name}: search mode's buffers "
                                 "differ from mixed mode's")
        bound = bytes_moved(name, a, kw_s) / HBM_BYTES_PER_S * 1e3
        rows[name]["search_ms"] = ms
        log(f"[timing] {label} {name}: mixed {rows[name]['ms']:.3f} ms "
            f"(bound {rows[name]['bound_ms']:.4f}), search {ms:.3f} ms "
            f"(bound {bound:.4f}) on the same arguments, buffers equal")
        del got, want
    return rows


def mixed_phase(expected: dict, census: dict, timing: dict,
                launches: dict) -> dict:
    """The [mixed] phase: RMAT-16 TC and 4-CF under a core pack (after
    relabeling) and a partial pack, 3-MC on RMAT-15 under a core pack,
    every launch checked, then the counted main path with every level held
    to the same Miner's run without a pack (itself counted and timed, the
    pair's warm times side by side), the mixed instantiations timed
    beside search mode; then the other predicates in mixed mode, checked
    small.  Returns the checks' largest errors by row."""
    import torch
    from repro_torch.core import (Miner, Pattern, make_cf_app, make_mc_app,
                                  make_tc_app, pattern_app)
    from repro_torch.graph.generators import rmat

    errs: dict = {}
    row_launches = dict.fromkeys(MIXED_REPLACES, 0)
    tc_cf = (("tc", make_tc_app()), ("4-cf", make_cf_app(4)))

    def count(instances, row, pred):
        for (wrapper, kind, mode), n in instances.items():
            if kind == pred and mode == "mixed":
                row_launches[f"{wrapper}:{row}"] += n

    def paired(graph, label, app, n, p_map, backend, opts, no_pack, row,
               pred):
        # the same Miner without a pack (search mode), then with it (mixed
        # mode), each counted and timed cold and warm by mc_main; every
        # level of the mixed run equal to the search run's
        *_, want = mc_main(graph, f"search {label}", app, n, p_map, backend,
                           keep_levels=True, mode="search", **no_pack)
        _, instances, got = mc_main(graph, f"mixed {label}", app, n, p_map,
                                    backend, keep_levels=True, mode="mixed",
                                    **opts)
        n_levels = levels_equal(got, want)
        log(f"[main] mixed {label} {backend}: levels equal to the run "
            f"without a pack (vid, idx, state) on {n_levels} levels")
        count(instances, row, pred)
        del got, want
        torch.cuda.empty_cache()

    def check_pack(opts, graph, app, label, rows_cols=None, hit=None):
        m = Miner(graph, app, backend="cuda", **opts)
        pg = m.ctx.packed
        rate = m.pack_hit_rate()
        log(f"[mixed] {label}: pack {pg.n_packed} rows x {pg.n_words} words "
            f"({pg.words.numel() * 4} B), n_cols {pg.n_cols}, full "
            f"{pg.full}, pack_hit_rate {rate}")
        if pg.full or (rows_cols and (pg.n_packed, pg.n_cols) != rows_cols) \
                or (hit is not None and round(rate, 3) != hit):
            raise AssertionError(f"{label}: unexpected pack")
        del m

    g16 = rmat(16, 16, seed=0)
    for cfg, (opts, no_pack, rows_cols, hit) in MIXED_CONFIGS.items():
        t0 = time.perf_counter()
        check_pack(opts, g16, make_tc_app(), f"rmat16 {cfg} (TC's DAG)",
                   rows_cols, hit)
        kept = {}
        for backend, names in (("cuda", REPLACES),
                               ("cuda-1p", LOOKBACK_REPLACES)):
            checks = checked_runs(g16, tc_cf, expected,
                                  f"rmat16 {cfg} {backend}", keep="tc",
                                  backend=backend, names=tuple(names),
                                  **opts)
            if "mixed" not in checks.modes:
                raise AssertionError(f"rmat16 {cfg}: modes {checks.modes}")
            for k, v in checks.err.items():
                errs[k] = max(errs.get(k, 0), v)
            kept.update({k: v for k, v in checks.kept.items()
                         if k in PRUNED_REPLACES})
            del checks
        rows = time_mixed(kept, f"rmat16 tc {cfg}")
        for name in PRUNED_REPLACES:
            timing[f"{name}:clique-mixed-{cfg}"] = rows[name]
        del kept, rows
        torch.cuda.empty_cache()
        for name, app in tc_cf:
            for backend in ("cuda", "cuda-1p"):
                paired(g16, f"rmat16 {cfg} {name}", app, expected[name],
                       None, backend, opts, no_pack, f"clique-mixed-{cfg}",
                       "clique")
        log(f"[mixed] rmat16 {cfg}: {time.perf_counter() - t0:.1f} s")
    del g16
    torch.cuda.empty_cache()

    # 3-MC on RMAT-15: the branch set with its state column, core pack
    g15 = rmat(15, 16, seed=0)
    c3 = census["c3_15"]
    opts = dict(relabel=True, pack_max_bytes=MIXED_BUDGET15)
    check_pack(opts, g15, make_mc_app(3), "rmat15 core", *MIXED_MC_PACK)
    run = ("3-mc rmat15", make_mc_app(3), sum(c3), c3)
    for backend in ("cuda", "cuda-1p"):
        checks = mc_checked(g15, [run], f"mixed 3-mc rmat15 core {backend}",
                            backend=backend, **opts)
        if "mixed" not in checks.modes:
            raise AssertionError(f"3-mc rmat15: modes {checks.modes}")
        for k, v in checks.err.items():
            errs[k] = max(errs.get(k, 0), v)
    for backend in ("cuda", "cuda-1p"):
        paired(g15, "rmat15 core 3-mc", make_mc_app(3), sum(c3), c3, backend,
               opts, dict(relabel=True, pack_max_bytes=0),
               "branches-mixed-core", "branches")
    rows = time_mixed(kept_args(g15, make_mc_app(3), 2, **opts),
                      "rmat15 3-mc core")
    for name in PRUNED_REPLACES:
        timing[f"{name}:branches-mixed-core"] = rows[name]
    del g15, rows
    torch.cuda.empty_cache()

    # every other predicate in mixed mode, under a partial and a core pack
    # of a quarter of the full pack, checked
    chain = pattern_app(Pattern.from_edges([(0, 1), (1, 2)],
                                           labels=[0, 1, 2]))
    c3_8, c4_10 = census["c3_8"], census["c4_10"]
    small = [("psm-diamond", rmat(10, 16, seed=0),
              pattern_app(Pattern.named("diamond")), c4_10[4], None, 32768),
             ("psm-lchain", rmat(12, 8, seed=0, labels=3), chain,
              census["n_chain"], None, 524288),
             ("3-mc memo", rmat(8, 16, seed=0), make_mc_app(3, "memo"),
              sum(c3_8), c3_8, 2048)]
    for name, graph, app, n, p_map, budget in small:
        for pack, opts in (("partial", dict(pack_partial=True)),
                           ("core", dict(relabel=True))):
            check_pack({**opts, "pack_max_bytes": budget}, graph, app,
                       f"{name} {pack}")
            for backend in ("cuda", "cuda-1p"):
                checks = mc_checked(graph, [(name, app, n, p_map)],
                                    f"mixed {name} {pack} {backend}",
                                    pack_max_bytes=budget, backend=backend,
                                    **opts)
                if "mixed" not in checks.modes:
                    raise AssertionError(f"{name}: modes {checks.modes}")
    g8 = rmat(8, 16, seed=0)
    linear = Miner(g8, make_mc_app(3), backend="torch-ref", search="linear")
    r = linear.run()
    log(f"[mixed] 3-mc rmat8 torch-ref search=linear: {r.count} "
        f"{[int(x) for x in r.p_map]}, pack {linear.ctx.packed}")
    if (r.count, [int(x) for x in r.p_map]) != (sum(c3_8), c3_8) \
            or linear.ctx.packed is not None:
        raise AssertionError("search=linear: wrong count or a pack")
    for name in row_launches:
        errs[name] = errs.get(name.split(":")[0], 0)
        if row_launches[name] < 1:
            raise AssertionError(f"{name}: no launch on the main path")
    launches.update(row_launches)
    return errs


# ---------------------------------------------------------------------------
# The sampled planner, plan transfer and edge blocks


# The pruned kernels each vertex backend's estimated (and seeded blocked)
# runs launch: no inspection, so no K3
PRUNED_PATH = {"cuda": ("extend_count", "extend_scatter"),
               "cuda-1p": ("extend_pruned_1p",)}
MAX_SLOTS = 1 << 30             # candidate slots a plan may hold
# the plan caches the [plan] phase's transfer writes, one a backend
PLAN_CACHE = ROOT / "build" / "plan_cache"
# 3-MC on RMAT-16's device-byte budget, 16 GiB
MC16_BLOCK_BYTES = 17_179_869_184


def plans_of(miner) -> list:
    """The Miner's executors' plans: ``(cap0, caps, filter_caps, source,
    replans)`` each."""
    return [(cap0, list(ex.plan.caps), list(ex.plan.filter_caps),
             ex.plan.source, ex.n_replans)
            for cap0, ex in sorted(miner._executors.items())
            if ex.plan is not None]


def check_plans(label: str, plans, sources) -> None:
    """Each plan clipped (every cand_cap and filter cap at most 2^30 slots,
    each out_cap at most its cand_cap), its source one of ``sources``, and
    ``grown`` exactly when it replanned."""
    if not plans:
        raise AssertionError(f"{label}: no plan")
    for _, caps, fcaps, source, replans in plans:
        if any(c > MAX_SLOTS or o > c for c, o in caps) or any(
                f > MAX_SLOTS for f in fcaps):
            raise AssertionError(f"{label}: caps {caps} {fcaps} not clipped")
        if source not in sources or (source == "grown") != (replans > 0):
            raise AssertionError(f"{label}: source {source}, replans "
                                 f"{replans}, not one of {sources}")


def note_launches(launches: dict, got: dict, instances: dict,
                  pack: str | None = None) -> None:
    """Adds a counted run's launches to the kernels' JSON rows: each
    wrapper's to its row, each instantiation's to its spec kind's row
    (``extend_count:branches``), mixed-mode ones under pack ``pack`` to
    the mixed rows (``extend_count:clique-mixed-core``)."""
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    for (wrapper, kind, mode), n in instances.items():
        key = (f"{wrapper}:{kind}-mixed-{pack}" if mode == "mixed" and pack
               else f"{wrapper}:{kind}")
        if key in launches:
            launches[key] += n


def wedge_census(graph, triangles: int) -> list[int]:
    """3-MC's census [open wedges, triangles] from the degrees and a
    triangle count: wedges = sum C(d, 2) - 3T."""
    import numpy as np
    deg = graph.degrees().cpu().numpy().astype(np.int64)
    return [int((deg * (deg - 1) // 2).sum()) - 3 * triangles, triangles]


def block_candidates(miner, block_size: int) -> list[int]:
    """Each block's level-2 candidates, counted on the host: sum deg(u) +
    deg(v) over its worklist entries (u, v)."""
    import numpy as np
    deg = miner.graph.degrees().cpu().numpy().astype(np.int64)
    src, dst = miner.worklist_host()
    per = deg[src] + deg[dst]
    return [int(per[lo:lo + block_size].sum())
            for lo in range(0, per.shape[0], block_size)]


def plan_phase(g12, expected12: dict, expected: dict, want15: list,
               launches: dict) -> dict:
    """The [plan] phase: the sampled estimator and plan transfer.  TC, 4-CF
    and 3-MC on RMAT-12 and 3-FSM on ``rmat(12, 8, seed=0, labels=4)`` with
    ``plan_source="estimate"`` on both backends, every launch (the probe's
    at 2^15 slots included) held against its plain version, the estimated
    caps printed beside the inspection's; then the counted main paths,
    RMAT-16 TC and 4-CF and 3-FSM on ``rmat(15, 8, seed=0, labels=4)``
    estimated, each with its five-Miner ``[e2e]`` line; then RMAT-15
    4-CF's plan recorded in a plan cache and RMAT-16 4-CF mined from it
    (``plan_source="cache"``, a transfer).  Returns the checks' largest
    errors by kernel."""
    import shutil

    import torch
    from repro_torch.core import (PlanCache, Miner, make_cf_app,
                                  make_fsm_app, make_mc_app, make_tc_app)
    from repro_torch.core.plan import SAMPLE_CAND_CAP
    from repro_torch.graph.generators import rmat

    errs: dict = {}
    est = {"plan_source": "estimate"}

    def note(checks):
        for k, v in checks.err.items():
            errs[k] = max(errs.get(k, 0), v)

    c3 = motif_census(g12, 3)
    small = [("tc", make_tc_app(), expected12["tc"], None),
             ("4-cf", make_cf_app(4), expected12["4-cf"], None),
             ("3-mc", make_mc_app(3), sum(c3), c3)]
    for backend in ("cuda", "cuda-1p"):
        checks = mc_checked(g12, small, f"plan rmat12 estimate {backend}",
                            pack_max_bytes=0, backend=backend, run_kw=est,
                            names=PRUNED_PATH[backend])
        probes = checks.cand_caps[SAMPLE_CAND_CAP]
        inspected = mc_checked(g12, small, f"plan rmat12 inspect {backend}",
                               pack_max_bytes=0, backend=backend)
        for name, *_ in small:
            log(f"[plan] rmat12 {name} {backend}: estimated "
                f"{checks.plans[name]}, inspection {inspected.plans[name]}")
            check_plans(f"rmat12 {name}", checks.plans[name],
                        ("estimated", "grown"))
        if probes < len(small):
            raise AssertionError(f"rmat12 {backend}: {probes} launches at "
                                 "the probe's 2^15 slots checked")
        note(checks)
        note(inspected)
    g12l = rmat(12, 8, seed=0, labels=4)
    ms12 = min(scipy_fsm(g12l, 0)[2]) + 1
    for backend in ("cuda", "cuda-1p"):
        label = f"plan rmat12 3-fsm ms={ms12} {backend}"
        checks, _ = fsm_checked(g12l, ms12, label, backend=backend,
                                run_kw=est, n_launches=None)
        log(f"[plan] rmat12 3-fsm {backend}: estimated "
            f"{checks.plans[label]}")
        check_plans(label, checks.plans[label], ("estimated", "grown"))
        note(checks)
    del g12l

    # the counted main paths at the main size, estimated
    g16 = rmat(16, 16, seed=0)
    for name, app in (("tc", make_tc_app()), ("4-cf", make_cf_app(4))):
        for backend in ("cuda", "cuda-1p"):
            got, instances, plans = mc_main(
                g16, f"estimate {name}", app, expected[name], None, backend,
                run_kw=est, path=PRUNED_PATH[backend])
            check_plans(f"estimate {name} {backend}", plans,
                        ("estimated", "grown"))
            note_launches(launches, got, instances)
            e2e_samples(g16, f"estimate {name}", app, expected[name],
                        backend, run_kw=est)
    g15l = rmat(15, 8, seed=0, labels=4)
    fsm = make_fsm_app(3, FSM_SUPPORT, max_patterns=64)
    for backend in ("cuda", "cuda-1p"):
        label = f"estimate 3-fsm {backend}"
        n, plans = fsm_main_path(g15l, FSM_SUPPORT, want15, backend=backend,
                                 run_kw=est, label=label)
        check_plans(label, plans, ("estimated", "grown"))
        launches["extend_edge"] += n
        e2e_samples(g15l, "estimate 3-fsm", fsm, FSM_FREQUENT, backend,
                    run_kw=est)
    del g15l
    torch.cuda.empty_cache()

    # plan transfer: RMAT-15 4-CF's plan (inspected) seeds RMAT-16 4-CF
    g15 = rmat(15, 16, seed=0)
    for backend in ("cuda", "cuda-1p"):
        directory = PLAN_CACHE / backend
        shutil.rmtree(directory, ignore_errors=True)
        cache = PlanCache(str(directory))
        donor = Miner(g15, make_cf_app(4), backend=backend)
        donor.run(plan_cache=cache)
        log(f"[plan] rmat15 4-cf {backend}: recorded {plans_of(donor)} in "
            f"{directory}")
        del donor
        torch.cuda.empty_cache()
        got, instances, plans = mc_main(
            g16, "transfer 4-cf", make_cf_app(4), expected["4-cf"], None,
            backend, run_kw={"plan_source": "cache", "plan_cache": cache},
            path=PRUNED_PATH[backend])
        check_plans(f"transfer 4-cf {backend}", plans, ("transfer",))
        note_launches(launches, got, instances)
    del g15, g16
    torch.cuda.empty_cache()
    return errs


class _Killed(Exception):
    """Raised by a checkpoint callback to stop a blocked run."""


def blocks_phase(g12, expected12: dict, triangles16: int, expected: dict,
                 launches: dict) -> dict:
    """The [blocks] phase: edge blocks.  TC, 4-CF and 3-MC on RMAT-12 at a
    block size of a sixth of the worklist on both backends, every launch
    checked, and a 3-MC run killed after block 1 and resumed; then the
    out-of-core row (RMAT-16 TC and 4-CF, relabeled, core pack at
    134,217,728 B: estimated unblocked, then blocked at a quarter of its
    ``peak_live_bytes``); then 3-MC on RMAT-16 at a 16 GiB budget, which
    needs 2.48 G level-2 candidates, past the 2^30 slots of one level.
    Returns the checks' largest errors by kernel."""
    import numpy as np
    import torch
    from repro_torch.core import (Miner, make_cf_app, make_mc_app,
                                  make_tc_app)
    from repro_torch.core.blocks import (auto_block_size, make_blocks,
                                         scale_caps)
    from repro_torch.core.plan import bucket_pow2, clip_caps, estimate_plan
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.extend_fused import ops

    errs: dict = {}

    def note(checks):
        for k, v in checks.err.items():
            errs[k] = max(errs.get(k, 0), v)

    c3 = motif_census(g12, 3)
    small = [("tc", make_tc_app(), expected12["tc"], None),
             ("4-cf", make_cf_app(4), expected12["4-cf"], None),
             ("3-mc", make_mc_app(3), sum(c3), c3)]
    for name, app, count, p_map in small:
        m = int(Miner(g12, app).init_edges()[0].shape[0])
        size = -(-m // 6)
        for backend in ("cuda", "cuda-1p"):
            checks = mc_checked(g12, [(name, app, count, p_map)],
                                f"blocks rmat12 {name} {backend}",
                                pack_max_bytes=0, backend=backend,
                                run_kw={"block_size": size})
            log(f"[blocks] rmat12 {name} {backend}: "
                f"{len(make_blocks(m, size))} blocks of {size}, plans "
                f"{checks.plans[name]}")
            note(checks)

    # a run killed after block 1 and resumed from its checkpoint
    size = -(-int(Miner(g12, make_mc_app(3)).init_edges()[0].shape[0]) // 6)
    saved = []

    def kill_after_1(block, _levels, payload):
        saved.append(dict(payload))
        if block == 1:
            raise _Killed

    try:
        Miner(g12, make_mc_app(3)).run(block_size=size,
                                       checkpoint_cb=kill_after_1)
    except _Killed:
        pass
    else:
        raise AssertionError("the checkpoint callback did not stop the run")
    resumed = Miner(g12, make_mc_app(3)).run(block_size=size,
                                             resume_from=saved[-1])
    got = (resumed.count, [int(x) for x in resumed.p_map])
    log(f"[blocks] rmat12 3-mc: killed after block {saved[-1]['block']} at "
        f"count {saved[-1]['count']}, resumed to {got}")
    if got != (sum(c3), c3):
        raise AssertionError(f"resumed 3-mc {got} != census {c3}")
    torch.cuda.empty_cache()

    # the out-of-core row: RMAT-16 relabeled under the core pack, estimated
    # unblocked, then blocked at a quarter of its analytic peak
    g16 = rmat(16, 16, seed=0)
    core = dict(relabel=True, pack_max_bytes=MIXED_BUDGET16)
    for name, app in (("tc", make_tc_app()), ("4-cf", make_cf_app(4))):
        for backend in ("cuda", "cuda-1p"):
            label = f"oocore {name} {backend}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            full = Miner(g16, app, backend=backend, **core)
            count_un = full.run(plan_source="estimate").count
            peak_un, mem_un = (full.peak_live_bytes(),
                               torch.cuda.max_memory_allocated())
            del full
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            miner = Miner(g16, app, backend=backend, **core)
            budget = max(peak_un // 4, 4096)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = miner.run(block_bytes=budget, plan_source="estimate")
            torch.cuda.synchronize()
            t_cold = time.perf_counter() - t0
            q_cold = miner.block_queue
            size = min(miner._executors)
            t0 = time.perf_counter()
            warm = miner.run(block_size=size)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            mem_blk, peak_blk = (torch.cuda.max_memory_allocated(),
                                 miner.peak_live_bytes())
            got, instances = dict(ops.LAUNCHES), dict(ops.INSTANCE_LAUNCHES)
            plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
            q = miner.block_queue
            log(f"[blocks] {label}: unblocked {count_un}, peak_live_bytes "
                f"{peak_un}, max_memory_allocated {mem_un}; blocked at "
                f"block_bytes {budget}: {len(q_cold)} blocks of {size}, "
                f"cold {cold.count} in {t_cold:.3f} s (stage_s "
                f"{q_cold.stage_s:.4f}, mine_s {q_cold.mine_s:.4f}), warm "
                f"{warm.count} in {t_warm:.3f} s (stage_s {q.stage_s:.4f}, "
                f"mine_s {q.mine_s:.4f}), plans {plans_of(miner)}, "
                f"peak_live_bytes {peak_blk}, max_memory_allocated "
                f"{mem_blk}, pack_hit_rate {miner.pack_hit_rate():.4f}, "
                f"launches {got}, modes {ops.mode_launches()}, plain calls "
                f"{plain}")
            if {count_un, cold.count, warm.count} != {expected[name]}:
                raise AssertionError(f"{label}: counts {count_un} "
                                     f"{cold.count} {warm.count} != scipy "
                                     f"{expected[name]}")
            if not peak_blk < peak_un or plain or len(q_cold) < 2:
                raise AssertionError(f"{label}: peak_live_bytes {peak_blk} "
                                     f"vs {peak_un}, plain {plain}, "
                                     f"{len(q_cold)} blocks")
            check_plans(label, plans_of(miner), ("estimated", "grown"))
            note_launches(launches, got, instances, pack="core")
            del miner, cold, warm
    torch.cuda.empty_cache()

    # 3-MC on RMAT-16: 2.48 G level-2 candidates in blocks at 16 GiB
    census = wedge_census(g16, triangles16)
    app = make_mc_app(3)
    for backend in ("cuda", "cuda-1p"):
        label = f"3-mc rmat16 {backend}"
        miner = Miner(g16, app, backend=backend)
        m = int(miner.init_edges()[0].shape[0])
        caps, _ = estimate_plan(miner, bucket_pow2(m))
        size = auto_block_size(m, caps, (), MC16_BLOCK_BYTES)
        (seed,), _ = clip_caps(*scale_caps(
            caps, (), bucket_pow2(size) / bucket_pow2(m)))
        per = block_candidates(miner, size)
        log(f"[blocks] {label}: worklist {m}, {sum(per)} level-2 "
            f"candidates; full plan (estimated) {list(caps)}; block_bytes "
            f"{MC16_BLOCK_BYTES}: {len(per)} blocks of {size}, candidates "
            f"a block {per}; largest {max(per)} (block {int(np.argmax(per))})"
            f" beside the seeded cand_cap {seed[0]} and 2^30 = {MAX_SLOTS}, "
            f"mean {sum(per) // len(per)}")
        del miner
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        miner = Miner(g16, app, backend=backend)
        times, results = {}, {}
        for run, kw in (("cold", {"block_bytes": MC16_BLOCK_BYTES,
                                  "plan_source": "estimate"}),
                        ("warm", {"block_size": size})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[run] = miner.run(**kw)
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
        got, instances = dict(ops.LAUNCHES), dict(ops.INSTANCE_LAUNCHES)
        plain = sum(fn.calls for fn in ops.PLAIN_VERSIONS)
        plans = plans_of(miner)
        (cap0, final, _, source, replans), = plans
        q = miner.block_queue
        kernel = PRUNED_PATH[backend][-1]
        log(f"[blocks] {label}: cold "
            f"{[results['cold'].count, *results['cold'].p_map.tolist()]} in "
            f"{times['cold']:.3f} s, warm "
            f"{[results['warm'].count, *results['warm'].p_map.tolist()]} in "
            f"{times['warm']:.3f} s, {len(q)} blocks of cap0 {cap0}, seeded "
            f"then final plan {final} ({source}), replans {replans}, stage_s "
            f"{q.stage_s:.4f}, mine_s {q.mine_s:.4f}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}, launches {got}, plain "
            f"calls {plain}")
        for run, r in results.items():
            if (r.count, r.p_map.tolist()) != (sum(census), census):
                raise AssertionError(f"{label} {run}: {r.count} "
                                     f"{r.p_map.tolist()} != census "
                                     f"{census}")
        if plain or got[kernel] < 2 * len(q) or max(per) > final[0][0] \
                or final[0][0] > MAX_SLOTS or len(q) != len(per):
            raise AssertionError(f"{label}: plain {plain}, launches {got}, "
                                 f"largest block {max(per)} vs cand_cap "
                                 f"{final[0][0]}")
        check_plans(label, plans, ("estimated", "grown"))
        note_launches(launches, got, instances)
        del miner, results
        torch.cuda.empty_cache()
    del g16
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# Multi-device mining: mine_sharded over a process group


def plain_calls() -> int:
    """Calls of every plain version of the mining kernels so far."""
    from repro_torch.kernels.extend_fused import ops
    return sum(fn.calls for fn in ops.PLAIN_VERSIONS)


def sharded_result(result) -> tuple:
    """A ``mine_sharded`` result as plain lists, to compare and print:
    (count, p_map) of a vertex app, (count, codes, supports) of FSM; the
    overflow flag dropped."""
    return tuple(x.tolist() if hasattr(x, "tolist") else x
                 for x in result[:-1])


def miner_result(miner, result) -> tuple:
    """A ``Miner.run`` result in :func:`sharded_result`'s form."""
    if miner.app.kind == "edge":
        return result.count, result.codes.tolist(), result.supports.tolist()
    p_map = (result.p_map if result.p_map is not None
             else [0] * miner.app.max_patterns)
    return result.count, [int(x) for x in p_map]


def single_card_plan(graph, app, backend: str) -> tuple:
    """Cold (inspected) then warm ``Miner.run`` on one device: (the warm
    result in :func:`sharded_result`'s form, the plan's caps, filter caps
    and level-0 worklist size, the warm run's seconds)."""
    import torch
    from repro_torch.core import Miner

    on_card = graph.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    miner = Miner(graph, app, backend=backend, device=graph.device)
    cold = miner_result(miner, miner.run())
    sync()
    t0 = time.perf_counter()
    warm = miner.run()
    sync()
    warm_s = time.perf_counter() - t0
    warm = miner_result(miner, warm)
    if cold != warm:
        raise AssertionError(f"cold {cold} != warm {warm}")
    (ex,) = miner._executors.values()
    m = (miner.ctx.n_uedges if app.kind == "edge"
         else int(miner.init_edges()[0].shape[0]))
    plan = (tuple(ex.plan.caps), tuple(ex.plan.filter_caps), m)
    del miner
    return warm, plan, warm_s


def sharded_checked(group, graph, app, caps, filter_caps, backend: str,
                    names, label: str, chunk: int = 1 << 25):
    """``mine_sharded`` on ``group`` with every launch of the kernels
    ``names`` held against its plain version; returns (the result, the
    checks)."""
    from repro_torch.core import mine_sharded

    checks = KernelChecks(chunk, names)
    with checks:
        result = mine_sharded(graph, app, caps, group=group, backend=backend,
                              filter_caps=filter_caps, device=graph.device)
    checks.report(label)
    if min(checks.launches.values()) < 1:
        raise AssertionError(f"{label}: a kernel was never checked")
    if result[-1]:
        raise AssertionError(f"{label}: overflowed at the single-card caps")
    return result, checks


def sharded_counted(group, graph, app, caps, filter_caps, backend: str,
                    path, label: str) -> tuple:
    """``mine_sharded`` on ``group`` with the launches counted (set to 0
    just before, read just after) and its ``shard.mine`` and
    ``shard.merge`` spans traced with the card synchronised at their ends:
    (the result, the launches, the instantiations, wall, mine and merge
    seconds).  Every kernel of ``path`` must launch, no other and no plain
    version."""
    import torch
    from repro_torch.core import mine_sharded
    from repro_torch.kernels.extend_fused import ops
    from repro_torch.obs import trace

    torch.cuda.synchronize()
    ops.reset_counts()
    tracer = trace.enable(sync=True)
    try:
        t0 = time.perf_counter()
        result = mine_sharded(graph, app, caps, group=group, backend=backend,
                              filter_caps=filter_caps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trace.disable()
    got = {k: n for k, n in ops.LAUNCHES.items() if n}
    instances = dict(ops.INSTANCE_LAUNCHES)
    plain = plain_calls()
    spans = {e["name"]: e["dur"] / 1e6 for e in tracer.events}
    if plain or set(got) != set(path) or result[-1]:
        raise AssertionError(f"{label}: launches {got} (path {path}), plain "
                             f"calls {plain}, overflow {result[-1]}")
    return (result, got, instances, wall, spans["shard.mine"],
            spans["shard.merge"])


def packed_reduce_sync_free(group, graph, app, backend: str) -> None:
    """The FSM reduce of ``mine_sharded`` on ``group`` (one rank), packed,
    on the last level of a cold ``Miner.run``: the whole
    ``reduce_domain_sharded(packed=True)`` call, its collectives included,
    with every device sync an error.  Its codes and supports must equal
    the dense path's."""
    import torch
    from repro_torch.core import Miner
    from repro_torch.core.phases import reference as R

    miner = Miner(graph, app, backend=backend, device=graph.device)
    levels = miner.run().levels
    ctx, app = miner.ctx, miner.ops.app
    want = R.reduce_domain_sharded(ctx, app, levels, group, packed=False)
    got = sync_free(lambda: R.reduce_domain_sharded(ctx, app, levels, group,
                                                    packed=True))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the packed FSM reduce differs from the dense")
    log(f"[sharded] world 1 3-fsm packed reduce: no device sync in the whole "
        f"reduce_domain_sharded(packed=True) call, its collectives included;"
        f" codes and supports equal to the dense path's on "
        f"{int(levels[-1].n)} embeddings")
    del miner, levels, got, want


def shared_card_rank(rank: int, group, device, jobs) -> list:
    """One rank of the four that share the card: each job ``(label, graph
    args, app args, caps, filter caps, backend)`` mined once with
    ``mine_sharded`` at its first caps, every launch held against its
    plain version (pieces of ``SHARED_CHUNK`` slots, so that four ranks'
    plain temporaries fit beside their outputs), then counted: mined with
    its caps doubled while any rank overflows.  Gathers every rank's
    per-job record (result, rounds, final caps, launches, plain calls,
    peak bytes, wall seconds, the checked launches and their largest
    errors) to every rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (make_cf_app, make_fsm_app, make_tc_app,
                                  mine_sharded)
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.extend_fused import ops

    apps = {"tc": make_tc_app, "4-cf": lambda: make_cf_app(4),
            "3-fsm": lambda ms: make_fsm_app(3, ms, max_patterns=64)}
    on_card = device.type == "cuda"
    out = {}
    for label, gargs, (aname, *aargs), caps, fcaps, backend in jobs:
        graph = rmat(*gargs[:2], seed=gargs[2], labels=gargs[3],
                     device=device)
        app = apps[aname](*aargs)
        names = (tuple(EDGE_REPLACES) if app.kind == "edge"
                 else PRUNED_PATH[backend])
        checks = KernelChecks(SHARED_CHUNK, names)
        with checks:
            mine_sharded(graph, app, caps, group=group, backend=backend,
                         filter_caps=fcaps, device=device)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        ops.reset_counts()
        dist.barrier(group)
        t0 = time.perf_counter()
        rounds = 0
        while True:
            rounds += 1
            result = mine_sharded(graph, app, caps, group=group,
                                  backend=backend, filter_caps=fcaps,
                                  device=device)
            if not result[-1]:
                break
            caps = tuple((2 * c, 2 * o) for c, o in caps)
            fcaps = None if fcaps is None else tuple(2 * f for f in fcaps)
        if on_card:
            torch.cuda.synchronize(device)
        out[label] = {
            "result": sharded_result(result), "rounds": rounds,
            "caps": [list(caps), list(fcaps or ())],
            "launches": {k: n for k, n in ops.LAUNCHES.items() if n},
            "plain": plain_calls(),
            "peak": (torch.cuda.max_memory_allocated(device) if on_card
                     else 0),
            "wall": time.perf_counter() - t0,
            "checked": dict(checks.launches), "err": dict(checks.err)}
        del graph, checks
    ranks = [None] * dist.get_world_size(group)
    dist.all_gather_object(ranks, out, group=group)
    return ranks


SHARDED_WORLD = 4                # ranks that share the card
SHARED_CHUNK = 1 << 24           # their checks' plain pieces, in slots


def sharded_phase(expected: dict, want15: list, launches: dict) -> dict:
    """The [sharded] phase: ``mine_sharded`` over a process group.  World
    size 1 over ``nccl`` in this process: RMAT-16 TC and 4-CF on ``cuda``
    and ``cuda-1p`` and 3-FSM on ``rmat(15, 8, seed=0, labels=4)`` at
    2500, at the single-card inspected plan's caps, every launch checked,
    then counted, each answer against ``Miner.run``'s and scipy's; then
    four ``gloo`` ranks sharing the card mine RMAT-16 TC and the RMAT-15
    3-FSM from the single-card caps scaled to their block (safety 2), a
    first round with every launch checked, then counted with the caps
    doubled while any rank overflows, each answer against world size 1's.
    Returns the checks' largest errors by kernel."""
    import tempfile

    import torch
    from repro_torch.core import make_cf_app, make_fsm_app, make_tc_app
    from repro_torch.core.blocks import scale_caps
    from repro_torch.core.plan import bucket_pow2
    from repro_torch.graph.generators import rmat
    from repro_torch.launch import mesh

    errs: dict = {}
    g16 = rmat(16, 16, seed=0)
    g15l = rmat(15, 8, seed=0, labels=4)
    fsm = make_fsm_app(3, FSM_SUPPORT, max_patterns=64)
    runs = [("tc", g16, make_tc_app(), "cuda"),
            ("tc", g16, make_tc_app(), "cuda-1p"),
            ("4-cf", g16, make_cf_app(4), "cuda"),
            ("4-cf", g16, make_cf_app(4), "cuda-1p"),
            ("3-fsm", g15l, fsm, "cuda")]
    world1: dict = {}
    plans: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        group, _ = mesh.init_group(str(Path(tmp) / "store"), 0, 1, "nccl")
        try:
            for name, graph, app, backend in runs:
                label = f"sharded world 1 {name} {backend}"
                torch.cuda.empty_cache()
                want, plans[name], warm_s = single_card_plan(graph, app,
                                                             backend)
                caps, fcaps, _ = plans[name]
                fc = fcaps if app.kind == "edge" else None
                edge = app.kind == "edge"
                names = (tuple(EDGE_REPLACES) if edge
                         else PRUNED_PATH[backend])
                result, checks = sharded_checked(group, graph, app, caps, fc,
                                                 backend, names, label)
                for k, v in checks.err.items():
                    errs[k] = max(errs.get(k, 0), v)
                del checks
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                result, got, instances, wall, mine_s, merge_s = \
                    sharded_counted(group, graph, app, caps, fc, backend,
                                    names, label)
                got_r = sharded_result(result)
                truth = ((FSM_FREQUENT, want15) if edge
                         else expected[name])
                log(f"[sharded] world 1 nccl {name} {backend}: "
                    f"{got_r[0]}{' patterns' if edge else ''}, caps "
                    f"{list(caps)}{f' filter caps {list(fc)}' if edge else ''}"
                    f", wall {wall:.4f} s (shard.mine {mine_s:.4f} s, "
                    f"shard.merge {merge_s:.6f} s) beside Miner.run warm "
                    f"{warm_s:.4f} s, peak {torch.cuda.max_memory_allocated()} "
                    f"B, launches {got}, plain calls 0")
                if got_r != want:
                    raise AssertionError(f"{label}: {got_r[0]} != Miner.run "
                                         f"{want[0]}")
                if edge:
                    sup = sorted(s for c, s in zip(got_r[1], got_r[2])
                                 if s >= FSM_SUPPORT and c != 2**31 - 1)
                    if (got_r[0], sup) != truth:
                        raise AssertionError(f"{label}: {got_r[0]} patterns, "
                                             f"supports {sup} != scipy "
                                             f"{truth}")
                elif got_r[0] != truth:
                    raise AssertionError(f"{label}: {got_r[0]} != scipy "
                                         f"{truth}")
                world1[name] = got_r
                note_launches(launches, got, instances)
                del result
                if edge:
                    packed_reduce_sync_free(group, graph, app, backend)
        finally:
            mesh.close_group()
    del g16, g15l
    torch.cuda.empty_cache()

    # four gloo ranks sharing the card, each from the single-card plan
    # scaled to its block (safety 2)
    jobs = []
    for name, gargs, aargs in (("tc", (16, 16, 0, None), ("tc",)),
                               ("3-fsm", (15, 8, 0, 4),
                                ("3-fsm", FSM_SUPPORT))):
        caps, fcaps, m = plans[name]
        ratio = 2 * bucket_pow2(-(-m // SHARDED_WORLD)) / bucket_pow2(m)
        caps, fcaps = scale_caps(caps, fcaps, ratio)
        jobs.append((name, gargs, aargs, caps,
                     fcaps if name == "3-fsm" else None, "cuda"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn(shared_card_rank, SHARDED_WORLD, backend="gloo",
                       device="cuda", args=(jobs,))
    wall = time.perf_counter() - t0
    for name, *_ in jobs:
        per = [r[name] for r in ranks]
        for i, rec in enumerate(per):
            log(f"[check] {SHARDED_WORLD} ranks gloo {name} rank {i}: "
                f"launches {rec['checked']}, max_abs_err {rec['err']}")
            if min(rec["checked"].values()) < 1:
                raise AssertionError(f"{SHARDED_WORLD} ranks {name} rank {i}:"
                                     " a kernel was never checked")
            for k, v in rec["err"].items():
                errs[k] = max(errs.get(k, 0), v)
            log(f"[sharded] {SHARDED_WORLD} ranks gloo {name} rank {i}: "
                f"{rec['result'][0]}, rounds {rec['rounds']}, final caps "
                f"{rec['caps']}, launches {rec['launches']}, plain calls "
                f"{rec['plain']}, max_memory_allocated {rec['peak']} B, "
                f"wall {rec['wall']:.4f} s")
        log(f"[sharded] {SHARDED_WORLD} ranks gloo {name}: peaks sum "
            f"{sum(r['peak'] for r in per)} B, transport gloo over cuda:0 "
            f"(host copies of the merges)")
        for rec in per:
            if rec["result"] != world1[name]:
                raise AssertionError(f"{SHARDED_WORLD} ranks {name}: "
                                     f"{rec['result'][0]} != world 1 "
                                     f"{world1[name][0]}")
            if rec["plain"] or not rec["launches"]:
                raise AssertionError(f"{SHARDED_WORLD} ranks {name}: "
                                     f"launches {rec['launches']}, plain "
                                     f"{rec['plain']}")
    log(f"[sharded] {SHARDED_WORLD} ranks sharing the card: wall {wall:.1f} s "
        "with the spawn")
    return errs


# ---------------------------------------------------------------------------
# The mining CLI and mining as a service


def cli_checked(argv: list, out_dir: Path, label: str):
    """``repro_torch.launch.mine.main(argv)`` in this process with
    ``--trace`` and ``--metrics`` into ``out_dir``, both files checked by
    the port's validator; returns the result."""
    from repro_torch.launch import mine
    from repro_torch.obs import metrics, trace, validate

    out_dir.mkdir(parents=True, exist_ok=True)
    tpath, mpath = out_dir / f"{label}.trace.json", out_dir / f"{label}.json"
    metrics.reset()
    try:
        r = mine.main([*argv, "--trace", str(tpath), "--metrics",
                       str(mpath)])
    finally:
        trace.disable()
    info = (validate.validate_trace(json.loads(tpath.read_text())),
            validate.validate_metrics(json.loads(mpath.read_text())))
    log(f"[cli] {label}: trace {info[0]}, metrics {info[1]}")
    return r


def cli_calls(spec: str, want: dict, out_dir: Path | None) -> None:
    """The [cli] phase's calls: ``repro_torch.launch.mine.main`` with
    ``--app tc`` and ``--app 4-cf`` (traced into ``out_dir`` and validated,
    where it is given) and ``--fused-tc``, then ``serve --mine`` answering
    ``tc,4-cf``; every count against ``want``."""
    import torch
    from repro_torch.launch import mine, serve
    from repro_torch.obs import metrics

    for name in ("tc", "4-cf"):
        torch.cuda.empty_cache()
        argv = ["--graph", spec, "--app", name]
        r = (cli_checked(argv, out_dir, name) if out_dir
             else mine.main(argv))
        if r.count != want[name]:
            raise AssertionError(f"cli {name}: {r.count} != scipy "
                                 f"{want[name]}")
    r = mine.main(["--graph", spec, "--fused-tc"])
    if r.count != want["tc"]:
        raise AssertionError(f"cli fused-tc: {r.count} != {want['tc']}")
    metrics.reset()
    results = serve.main(["--mine", "--graph", spec, "--queries", "tc,4-cf"])
    for res in results:
        if res["result"].count != want[res["query"]]:
            raise AssertionError(f"serve {res['query']}: "
                                 f"{res['result'].count} != "
                                 f"{want[res['query']]}")


def cli_phase(launches: dict) -> dict:
    """The [cli] phase: ``python -m repro_torch.launch.mine`` in this
    process on the card, ``--graph rmat:16`` (edge factor 8) with ``--app
    tc`` and ``--app 4-cf`` traced, both exports validated, and
    ``--fused-tc``; then ``serve --mine`` answering ``tc,4-cf``; every
    count against scipy.  The calls run twice: first with every launch
    held against its plain version, then with the launches counted (no
    plain call).  Then a warm replay under tracing (sync off) shown free
    of device syncs up to its final read, and a traced warm ``Miner.run``
    that records no level span and no op span.  Returns the checks'
    largest errors by kernel."""
    import torch
    from repro_torch.core import Miner, make_tc_app
    from repro_torch.kernels.extend_fused import ops
    from repro_torch.kernels.intersect import ops as intersect_ops
    from repro_torch.kernels.intersect import ref as intersect_ref
    from repro_torch.launch.mine import load_graph
    from repro_torch.obs import trace

    spec = "rmat:16"
    graph = load_graph(spec)
    t0 = time.perf_counter()
    want = dict(zip(("tc", "4-cf"), scipy_counts(graph)))
    log(f"[scipy] {spec} (edge factor 8): triangles {want['tc']}, "
        f"4-cliques {want['4-cf']} ({time.perf_counter() - t0:.1f} s)")
    names = (*REPLACES, *INTERSECT_REPLACES)
    checks = KernelChecks(names=names)
    with checks:
        cli_calls(spec, want, None)
    checks.report("cli")
    if min(checks.launches.values()) < 1:
        raise AssertionError("cli: a kernel was never checked")
    ops.reset_counts()
    intersect_ops.reset_counts()
    with counting_k3_shapes():
        cli_calls(spec, want, ROOT / "build" / "cli")
    got = {k: n for k, n in ops.LAUNCHES.items() if n}
    got["intersect_count"] = intersect_ops.LAUNCHES["intersect_count"]
    plain = plain_calls() + intersect_ref.intersect_count_ref.calls
    log(f"[cli] launches {got}, plain calls {plain}")
    if plain or min(got.get(k, 0) for k in names) < 1:
        raise AssertionError(f"cli: launches {got}, plain calls {plain}")
    note_launches(launches, got, dict(ops.INSTANCE_LAUNCHES))

    # a warm replay under tracing, sync off: no device sync before its
    # final read; then a traced warm run records no level and no op span
    torch.cuda.empty_cache()
    miner = Miner(graph, make_tc_app())
    miner.run()
    tracer = trace.enable()
    try:
        replay_without_sync(miner, want["tc"], f"cli {spec} tc traced")
        count = miner.run().count
    finally:
        trace.disable()
    names = sorted({e["name"] for e in tracer.events})
    log(f"[cli] traced warm run: {count}, events {names}")
    if count != want["tc"] or "miner.run" not in names or not set(
            names) <= {"miner.run", "executor.compile", "executor.replay"}:
        raise AssertionError(f"cli traced warm run: {count}, events {names}")
    del miner, graph
    torch.cuda.empty_cache()
    return checks.err


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
               chunk: int = 1 << 25, label: str = "lm") -> "KernelChecks":
    """The request ``sets`` through ``serve_lm`` (at the arch's full width
    unless ``smoke``) with every ``flash_attention`` launch held against
    its plain version; keeps each set's first launch (its layer 0) in
    ``layer0`` by set, for timing."""
    import torch
    from repro_torch.launch.serve import serve_lm

    checks = KernelChecks(chunk, names=tuple(FLASH_REPLACES))
    checks.layer0 = {}
    with checks:
        for name, (batch, prompt, gen) in sets.items():
            checks.keep = True
            t0 = time.perf_counter()
            serve_lm(arch, smoke, batch, prompt, gen, seed=0, device=device)
            checks.layer0[name] = checks.kept.pop("flash_attention")
            log(f"[check] {label} set {name}: served with every launch "
                f"checked in {time.perf_counter() - t0:.1f} s")
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    checks.report(label)
    cfg = arch.smoke if smoke else arch.config
    want = cfg.n_layers * len(sets)
    if checks.launches["flash_attention"] != want:
        raise AssertionError(f"{label}: {checks.launches} checked launches, "
                             f"not {want}")
    return checks


# the kernel variant a flash_attention launch of each dtype must run
FLASH_VARIANTS = {"bfloat16": "tensor_core", "float32": "fma"}


def time_flash(a, kw, plain: bool = True) -> dict:
    """CUDA-event times of the kernel, its plain version (unless ``plain``
    is False) and ``scaled_dot_product_attention`` on one launch's
    arguments, the kernel's output held against the plain version's (at
    the checks' tolerance), the variant the timed launches ran, and the
    bound: the larger of the flops at the rate of the variant's pipes
    (bf16 on the tensor cores, f32 on the FMA pipes) and the bytes at the
    memory rate.  The flops are 4 d per (query, key) pair: the tensor-core
    variant's extra product for the split P (P_lo V) is not counted as
    work."""
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
        torch.testing.assert_close(got, want, **(
            {} if q.dtype == torch.bfloat16 else dict(atol=2e-5, rtol=0)))
        plain_msg = (f"plain {plain_ms:.3f} ms; scaled_dot_product_attention "
                     f"max_abs_err {lib_err:.3g} against the plain version")
        del want
    del got, lib
    flops = 4 * b * hq * d * attention_pairs(lq, lk, kw.get("causal", True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = (BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
            else F32_FLOPS_PER_S)
    bound_s = {"operations": flops / rate, "bytes": nbytes / HBM_BYTES_PER_S}
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


def lm_main(arch, label: str, phase: str = "lm") -> int:
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
    log(f"[main] {phase} set {label} (batch {batch}, prompt {prompt}, {gen} "
        f"new tokens): prefill {stats['prefill_s']:.3f} s, decode "
        f"{stats['decode_tokens']} tokens in {stats['decode_s']:.3f} s "
        f"({rate:.1f} tokens/s), peak {peak} B, launches {launches} "
        f"{variants}, plain calls {plain}, first tokens "
        f"{tokens[0, :8].tolist()}")
    vocab = arch.config.vocab
    if tuple(tokens.shape) != (batch, gen) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        raise AssertionError(f"{phase} set {label}: tokens "
                             f"{tuple(tokens.shape)} outside [0, {vocab})")
    n_layers = arch.config.n_layers
    if launches != n_layers or plain or variants != {"tensor_core": n_layers,
                                                     "fma": 0}:
        raise AssertionError(f"{phase} set {label}: {launches} launches "
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


def f32_config(arch, n_layers: int | None = None):
    """The arch's full-width config in f32, cut to its first ``n_layers``
    layers when given."""
    cut = {} if n_layers is None else {"n_layers": n_layers}
    return dataclasses.replace(arch.config, dtype="float32", **cut)


@contextlib.contextmanager
def recorded_routes():
    """While active, each ``moe.route`` call's top-k experts ([T, K]) are
    appended to the list this yields."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def recording(*a, **kw):
        r = route(*a, **kw)
        calls.append(r.expert.clone())
        return r

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def route_flips(a: list, b: list) -> int:
    """(token, layer) top-k expert sets that differ between two runs' route
    calls, call by call; a call of another shape, or one only one run made,
    counts all its tokens (the larger count)."""
    flips = 0
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        if x is None or y is None or x.shape != y.shape:
            flips += max(t.shape[0] for t in (x, y) if t is not None)
            continue
        x, y = x.sort(-1).values, y.sort(-1).values
        flips += int((x != y).any(-1).sum())
    return flips


def lm_f32_end_to_end(arch, prompt_len: int = 512, gen: int = 8,
                      n_layers: int | None = None,
                      timed: bool = True) -> None:
    """The full-width model in f32 (TF32 off), its first ``n_layers``
    layers when given: prefill on the kernel against prefill on the plain
    attention, last-token logits within 1e-3, and the same greedy tokens
    from ``serve_lm``.  A MoE model also counts the router flips, the
    (token, layer) expert sets that differ between the two runs: a near-tie
    in the router turns on attention differences of 1e-6, so a mismatch
    fails the check only where no route flipped."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as T

    cfg = f32_config(arch, n_layers)
    arch32 = dataclasses.replace(arch, config=cfg)
    if n_layers is not None:
        log(f"[main] lm f32 {arch.arch_id}: the first {n_layers} of "
            f"{arch.config.n_layers} layers, full width")
    g = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    prompt = torch.randint(0, cfg.vocab, (1, prompt_len), generator=g,
                           device="cuda", dtype=torch.int32)
    kernel = ops.flash_attention
    layer0 = []

    def keeping(*a, **kw):                  # keeps the first launch's args
        if not layer0:
            layer0.append((a, kw))
        return kernel(*a, **kw)

    runs = {}
    ops.reset_counts()
    for name, attention in (("kernel", keeping), ("plain", ref.attention_ref)):
        ops.flash_attention = attention
        try:
            with recorded_routes() as routes:
                logits, _ = T.prefill(cfg, params, prompt)
                tokens = serve_lm(arch32, False, 1, prompt_len, gen, seed=0,
                                  prompt=prompt)
        finally:
            ops.flash_attention = kernel
        runs[name] = (logits, tokens, routes)
    err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    same = torch.equal(runs["kernel"][1], runs["plain"][1])
    flips = route_flips(runs["kernel"][2], runs["plain"][2])
    log(f"[main] lm f32 (TF32 off), prompt {prompt_len}: last-token logits "
        f"differ by {err:.3g} (logits range "
        f"{float(runs['plain'][0].abs().max()):.3g}), {gen} greedy tokens "
        f"equal: {same} {runs['kernel'][1][0].tolist()}, router flips "
        f"{flips} of {sum(r.shape[0] for r in runs['plain'][2])} (token, "
        f"layer) routes, kernel launches {ops.VARIANT_LAUNCHES}")
    if flips == 0 and (not err <= 1e-3 or not same):
        raise AssertionError("lm f32: the kernel's prefill differs from the "
                             "plain attention's")
    # the kernel's run: one launch a layer in T.prefill and in serve_lm
    if ops.VARIANT_LAUNCHES != {"tensor_core": 0, "fma": 2 * cfg.n_layers}:
        raise AssertionError(f"lm f32: kernel launches "
                             f"{ops.VARIANT_LAUNCHES}, not the FMA variant "
                             f"once a layer a prefill")
    del params, runs
    torch.cuda.empty_cache()
    if timed:
        # the f32 variant timed on layer 0's launch of the prefill
        (a, kw), = layer0
        log(f"[timing] lm f32 prompt {prompt_len}, layer 0 "
            f"({nvidia_smi_line()}):")
        time_flash(a, kw)
        del a, kw
    del layer0


# ---------------------------------------------------------------------------
# MoE LM serving: DeepSeek-MoE-16B through serve_lm on the flash kernel

MOE_ARCH = "deepseek-moe-16b"
MOE_FLASH_ROW = "flash_attention:group1"    # K8 on Hq = Hkv (group 1)
MOE_F32_LAYERS = 4             # the f32 check's cut of the 28 layers
MOE_LAYER_TOKENS = 512         # the card-against-CPU MoE layer's tokens


@contextlib.contextmanager
def first_moe_input(n_tokens: int):
    """While active, the first ``apply_moe`` call's first ``n_tokens``
    tokens and its layer's weights are copied into the dict this yields
    (``x``, ``params``)."""
    from repro_torch.models import moe

    apply, kept = moe.apply_moe, {}

    def keeping(params, x, cfg):
        if not kept:
            kept["x"] = x[:n_tokens].clone()
            kept["params"] = {k: v.clone() for k, v in params.items()}
        return apply(params, x, cfg)

    moe.apply_moe = keeping
    try:
        yield kept
    finally:
        moe.apply_moe = apply


def dispatch_diff(a, b) -> list[str]:
    """The fields of two ``moe.Dispatch`` routings whose integers differ
    (expert, order, slot, keep, capacity)."""
    import torch
    diff = [name for name in ("expert", "order", "slot", "keep")
            if not torch.equal(getattr(a, name).cpu(),
                               getattr(b, name).cpu())]
    return diff + (["capacity"] if a.capacity != b.capacity else [])


def moe_layer_against_cpu(x, params, cfg) -> dict:
    """``apply_moe`` in f32 on x's device (under ``sync_free`` on the card)
    and on the CPU, on the same tokens and weights: the dispatch integers
    must be equal and y within 1e-4.  Returns the errors and the
    routing's capacity and dropped assignments."""
    import torch
    from repro_torch.models import moe

    x32 = x.float()
    p32 = {k: v.float() for k, v in params.items()}

    def run():
        return moe.route(p32, x32, cfg), moe.apply_moe(p32, x32, cfg)

    r, (y, aux) = sync_free(run) if x.is_cuda else run()
    x_cpu = x32.cpu()
    p_cpu = {k: v.cpu() for k, v in p32.items()}
    r_cpu = moe.route(p_cpu, x_cpu, cfg)
    y_cpu, aux_cpu = moe.apply_moe(p_cpu, x_cpu, cfg)
    diff = dispatch_diff(r, r_cpu)
    out = {"y_err": float((y.cpu() - y_cpu).abs().max()),
           "aux_err": abs(float(aux) - float(aux_cpu)),
           "capacity": r.capacity,
           "dropped": int((~r_cpu.keep).sum()), "dispatch_diff": diff}
    log(f"[main] moe layer 0, {x.shape[0]} tokens, f32, {x.device.type} "
        f"against cpu: dispatch {'equal' if not diff else diff}, capacity "
        f"{out['capacity']}, dropped assignments {out['dropped']}, y within "
        f"{out['y_err']:.3g}, aux within {out['aux_err']:.3g}")
    if diff or not out["y_err"] <= 1e-4:
        raise AssertionError("moe: the card's layer differs from the CPU's")
    return out


def moe_phase() -> tuple[dict, int, float]:
    """The [moe] phase: DeepSeek-MoE-16B at full width in bf16 through
    ``serve_lm``, sets A and B with every K8 launch checked, K8 timed on
    set A's layer 0 (group 1), the counted sets, a profile of set A, one
    MoE layer on the card against the CPU, then the first four layers in
    f32.  Returns K8's group-1 timing row, the counted launches and the
    checks' largest error."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe

    arch = get_arch(MOE_ARCH)
    cfg = arch.config
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2   # K, V; bf16
    log(f"[moe] {MOE_ARCH}: {cfg.param_count()} parameters "
        f"({2 * cfg.param_count()} B in bf16), KV cache {kv} B a token, "
        f"capacity " + ", ".join(
            f"set {name} {moe.capacity(b * p, cfg.moe)}"
            for name, (b, p, _) in LM_SETS.items())
        + " slots an expert in prefill, "
        f"{moe.capacity(LM_SETS['A'][0], cfg.moe)} in set A's decode")
    with first_moe_input(MOE_LAYER_TOKENS) as kept:
        checks = lm_checked(arch, label="moe")
    a, kw = checks.layer0.pop("A")
    log(f"[timing] moe set A layer 0, Hq = Hkv = {cfg.n_heads} "
        f"({nvidia_smi_line()}):")
    row = time_flash(a, kw)
    del a, kw
    checks.layer0.clear()
    torch.cuda.empty_cache()
    launches = sum(lm_main(arch, label, phase="moe") for label in LM_SETS)
    profile_lm(arch)
    moe_layer_against_cpu(kept["x"], kept["params"], cfg.moe)
    kept.clear()
    torch.cuda.empty_cache()
    lm_f32_end_to_end(arch, n_layers=MOE_F32_LAYERS, timed=False)
    return row, launches, checks.err["flash_attention"]


# ---------------------------------------------------------------------------
# Recsys serving: DIEN through serve_recsys

RECSYS_CPU_CANDIDATES = 1 << 16     # retrieval scores checked on the CPU


def on_device(tree, dev):
    """A dict (of dicts and lists) of tensors, copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [on_device(v, dev) for v in tree]
    return tree.to(dev)


def on_cpu(tree):
    """A dict (of dicts and lists) of tensors, copied to the CPU."""
    return on_device(tree, "cpu")


def recsys_phase() -> None:
    """The [recsys] phase: DIEN's full config (10M-item table) in f32
    through ``serve_recsys`` at serve_p99's and serve_bulk's batches, three
    calls each, and ``score_candidates`` over retrieval_cand's 1,000,000
    candidates: wall times and peak memory; batch 512's scores against the
    CPU on the same weights and batch (1e-4), the retrieval scores of the
    first 65,536 candidates too; a profile of one batch-512 forward."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.launch.serve import serve_recsys
    from repro_torch.models.recsys import dien as DN

    arch = get_arch("dien")
    cfg, shapes = arch.config, arch.shapes
    params = DN.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    table = params["item_emb"].numel() * params["item_emb"].element_size()
    log(f"[recsys] dien: item table {tuple(params['item_emb'].shape)} f32 "
        f"({table} B), sequence {cfg.seq_len}, GRU {cfg.gru_dim}, MLP "
        f"{cfg.mlp}")
    cpu_params = on_cpu(params)
    for shape in ("serve_p99", "serve_bulk"):
        batch = shapes[shape]["batch"]
        data = recsys_batch(0, 0, batch, cfg.seq_len, cfg.n_items,
                            cfg.n_cats, device="cuda")
        for i in range(3):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            scores = serve_recsys(arch, False, batch, seed=0,
                                  batch_data=data, stats=stats)
            peak = torch.cuda.max_memory_allocated()
            log(f"[main] recsys {shape} call {i} (batch {batch}): "
                f"{stats['serve_s']:.4f} s, "
                f"{batch / stats['serve_s']:.0f} requests/s, peak {peak} B")
            if tuple(scores.shape) != (batch,) or \
                    not torch.isfinite(scores).all():
                raise AssertionError(f"recsys {shape}: scores "
                                     f"{tuple(scores.shape)}, not finite")
        if shape == "serve_p99":
            with torch.inference_mode():
                want = DN.forward(cfg, cpu_params, on_cpu(data))
            err = float((scores.cpu() - want).abs().max())
            log(f"[main] recsys serve_p99: the card's scores within "
                f"{err:.3g} of the CPU's on the same weights and batch "
                f"(scores range {float(want.abs().max()):.3g})")
            if not err <= 1e-4:
                raise AssertionError("recsys: the card's scores differ from "
                                     "the CPU's")
            profile_call(torch.inference_mode()(
                lambda: DN.forward(cfg, params, data)),
                "recsys serve_p99 forward")
        del data, scores
    n = shapes["retrieval_cand"]["n_candidates"]
    g = torch.Generator("cuda").manual_seed(1)
    hist = torch.randint(0, cfg.n_items, (1, cfg.seq_len), generator=g,
                         device="cuda", dtype=torch.int32)
    items = torch.randint(0, cfg.n_items, (n,), generator=g, device="cuda",
                          dtype=torch.int32)
    cand = {"hist_items": hist, "hist_cats": hist % cfg.n_cats,
            "cand_items": items, "cand_cats": items % cfg.n_cats}
    for i in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = DN.score_candidates(cfg, params, cand)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[main] recsys retrieval_cand call {i}: {n} candidates in "
            f"{secs:.4f} s, peak {torch.cuda.max_memory_allocated()} B")
    part = {k: (v if k.startswith("hist") else v[:RECSYS_CPU_CANDIDATES])
            for k, v in cand.items()}
    want = DN.score_candidates(cfg, cpu_params, on_cpu(part))
    err = float((scores[:RECSYS_CPU_CANDIDATES].cpu() - want).abs().max())
    log(f"[main] recsys retrieval_cand: the first {RECSYS_CPU_CANDIDATES} "
        f"scores within {err:.3g} of the CPU's")
    if tuple(scores.shape) != (n,) or not torch.isfinite(scores).all() or \
            not err <= 1e-4:
        raise AssertionError("recsys retrieval_cand: wrong scores")
    del params, cpu_params, cand, scores
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training: Qwen3-0.6B at full width through launch.train (K8 in the
# forward, attention_grad in the backward), the optimizer, checkpoints with
# resume, and DIEN's train cell

TRAIN_ARCH = "qwen3-0.6b"
# train_4k's sequence; the global batch cut from 256 to 16 (4 microbatches
# of 4), 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 4096, 3
# the checked run's steps: each step launches K8 at the same shapes, so one
# checked step covers them (three took 36 s of the script's 600)
TRAIN_CHECKED_STEPS = 1
TRAIN_F32_LAYERS = 2            # the card-against-CPU f32 step's depth
TRAIN_F32_TOKENS = 512          # its batch: 1 x 512
TRAIN_FLASH_ROW = "flash_attention:train"   # K8 on the training path
DIEN_TRAIN_STEPS = 2


def train_args(arch_id: str, steps: int, batch: int, seq: int,
               *extra: str) -> list[str]:
    """``launch.train``'s arguments: ``steps`` steps of ``batch`` x
    ``seq``, every step logged."""
    return ["--arch", arch_id, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--log-every", "1", *extra]


def train_launches(cfg, n_micro: int, steps: int) -> int:
    """K8 launches of ``steps`` train steps: one a layer a microbatch, and
    with remat one more, the recompute in the backward."""
    return cfg.n_layers * n_micro * steps * (1 + cfg.remat)


def train_checked(args: list[str], chunk: int = 1 << 25) -> "KernelChecks":
    """``launch.train.main(args)`` with every ``flash_attention`` launch
    held against its plain version; keeps the first launch's arguments."""
    from repro_torch.launch import train

    checks = KernelChecks(chunk, names=tuple(FLASH_REPLACES))
    checks.keep = True
    with checks:
        t0 = time.perf_counter()
        losses = train.main(args)
    log(f"[check] train {' '.join(args)}: {len(losses)} steps with every "
        f"launch checked in {time.perf_counter() - t0:.1f} s, losses "
        f"{[round(x, 4) for x in losses]}")
    checks.report("train")
    return checks


def train_main(arch_id: str, args: list[str]) -> tuple[list, int]:
    """The counted run: ``launch.train.main(args)`` with the counts set to
    0 just before; each step's loss, wall time, tokens/s and peak printed;
    the launches equal to ``train_launches``, all of the tensor-core
    variant, no plain call, every loss finite and the first within 1.0 of
    ln(vocab).  Returns the per-step records and the launches."""
    import math
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import steps as S
    from repro_torch.launch import train

    cell = S.build_cell(arch_id, "train_4k")
    reset_memory()
    stats: list = []
    ops.reset_counts()
    losses = train.main(args, stats=stats)
    launches = ops.LAUNCHES["flash_attention"]
    variants = dict(ops.VARIANT_LAUNCHES)
    plain = ref.attention_ref.calls
    smi = nvidia_smi_line()
    for s in stats:
        log(f"[main] train {arch_id} step {s['step']}: loss "
            f"{s['loss']:.4f}, {s['wall_s']:.3f} s, {s['rate']:.0f} "
            f"tokens/s, peak {s['peak_bytes']} B ({smi})")
    want = train_launches(cell.cfg, cell.n_micro, len(losses))
    log(f"[main] train {arch_id}: launches {launches} {variants} (want "
        f"{want}: {cell.cfg.n_layers} layers x {cell.n_micro} microbatches "
        f"x {len(losses)} steps x 2 with remat), plain calls {plain}")
    bound = math.log(cell.cfg.vocab)
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - bound) > 1.0:
        raise AssertionError(f"train {arch_id}: losses {losses}, the first "
                             f"not within 1.0 of ln(vocab) = {bound:.2f}")
    if launches != want or plain or variants != {"tensor_core": want,
                                                 "fma": 0}:
        raise AssertionError(f"train {arch_id}: {launches} launches "
                             f"{variants}, {plain} plain calls")
    return stats, launches


def reset_memory() -> None:
    """Free the allocator's cached blocks and restart its peak count."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def profile_train_microbatch(arch_id: str, batch: int, seq: int) -> None:
    """``profile_call`` over one microbatch's forward and backward of the
    train cell's loss (fresh weights, step 0's first microbatch), after the
    counted run has warmed the libraries up: a quarter of a step's device
    operations, which keeps the profiler's own cost in bounds."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch
    from repro_torch.models import transformer as T

    cell = S.build_cell(arch_id, "train_4k")
    params = cell.param_init(torch.Generator("cuda").manual_seed(0),
                             device="cuda")
    data = make_batch(get_arch(arch_id), cell.cfg, 0, batch, seq, 0,
                      n_micro=cell.n_micro, device="cuda")
    micro = {k: v[0] for k, v in data.items()}
    profile_call(lambda: S.loss_and_grads(
        lambda p, b: T.loss_fn(cell.cfg, p, b), params, micro),
        f"train {arch_id} microbatch forward and backward, "
        f"{batch // cell.n_micro} x {seq}")
    del params, data, micro
    torch.cuda.empty_cache()


def autograd_attention_ref(q, k, v, dout, causal: bool = True,
                           rows: int | None = None):
    """``torch.autograd.grad`` through ``attention_ref`` in f32, over
    pieces of ``rows`` query rows (all at once by default): each piece's
    output rows depend on its own query rows and every key, so its dq rows
    are its own and dk, dv sum over the pieces."""
    import torch
    from repro_torch.kernels.flash_attention import ref

    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    lq = q.shape[2]
    rows = rows or lq
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for lo in range(0, lq, rows):
        hi = min(lo + rows, lq)
        out = ref.attention_ref(qf, kf, vf, causal=causal, q_rows=(lo, hi))
        gq, gk, gv = torch.autograd.grad(
            out, (qf, kf, vf), dout[:, :, lo:hi].float())
        dq[:, :, lo:hi] = gq[:, :, lo:hi]
        dk += gk
        dv += gv
        del out, gq, gk, gv
    return dq, dk, dv


def time_attention_grad(a, kw) -> None:
    """``attention_grad`` on one K8 launch's arguments (its output from the
    kernel, a random ``dout``): against autograd through the plain version
    in f32 (in pieces of 1,024 query rows), each gradient within 1e-2 of
    its largest value (bf16 inputs and outputs); its CUDA-event time
    beside that of the reference and of ``torch.autograd`` through
    ``scaled_dot_product_attention`` on the same inputs, and its bound:
    10 d flops a (query, key) pair (the scores recomputed, dV, dP, dQ,
    dK) at the bf16 tensor-core rate, or q, k, v, out and dout read and
    dq, dk, dv written once at the memory rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import grad, ops

    q, k, v = a
    causal = kw.get("causal", True)
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    out = ops.flash_attention(q, k, v, **kw)
    dout = torch.randn(out.shape, device=q.device,
                       generator=torch.Generator(q.device).manual_seed(0)
                       ).to(q.dtype)
    ms, got = cuda_ms(lambda: grad.attention_grad(
        q, k, v, out, dout, causal, kw.get("sm_scale")), reps=3)
    plain_ms, want = cuda_ms(lambda: autograd_attention_ref(
        q, k, v, dout, causal, rows=1024), reps=1)
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w).abs().max())
        scale = float(w.abs().max())
        errs.append(err)
        if not err <= 1e-2 * scale:
            raise AssertionError(f"attention_grad {name}: max_abs_err "
                                 f"{err:.3g}, largest {scale:.3g}")
    del got, want
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=True)
    lib_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), dout, retain_graph=True), reps=3)
    del lib_out
    flops = 10 * b * hq * d * attention_pairs(lq, lk, causal)
    # q, out and dout read and dq written; k and v read, dk and dv written
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * q.element_size()
    bound_s = {"operations": flops / BF16_FLOPS_PER_S,
               "bytes": nbytes / HBM_BYTES_PER_S}
    bound_by = max(bound_s, key=bound_s.get)
    bound_ms = bound_s[bound_by] * 1e3
    log(f"[timing] attention_grad (q {tuple(q.shape)}, k {tuple(k.shape)}, "
        f"{q.dtype}; PyTorch ops, f32 products, no TPU counterpart): "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / ms:.3f} of the bound); autograd through the "
        f"plain version {plain_ms:.3f} ms; torch.autograd through "
        f"scaled_dot_product_attention {lib_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({flops} flops, {nbytes} "
        f"B); max_abs_err dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv "
        f"{errs[2]:.3g} ({nvidia_smi_line()})")
    torch.cuda.empty_cache()


def train_f32_against_cpu(n_layers: int = TRAIN_F32_LAYERS,
                          tokens: int = TRAIN_F32_TOKENS) -> None:
    """Qwen3-0.6B's widths in f32 (TF32 off) with its first ``n_layers``
    layers, the train cell's step with one microbatch (``loss_and_grads``,
    then ``apply_updates`` under Qwen3's ``OptConfig``) on a 1 x ``tokens``
    batch, CE in one chunk of 512, on the card and on the CPU from the same
    weights, optimizer state and batch: the loss within 1e-4, every
    gradient within 1e-3 of its norm, the parameters after the AdamW step
    within 1e-5; and the card's optimizer held on its own, since at step
    0 the whole update is about lr = 3e-6 an element: the update ``new_p -
    p`` it makes from the card's gradients within 1e-3 of its norm, leaf
    by leaf, of the update the CPU makes from those same gradients.  Every
    K8 launch (the FMA variant) held against its plain version."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.tree import leaves_with_paths

    cfg = dataclasses.replace(f32_config(get_arch(TRAIN_ARCH), n_layers),
                              ce_chunk=512)
    opt_cfg = S.opt_config_for(TRAIN_ARCH)
    loss_fn = (lambda p, b: T.loss_fn(cfg, p, b))
    cpu = torch.device("cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
    batch = lm_batch(0, 0, 1, tokens, cfg.vocab, device=cpu)
    out = {}
    checks = KernelChecks(names=tuple(FLASH_REPLACES))
    for dev in (torch.device("cuda"), cpu):
        p = on_device(params, dev)
        b = on_device(batch, dev)
        t0 = time.perf_counter()
        with (checks if dev.type == "cuda" else contextlib.nullcontext()):
            loss, grads = S.loss_and_grads(loss_fn, p, b)
        new_p, _ = apply_updates(p, grads, init_opt_state(p, opt_cfg),
                                 opt_cfg)
        out[dev.type] = (float(loss), on_device(grads, cpu),
                         on_device(new_p, cpu))
        log(f"[main] train f32 {dev.type}: loss {float(loss):.6f} in "
            f"{time.perf_counter() - t0:.1f} s")
        del p, b, grads, new_p
    checks.report("train f32")
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
    # the CPU's update from the card's gradients
    p_opt, _ = apply_updates(params, g_gpu, init_opt_state(params, opt_cfg),
                             opt_cfg)

    g_rel = rel_leaves(g_gpu, g_cpu)
    p_err = max(float((x - y).abs().max())
                for (_, x), (_, y) in zip(leaves_with_paths(p_gpu),
                                          leaves_with_paths(p_cpu)))
    flat = dict(leaves_with_paths(params))

    def delta(new):
        return {k: v - flat[k] for k, v in leaves_with_paths(new)}

    u_opt = rel_leaves(delta(p_gpu), delta(p_opt))
    u_cpu = rel_leaves(delta(p_gpu), delta(p_cpu))
    u_max = max(float(u.abs().max()) for u in delta(p_cpu).values())
    want = train_launches(cfg, 1, 1)
    log(f"[main] train f32 {TRAIN_ARCH} ({n_layers} of "
        f"{get_arch(TRAIN_ARCH).config.n_layers} layers, full width, 1 x "
        f"{tokens}), cuda against cpu: loss {l_gpu:.6f} / {l_cpu:.6f}, "
        f"gradients within {g_rel:.3g} of their norms, parameters after the "
        f"step within {p_err:.3g} (largest update {u_max:.3g}); the card's "
        f"update within {u_opt:.3g} of its norm of the CPU's from the same "
        f"gradients ({u_cpu:.3g} of the CPU's own step's, not held: a "
        f"gradient near 0 may take the other sign); K8 launches "
        f"{checks.launches} (want {want})")
    if not (abs(l_gpu - l_cpu) <= 1e-4 and g_rel <= 1e-3 and p_err <= 1e-5
            and u_opt <= 1e-3):
        raise AssertionError("train f32: the card's step differs from the "
                             "CPU's")
    if checks.launches["flash_attention"] != want:
        raise AssertionError(f"train f32: {checks.launches} checked "
                             f"launches, not {want}")
    torch.cuda.empty_cache()


def train_restart(out_dir: Path) -> None:
    """``launch.train`` on the SMOKE config on the card: killed after step
    6 (exit 42), resumed from its step-6 checkpoint, and a clean run; the
    resumed losses within 1e-5 of the clean run's (the card's order of
    addition may differ from run to run), the largest difference
    printed."""
    import shutil
    from repro_torch.launch import train

    shutil.rmtree(out_dir, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "10", "--batch",
            "4", "--seq", "16", "--log-every", "100"]
    ckpt = ["--ckpt-dir", str(out_dir), "--ckpt-every", "3"]
    try:
        train.main(args + ckpt + ["--fail-at", "6"])
    except SystemExit as exc:
        if exc.code != 42:
            raise
    else:
        raise AssertionError("train --fail-at 6 did not stop")
    resumed = train.main(args + ckpt)
    clean = train.main(args)
    diff = max(abs(a - b) for a, b in zip(resumed, clean[-len(resumed):]))
    log(f"[main] train restart on the card: killed at step 6, resumed for "
        f"{len(resumed)} steps, largest loss difference to the clean run "
        f"{diff:.3g} (losses {[round(x, 6) for x in resumed]})")
    if len(resumed) != 4 or not diff <= 1e-5:
        raise AssertionError("train restart: the resumed run differs from "
                             "the clean one")
    shutil.rmtree(out_dir, ignore_errors=True)


def dien_train() -> None:
    """DIEN's train cell through ``launch.train`` at train_batch's 65,536
    requests for ``DIEN_TRAIN_STEPS`` steps (full config, f32): each
    step's loss, wall time and peak; then a profile of one more step."""
    import math
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.train.optimizer import init_opt_state

    arch = get_arch("dien")
    batch = arch.shapes["train_batch"]["batch"]
    reset_memory()
    stats: list = []
    losses = train.main(["--arch", "dien", "--steps", str(DIEN_TRAIN_STEPS),
                         "--batch", str(batch), "--log-every", "1"],
                        stats=stats)
    smi = nvidia_smi_line()
    for s in stats:
        log(f"[main] train dien step {s['step']} (batch {batch}): loss "
            f"{s['loss']:.4f}, {s['wall_s']:.3f} s, {s['rate']:.0f} "
            f"requests/s, peak {s['peak_bytes']} B ({smi})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train dien: losses {losses}")
    cell = S.build_cell("dien", "train_batch")
    cfg = cell.cfg
    params = cell.param_init(torch.Generator("cuda").manual_seed(0),
                             device="cuda")
    state = init_opt_state(params, cell.opt_cfg)
    data = recsys_batch(0, 0, batch, cfg.seq_len, cfg.n_items, cfg.n_cats,
                        device="cuda")
    cell.fn(params, state, data)
    profile_call(lambda: cell.fn(params, state, data),
                 f"train dien step, batch {batch}")
    del params, state, data
    torch.cuda.empty_cache()


def train_phase() -> tuple[dict, int, float]:
    """The [train] phase: Qwen3-0.6B at full width in bf16 through
    ``launch.train.main`` (train_4k's sequence of 4,096, a global batch of
    16 in 4 microbatches) for one step with every K8 launch checked; K8 and
    ``attention_grad`` timed on the first launch's arguments; the counted
    run of 3 steps; then the f32 step on the card against the CPU, the restart on the
    card and DIEN's train cell.  Returns K8's timing row on the training
    path, its counted launches and the checks' largest error."""
    import torch
    from repro_torch.launch import steps as S

    cell = S.build_cell(TRAIN_ARCH, "train_4k")
    cfg = cell.cfg
    n = cfg.param_count()
    log(f"[train] {TRAIN_ARCH}: {n} parameters ({2 * n} B in bf16; f32 m, "
        f"v and gradient accumulators {12 * n} B), {cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; policy: "
        f"{cell.n_micro} microbatches, CE chunks of {cfg.ce_chunk}, f32 "
        f"accumulation, {cell.opt_cfg}; batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"(train_4k's global batch 256 cut to {TRAIN_BATCH}), "
        f"{TRAIN_STEPS} steps")
    args = train_args(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    checks = train_checked(train_args(TRAIN_ARCH, TRAIN_CHECKED_STEPS,
                                      TRAIN_BATCH, TRAIN_SEQ))
    want = train_launches(cfg, cell.n_micro, TRAIN_CHECKED_STEPS)
    if checks.launches["flash_attention"] != want:
        raise AssertionError(f"train: {checks.launches} checked launches, "
                             f"not {want}")
    a, kw = checks.kept.pop("flash_attention")
    a = tuple(t.detach() for t in a)      # out of the step's graph
    log(f"[timing] train {TRAIN_ARCH} layer 0, microbatch 0 "
        f"({nvidia_smi_line()}):")
    row = time_flash(a, kw)
    time_attention_grad(a, kw)
    del a, kw
    torch.cuda.empty_cache()
    _, launches = train_main(TRAIN_ARCH, args)
    profile_train_microbatch(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ)
    train_f32_against_cpu()
    train_restart(ROOT / "build" / "train_restart")
    dien_train()
    return row, launches, checks.err["flash_attention"]


# ---------------------------------------------------------------------------
# The segment sum at ogb_products' scale


def time_segsum(a, label: str, reps: tuple[int, int]) -> dict:
    """``sorted_segment_sum`` timed on f32 arguments ``a`` (CUDA events,
    ``reps`` calls of the kernel and of its plain version) beside
    ``index_add_``; its output held by ``check_segsum``; the bound from
    the bytes it must move (data and ids read once, the sums written
    once).  Returns the kernels' JSON row."""
    import torch
    from repro_torch.kernels.segsum import ops, ref

    data, seg, s = a
    n, d = data.shape
    ms, got = cuda_ms(lambda: ops.sorted_segment_sum(data, seg, s),
                      reps=reps[0])
    plain_ms, want = cuda_ms(lambda: ref.sorted_segment_sum_ref(data, seg, s),
                             reps=reps[1])
    lib_ms, lib = cuda_ms(lambda: torch.zeros(s, d, device="cuda").index_add_(
        0, seg, data), reps=reps[0])
    lib_err = float((lib - want).abs().max())
    del want, lib
    err = check_segsum(a, {}, got)
    nbytes = (data.numel() + n + s * d) * 4
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": err}
    log(f"[timing] sorted_segment_sum{label} ({n} x {d} into {s}; "
        f"{nvidia_smi_line()}): {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s; "
        f"plain {plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms (max_abs_err "
        f"{lib_err:.3g}), bound {row['bound_ms']:.4f} ms from {nbytes} B), "
        f"max_abs_err {err:.3g}")
    return row


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

    row = time_segsum((data, seg, s), "", reps=(5, 2))

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



# ---------------------------------------------------------------------------
# GNN training: the four archs' train cells at full width, K7 on the path

# (arch, shape, layers or None for the config's, nearest pairs a molecule
# or None for all).  EquiformerV2 runs twice: on the 128 joined molecules'
# 111,360 edges its double backward keeps about 30 GB a layer (a step
# peaks at 34.5 GB with 1 layer, 64.9 GB with 2 on an H100 80GB HBM3), so
# 2 of its 12 layers; and at all 12 on the molecule shape's own 16,384
# edges (64 nearest pairs a molecule, 66.0 GB).  The widths stay.
GNN_CELLS = (("gat-cora", "full_graph_sm", None, None),
             ("graphsage-reddit", "full_graph_sm", None, None),
             ("graphsage-reddit", "minibatch_lg", None, None),
             ("nequip", "molecule", None, None),
             ("equiformer-v2", "molecule", 2, None),
             ("equiformer-v2", "molecule", None, 64))
GNN_STEPS = 3
GNN_ROW = "sorted_segment_sum:gnn"     # K7 on EquiformerV2's aggregation
# the CPU side of the card-against-CPU step: molecules of the batch kept
GNN_CPU_MOLECULES = {"nequip": 8, "equiformer-v2": 1}
# the cell whose step is profiled: EquiformerV2 at 2 layers (9 s; the
# 12-layer step's profile takes 30 s, so it and NequIP's run in
# ``--gnn-memory``)
GNN_PROFILED = ("equiformer-v2", 2)


def gnn_cell(arch_id: str, shape_name: str, smoke: bool = False,
             **changes):
    """``build_cell(arch_id, shape_name, smoke=smoke)``; with ``changes``
    to the config (a depth cut), the same cell built by ``build_cell``'s
    ``_gnn_train_cell`` from an ``ArchSpec`` that carries the changed
    config."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps as S
    if not changes:
        return S.build_cell(arch_id, shape_name, smoke=smoke)
    arch = get_arch(arch_id)
    field = "smoke" if smoke else "config"
    arch = dataclasses.replace(arch, **{field: dataclasses.replace(
        getattr(arch, field), **changes)})
    return S._gnn_train_cell(arch, shape_name, smoke)


def joined_molecules(n_mol: int, n_atoms: int, device) -> dict:
    """``molecule_batch(seed=0, step=i, n_atoms)`` for i < n_mol as one
    disjoint graph: ids offset by ``n_atoms * i``, energies summed, forces
    stacked."""
    import torch
    from repro_torch.data.pipeline import molecule_batch

    ms = [molecule_batch(0, i, n_atoms, device=device) for i in range(n_mol)]
    return {
        "positions": torch.cat([m["positions"] for m in ms]),
        "species": torch.cat([m["species"] for m in ms]),
        "edge_src": torch.cat([m["edge_src"] + n_atoms * i
                               for i, m in enumerate(ms)]),
        "edge_dst": torch.cat([m["edge_dst"] + n_atoms * i
                               for i, m in enumerate(ms)]),
        "energy": sum(m["energy"] for m in ms),
        "forces": torch.cat([m["forces"] for m in ms])}


def sampled_blocks(shp: dict, d_feat: int, n_classes: int, device) -> dict:
    """GraphSAGE's minibatch: ``batch_nodes`` seeds drawn without
    replacement from ``node_classification_data(n_nodes, d_feat,
    n_classes)`` (its default average degree of 8), their fanout frontiers
    from ``sample_fanout`` and the frontiers' feature blocks."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import node_classification_data
    from repro_torch.graph.csr import from_edge_list
    from repro_torch.graph.sampler import sample_fanout

    n = shp["n_nodes"]
    data = node_classification_data(0, n, d_feat, n_classes, device="cpu")
    g = from_edge_list(np.stack([data["edge_src"].numpy(),
                                 data["edge_dst"].numpy()], 1),
                       n_vertices=n, symmetrize=False, device="cpu")
    seeds = np.random.default_rng(0).choice(n, shp["batch_nodes"],
                                            replace=False)
    fronts = sample_fanout(g, seeds, tuple(shp["fanout"]), seed=0)
    feats = data["feats"]
    return {"feat_blocks": [feats[torch.from_numpy(f).long()].to(device)
                            for f in fronts],
            "labels": data["labels"][torch.from_numpy(seeds)].to(device)}


def gnn_batch(arch_id: str, shape_name: str, cfg, device,
              molecules: int | None = None, pairs: int | None = None
              ) -> dict:
    """The cell's batch, made from seed 0: joined molecules (the shape's
    128, or ``molecules``; with ``pairs``, each one's nearest pairs only),
    GraphSAGE's sampled blocks, or the whole graph of
    ``node_classification_data`` at the shape's nodes and features."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import node_classification_data
    from repro_torch.launch import steps as S

    shp = get_arch(arch_id).shapes[shape_name]
    d_feat = S.gnn_d_feat(shape_name, shp)
    if shape_name == "molecule":
        n_mol = molecules or shp["batch"]
        batch = joined_molecules(n_mol, shp["n_nodes"], device)
        return nearest_pairs(batch, n_mol, shp["n_nodes"], pairs) if pairs \
            else batch
    if arch_id == "graphsage-reddit" and shape_name == "minibatch_lg":
        return sampled_blocks(shp, d_feat, cfg.n_classes, device)
    return node_classification_data(0, shp["n_nodes"], d_feat,
                                    cfg.n_classes, device=device)


def gnn_launches(arch_id: str, cfg, batch: dict) -> int:
    """K7 launches of one train step, worked out from the code.  GAT: an
    ``edge_softmax`` sum and the aggregation a layer; GraphSAGE full: the
    sums and the counts of ``segment_mean`` a layer; sampled: none.
    NequIP and EquiformerV2 (forces ``-dE/dpos`` inside the loss): the
    forward's F launches (NequIP one an l a layer; EquiformerV2 the
    softmax's sum and one an edge chunk a layer), then in the loss's
    backward one a gather that the force's backward made, which is one a
    forward launch except where no gradient reaches it: the last layer's
    l > 0 sums (NequIP) and layer 0's softmax, which positions do not
    reach (EquiformerV2); EquiformerV2 checkpoints its layers, so each
    runs twice more, once in each backward."""
    if "feat_blocks" in batch:
        return 0
    if arch_id in ("gat-cora", "graphsage-reddit"):
        return 2 * cfg.n_layers
    if arch_id == "nequip":
        f, unreached = cfg.n_layers * (cfg.l_max + 1), cfg.l_max
    else:
        e = batch["edge_src"].shape[0]
        chunk = cfg.edge_chunk if 0 < cfg.edge_chunk < e else 0
        blocks = -(-e // chunk) if chunk else 1
        f, unreached = cfg.n_layers * (1 + blocks), 1
    remat = 2 * f if arch_id == "equiformer-v2" else 0
    return f + remat + f - unreached


@contextlib.contextmanager
def first_launch(pred):
    """While active, keeps the arguments of the first
    ``sorted_segment_sum`` call for which ``pred(data)`` holds in
    ``kept["args"]``, and the number of such calls in
    ``kept["launches"]``; the calls run as they are."""
    from repro_torch.kernels.segsum import ops
    fn = ops.sorted_segment_sum
    kept: dict = {}

    def run(*a, **kw):
        if pred(a[0]):
            if not kept:
                kept["args"] = (tuple(t.detach() if hasattr(t, "detach")
                                      else t for t in a), kw)
            kept["launches"] = kept.get("launches", 0) + 1
        return fn(*a, **kw)
    ops.sorted_segment_sum = run
    try:
        yield kept
    finally:
        ops.sorted_segment_sum = fn


def rel_leaves(xs, ys) -> float:
    """The largest ``|x - y| / |y|`` over matching leaves (norms)."""
    from repro_torch.train.tree import leaves_with_paths
    return max(float((x - y).norm() / y.norm().clamp_min(1e-30))
               for (_, x), (_, y) in zip(leaves_with_paths(xs),
                                         leaves_with_paths(ys)))


GNN_MODULES = {"gat-cora": "gat", "graphsage-reddit": "graphsage",
               "nequip": "nequip", "equiformer-v2": "equiformer_v2"}


def gnn_model(arch_id: str):
    import importlib
    return importlib.import_module(
        f"repro_torch.models.gnn.{GNN_MODULES[arch_id]}")


def gnn_against_cpu(arch_id: str, label: str, cell, batch: dict,
                    card: str = "cuda") -> None:
    """One f32 step of the cell spelled out (``loss_and_grads`` of the
    model's ``loss_fn``, then ``apply_updates`` under the cell's
    ``OptConfig``) on the card and on the CPU from the same weights (seed
    0), zero optimizer state and batch: the losses within 1e-4 of the
    CPU's (relative), the unclipped gradients within 1e-3 of their norms,
    leaf by leaf, and the card's update ``new_p - p`` within 1e-3 of its
    norm of the update the CPU makes from the card's gradients.  For the
    potentials, whose losses the targets dominate, also what the model
    predicts: the energy within 1e-4 of its magnitude and the forces
    within 1e-4 of their norm.  ``card`` is the device held against the
    CPU."""
    import torch
    from repro_torch.launch import steps as S
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.tree import leaves_with_paths

    mod, cfg, opt_cfg = gnn_model(arch_id), cell.cfg, cell.opt_cfg
    cpu = torch.device("cpu")
    params = cell.param_init(torch.Generator().manual_seed(0), device=cpu)
    batch = on_cpu(batch)
    out = []
    for dev in (torch.device(card), cpu):
        p, b = on_device(params, dev), on_device(batch, dev)
        t0 = time.perf_counter()
        loss, grads = S.loss_and_grads(
            lambda p_, b_: mod.loss_fn(cfg, p_, b_), p, b)
        new_p, _ = apply_updates(p, grads, init_opt_state(p, opt_cfg),
                                 opt_cfg)
        pred = None
        if "positions" in b:
            pred = [t.detach().cpu() for t in mod.energy_and_forces(
                lambda pos: mod.forward(cfg, p, b["species"], pos,
                                        b["edge_src"], b["edge_dst"]),
                b, create_graph=False)]
        out.append((float(loss), on_cpu(grads), on_cpu(new_p), pred))
        log(f"[main] gnn {arch_id} {label} f32 {dev.type}: loss "
            f"{float(loss):.6f} in {time.perf_counter() - t0:.2f} s")
        del p, b, grads, new_p
    (l_gpu, g_gpu, p_gpu, e_gpu), (l_cpu, g_cpu, _, e_cpu) = out
    p_opt, _ = apply_updates(params, g_gpu, init_opt_state(params, opt_cfg),
                             opt_cfg)
    flat = dict(leaves_with_paths(params))

    def delta(new):
        return {k: v - flat[k] for k, v in leaves_with_paths(new)}

    l_rel = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-30)
    g_rel = rel_leaves(g_gpu, g_cpu)
    u_rel = rel_leaves(delta(p_gpu), delta(p_opt))
    e_rel = f_rel = 0.0
    said = ""
    if e_cpu is not None:
        (e1, f1), (e0, f0) = e_gpu, e_cpu
        e_rel = float((e1 - e0).abs() / e0.abs().clamp_min(1e-30))
        f_rel = float((f1 - f0).norm() / f0.norm().clamp_min(1e-30))
        said = (f", energy {float(e1):.6f} / {float(e0):.6f} (relative "
                f"{e_rel:.3g}), forces within {f_rel:.3g} of their norm")
    log(f"[main] gnn {arch_id} {label}, cuda against cpu: loss "
        f"{l_gpu:.6f} / {l_cpu:.6f} (relative {l_rel:.3g}), gradients "
        f"within {g_rel:.3g} of their norms, the update from the card's "
        f"gradients within {u_rel:.3g}{said}")
    if not (l_rel <= 1e-4 and g_rel <= 1e-3 and u_rel <= 1e-3
            and e_rel <= 1e-4 and f_rel <= 1e-4):
        raise AssertionError(f"gnn {arch_id} {label}: the card's step "
                             "differs from the CPU's")


def gnn_counted(arch_id: str, label: str, cell, params, state,
                batch: dict) -> int:
    """``GNN_STEPS`` steps of the cell with the counts set to 0 just
    before: each step's loss, wall time, peak and K7 launches printed,
    the launches of every step equal to ``gnn_launches``, no plain call,
    every loss finite.  Returns the launches."""
    import math

    import torch
    from repro_torch.kernels.segsum import ops, ref

    want = gnn_launches(arch_id, cell.cfg, batch)
    smi = nvidia_smi_line()
    ops.reset_counts()
    for step in range(GNN_STEPS):
        before = ops.LAUNCHES["sorted_segment_sum"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = cell.fn(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.LAUNCHES["sorted_segment_sum"] - before
        loss = float(loss)
        log(f"[main] gnn {arch_id} {label} step {step}: loss "
            f"{loss:.6g}, {wall:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated()} B, K7 launches {got} "
            f"(want {want}) ({smi})")
        if got != want or not math.isfinite(loss):
            raise AssertionError(f"gnn {arch_id} {label} step {step}: "
                                 f"{got} launches, loss {loss}")
    launches = ops.LAUNCHES["sorted_segment_sum"]
    plain = ref.sorted_segment_sum_ref.calls
    log(f"[main] gnn {arch_id} {label}: launches {launches}, plain "
        f"calls {plain}")
    if plain:
        raise AssertionError(f"gnn {arch_id} {label}: {plain} plain "
                             "calls")
    return launches


def timed_width(arch_id: str, cfg) -> int:
    """The width of the cell's K7 launches that the phase times:
    EquiformerV2's aggregation (``C (l_max+1)^2`` columns), NequIP's
    widest message (``C (2 l_max + 1)``); 0 (none) for the others."""
    if arch_id == "equiformer-v2":
        return cfg.d_hidden * cfg.sph_dim
    if arch_id == "nequip":
        return cfg.d_hidden * (2 * cfg.l_max + 1)
    return 0


def gnn_checked(arch_id: str, label: str, cell, params, state,
                batch: dict):
    """One step of the cell with every K7 launch held against its plain
    version, as many launches as ``gnn_launches`` says; the first launch
    at ``timed_width`` (EquiformerV2's layer-0 aggregation, NequIP's
    layer-0 l_max message) kept as ``kept["args"]``, and the step's
    launches at that width counted in ``kept["launches"]``.  Returns the
    new params and state, the checks and ``kept``."""
    cfg = cell.cfg
    width = timed_width(arch_id, cfg)
    checks = KernelChecks(names=tuple(SEGSUM_REPLACES))
    with first_launch(lambda d: width and d.shape[1] == width) as kept:
        with checks:
            params, state, loss = cell.fn(params, state, batch)
    want = gnn_launches(arch_id, cfg, batch)
    checks.report(f"gnn {arch_id} {label} (loss {float(loss):.6g})")
    if checks.launches["sorted_segment_sum"] != want:
        raise AssertionError(f"gnn {arch_id} {label}: "
                             f"{checks.launches} checked launches, not "
                             f"{want}")
    return params, state, checks, kept


def gnn_phase() -> tuple[dict, int, float]:
    """The [gnn] phase: each GNN cell of ``GNN_CELLS`` through
    ``build_cell(...).fn`` at CONFIG width in f32 (seed 0): one step with
    every K7 launch held against its plain version, ``GNN_STEPS`` counted
    steps, one step on the card against the CPU; K7 timed on the first
    launch at ``timed_width`` of each cell that has one: EquiformerV2's
    layer-0 aggregation on all the joined edges (the timing row) and on
    the 12-layer cell's nearest pairs, and NequIP's widest message.
    Returns the timing row, the counted launches and the checks' largest
    error."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import leaves

    launches, err, row = 0, 0.0, None
    for arch_id, shape_name, depth, pairs in GNN_CELLS:
        t_cell = time.perf_counter()
        cell = gnn_cell(arch_id, shape_name,
                        **({"n_layers": depth} if depth else {}))
        cfg = cell.cfg
        label = " ".join([shape_name, *([f"{depth} layers"] if depth else []),
                          *([f"{pairs} pairs"] if pairs else [])])
        batch = gnn_batch(arch_id, shape_name, cfg, "cuda", pairs=pairs)
        params = cell.param_init(torch.Generator("cuda").manual_seed(0),
                                 device="cuda")
        state = init_opt_state(params, cell.opt_cfg)
        n_params = sum(int(x.numel()) for x in leaves(params))
        shapes = {k: (tuple(v.shape) if hasattr(v, "shape")
                      else [tuple(x.shape) for x in v])
                  for k, v in batch.items()}
        log(f"[gnn] {arch_id} {label}: {cfg} ({n_params} parameters, "
            f"depth cut {depth or 'none'}, nearest pairs a molecule "
            f"{pairs or 'all'}); batch {shapes}")
        parts = [time.perf_counter()]
        params, state, checks, kept = gnn_checked(arch_id, label, cell,
                                                  params, state, batch)
        err = max(err, checks.err["sorted_segment_sum"])
        if kept:
            log(f"[gnn] {arch_id} {label}: {kept['launches']} K7 launches "
                f"a step at width {timed_width(arch_id, cfg)}")
            timed = time_segsum(kept.pop("args")[0],
                                f" gnn {arch_id} {label}", reps=(10, 3))
            if arch_id == "equiformer-v2" and row is None:
                row = timed
        kept.clear()
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
        launches += gnn_counted(arch_id, label, cell, params, state, batch)
        parts.append(time.perf_counter())
        if (arch_id, depth) == GNN_PROFILED:
            profile_call(lambda: cell.fn(params, state, batch),
                         f"gnn {arch_id} {label} step", also="segsum")
        parts.append(time.perf_counter())
        del params, state
        torch.cuda.empty_cache()
        if arch_id in GNN_CPU_MOLECULES:
            n_mol = GNN_CPU_MOLECULES[arch_id]
            log(f"[gnn] {arch_id} {label} card against CPU: {n_mol} of the "
                f"{get_arch(arch_id).shapes[shape_name]['batch']} molecules,"
                f" {cfg.n_layers} layers")
            batch = gnn_batch(arch_id, shape_name, cfg, "cpu",
                              molecules=n_mol, pairs=pairs)
        gnn_against_cpu(arch_id, label, cell, batch)
        del batch
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
        took = ", ".join(f"{name} {b - a:.1f} s" for name, a, b in zip(
            ("checked step and timing", "counted steps", "profile",
             "against the CPU"), parts, parts[1:]))
        log(f"[gnn] {arch_id} {label}: {time.perf_counter() - t_cell:.1f} s "
            f"({took})")
    if row is None:
        raise AssertionError("gnn: no EquiformerV2 aggregation was kept")
    return row, launches, err


# ``--gnn-memory``: the potentials' train steps with each layer run
# plainly and under torch.utils.checkpoint (JAX's remat), on the
# phase's 128 joined molecules ("dense", all pairs) and on the molecule
# shape's own edge count (each molecule's nearest pairs): (arch, layers,
# pairs a molecule or None for all)
GNN_MEMORY = (("nequip", 5, None), ("equiformer-v2", 2, None),
              ("equiformer-v2", 3, None), ("equiformer-v2", 12, 64))


def nearest_pairs(batch: dict, n_mol: int, n_atoms: int, pairs: int
                  ) -> dict:
    """``joined_molecules``' batch with each molecule's edges cut to its
    ``pairs`` nearest atom pairs, both ways: the ``molecule`` shape's
    ``2 x n_edges`` a molecule."""
    import torch
    pos = batch["positions"].view(n_mol, n_atoms, 3)
    i, j = torch.triu_indices(n_atoms, n_atoms, 1, device=pos.device)
    near = (pos[:, i] - pos[:, j]).norm(dim=-1).topk(
        pairs, dim=1, largest=False).indices
    off = n_atoms * torch.arange(n_mol, device=pos.device)[:, None]
    s, t = (i[near] + off).reshape(-1), (j[near] + off).reshape(-1)
    dt = batch["edge_src"].dtype
    return {**batch, "edge_src": torch.cat([s, t]).to(dt),
            "edge_dst": torch.cat([t, s]).to(dt)}


@contextlib.contextmanager
def layer_remat(mod, on: bool):
    """While active, each layer of ``mod``'s forward runs under
    ``torch.utils.checkpoint`` (non-reentrant, as JAX's scan remats it)
    if ``on``, else plainly, whichever the model does itself."""
    from torch.utils.checkpoint import checkpoint
    layer, own = mod._layer, getattr(mod, "checkpoint", None)
    if own is not None:
        mod.checkpoint = lambda fn, *a, use_reentrant: fn(*a)
    if on:
        mod._layer = lambda *a: checkpoint(layer, *a, use_reentrant=False)
    try:
        yield
    finally:
        mod._layer = layer
        if own is not None:
            mod.checkpoint = own


def gnn_memory() -> None:
    """Each ``GNN_MEMORY`` cell at CONFIG width in f32: two train steps
    from seed 0 with the layers run plainly and under checkpoints
    (``layer_remat``), each step's wall time and K7 launches and the two
    steps' peak printed (or that the card ran out of memory); then, the
    way the model runs its layers itself, a profile of a third step (the
    segment sum's share printed)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.segsum import ops
    from repro_torch.train.optimizer import init_opt_state

    smi = nvidia_smi_line()
    for arch_id, depth, pairs in GNN_MEMORY:
        own = hasattr(gnn_model(arch_id), "checkpoint")    # its own remat
        cell = gnn_cell(arch_id, "molecule", n_layers=depth)
        shp = get_arch(arch_id).shapes["molecule"]
        batch = joined_molecules(shp["batch"], shp["n_nodes"], "cuda")
        if pairs:
            batch = nearest_pairs(batch, shp["batch"], shp["n_nodes"], pairs)
        edges = int(batch["edge_src"].shape[0])
        for remat in (False, True):
            label = (f"[gnn-memory] {arch_id} {depth} layers, {edges} edges, "
                     f"{'remat' if remat else 'no remat'}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                params = cell.param_init(
                    torch.Generator("cuda").manual_seed(0), device="cuda")
                state = init_opt_state(params, cell.opt_cfg)
                with layer_remat(gnn_model(arch_id), remat):
                    for step in range(2):
                        ops.reset_counts()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        params, state, loss = cell.fn(params, state, batch)
                        torch.cuda.synchronize()
                        log(f"{label} step {step}: loss {float(loss):.6g}, "
                            f"{time.perf_counter() - t0:.3f} s, K7 launches "
                            f"{ops.LAUNCHES['sorted_segment_sum']}")
                log(f"{label}: peak {torch.cuda.max_memory_allocated()} B "
                    f"({smi})")
                if remat == own:
                    with layer_remat(gnn_model(arch_id), remat):
                        profile_call(lambda: cell.fn(params, state, batch),
                                     f"{label} step", also="segsum")
            except torch.cuda.OutOfMemoryError:
                log(f"{label}: out of memory, peak "
                    f"{torch.cuda.max_memory_allocated()} B ({smi})")
            params = state = None
        del batch
    torch.cuda.empty_cache()


def lint_phase() -> None:
    """The [lint] phase: the port's contract linter over the
    ``repro_torch`` this script imports.  Any finding (or a source it
    cannot parse) fails the run."""
    import repro_torch
    from repro_torch.analysis import render_text, run_analysis

    t0 = time.perf_counter()
    project, findings = run_analysis(
        str(Path(repro_torch.__file__).resolve().parent))
    log(f"[lint] {len(findings)} findings in {len(project.files)} .py and "
        f"{len(project.cuda_files)} .cu files ({time.perf_counter() - t0:.1f}"
        " s)")
    if findings or project.errors:
        log(render_text(project, findings))
        raise AssertionError("the contract linter reports findings")


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
        from repro_torch.kernels.intersect import ops as intersect_ops
        from repro_torch.kernels.segsum import ops as segsum_ops
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_script = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--gnn-memory"]:
        gnn_memory()
        return 0
    lint_phase()

    t0 = time.perf_counter()
    for src, report in build.build_all(build.sources()).items():
        log(f"[build] {src.name}:\n{report.strip()}")
        if src == ops.SOURCE:
            RESOURCES.update(instance_resources(report))
            ENUM_RESOURCES.update(enumerator_resources(report))
        elif src == intersect_ops.SOURCE:
            (res,) = build.kernel_resources(report).values()
            K6_RESOURCES.update(res)
        elif src == segsum_ops.SOURCE:
            K7_RESOURCES.update(build.kernel_resources(report))
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, res in sorted(K7_RESOURCES.items()):
        if m := re.search(r"segsum_kernelI(f|13__nv_bfloat16)Lb([01])E",
                          name):
            name = (f"segsum_kernel {'f32' if m[1] == 'f' else 'bf16'} "
                    f"{'16-byte' if m[2] == '1' else 'scalar'} loads")
        log(f"[build] sorted_segment_sum {name}: {res['registers']} "
            f"registers, spills {res['spill_stores']} / "
            f"{res['spill_loads']} B, stack {res['stack']} B, smem "
            f"{res['smem']} B")
    log(f"[build] intersect_count: {K6_RESOURCES['registers']} registers, "
        f"spills {K6_RESOURCES['spill_stores']} / "
        f"{K6_RESOURCES['spill_loads']} B, stack {K6_RESOURCES['stack']} B, "
        f"smem {K6_RESOURCES['smem']} B")
    for (name, pred, mode), res in sorted(RESOURCES.items()):
        log(f"[build] {name} {pred} {mode}: {res['registers']} registers, "
            f"spills {res['spill_stores']} / {res['spill_loads']} B, stack "
            f"{res['stack']} B, smem {res['smem']} B")
    for (name, e), res in sorted(ENUM_RESOURCES.items(),
                                 key=lambda kv: (kv[0][0], kv[0][1] or 0)):
        log(f"[build] {name}{'' if e is None else f' E={e}'}: "
            f"{res['registers']} registers, spills {res['spill_stores']} / "
            f"{res['spill_loads']} B, stack {res['stack']} B, smem "
            f"{res['smem']} B")
    if len(RESOURCES) != 45 or len(ENUM_RESOURCES) != 8:
        raise AssertionError(f"{len(RESOURCES)} pruned instantiations and "
                             f"{len(ENUM_RESOURCES)} enumerators in the "
                             "build report, not 45 and 8")

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
    checks16 = checked_runs(g16, tc_cf, expected, "rmat16", keep="tc",
                            largest="4-cf")
    log(f"[check] rmat16: {time.perf_counter() - t0:.1f} s")
    if checks16.overflow_cases < 1:
        raise AssertionError("no overflow case was checked")
    # K3 at TC's level 2 with the kernels it feeds, then at 4-CF's level 3
    timing = time_with_k3_l3(checks16.kept)
    checks16.kept.clear()
    torch.cuda.empty_cache()

    with counting_k3_shapes():
        launches = main_path(g16, expected)
    for name, app in tc_cf:
        e2e_samples(g16, name, app, expected[name], "cuda")
    profile_warm(g16, make_tc_app(), "rmat16 tc")
    profile_warm(g16, make_cf_app(4), "rmat16 4-cf")

    # the hand-optimised TC on the intersection kernel: every launch
    # checked at scale 12 and at the main size, the latter's paths, its
    # timing in CSR order and shuffled; then the counted cold and warm
    # calls
    t_phase = time.perf_counter()
    timing["intersect_count"], launches["intersect_count"], checks_tc = \
        tc_fused_phase(g12, expected12["tc"], g16, tri)
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
    with counting_k3_shapes():
        for k, n in main_path(g16, expected, backend="cuda-1p").items():
            launches[k] = launches.get(k, 0) + n
    for name, app in tc_cf:
        e2e_samples(g16, name, app, expected[name], "cuda-1p")
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
    launches["extend_edge"], _ = fsm_main_path(g15, FSM_SUPPORT, want15)
    e2e_samples(g15, "3-fsm", make_fsm_app(3, FSM_SUPPORT, max_patterns=64),
                FSM_FREQUENT, "cuda")
    profile_warm(g15, make_fsm_app(3, FSM_SUPPORT, max_patterns=64),
                 "rmat15 3-fsm")
    log(f"[fsm] phase {time.perf_counter() - t_fsm:.1f} s")
    del g15
    torch.cuda.empty_cache()

    # motif counting and compiled patterns: the state, canonical and
    # labeled variants of the pruned kernels
    t_phase = time.perf_counter()
    mc_errs, census = mc_phase(timing, launches)
    log(f"[mc] phase {time.perf_counter() - t_phase:.1f} s")

    # partial and core packs: K1's mixed probe in K2 and K4
    t_phase = time.perf_counter()
    mixed_errs = mixed_phase(expected, census, timing, launches)
    log(f"[mixed] phase {time.perf_counter() - t_phase:.1f} s")

    # the sampled planner and plan transfer, then edge blocks
    t_phase = time.perf_counter()
    plan_errs = plan_phase(g12, expected12, expected, want15, launches)
    log(f"[plan] phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    blocks_errs = blocks_phase(g12, expected12, tri, expected, launches)
    log(f"[blocks] phase {time.perf_counter() - t_phase:.1f} s")

    # multi-device mining: world size 1 over nccl, then four gloo ranks
    # sharing the card; then the mining CLI and serve --mine
    t_phase = time.perf_counter()
    sharded_errs = sharded_phase(expected, want15, launches)
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    cli_errs = cli_phase(launches)
    log(f"[cli] phase {time.perf_counter() - t_phase:.1f} s")

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
    torch.cuda.empty_cache()

    # MoE LM serving: DeepSeek-MoE-16B at full width, K8 on group 1; then
    # DIEN recsys serving
    t_phase = time.perf_counter()
    timing[MOE_FLASH_ROW], launches[MOE_FLASH_ROW], moe_err = moe_phase()
    launches["flash_attention"] += launches[MOE_FLASH_ROW]
    log(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    recsys_phase()
    log(f"[recsys] phase {time.perf_counter() - t_phase:.1f} s")

    # training: Qwen3-0.6B at full width through launch.train, K8 in every
    # layer's forward and remat recompute, then the f32 step against the
    # CPU, the restart and DIEN's train cell
    t_phase = time.perf_counter()
    timing[TRAIN_FLASH_ROW], launches[TRAIN_FLASH_ROW], train_err = \
        train_phase()
    launches["flash_attention"] += launches[TRAIN_FLASH_ROW]
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    timing["sorted_segment_sum"], launches["sorted_segment_sum"], seg_err = \
        segsum_phase()
    log(f"[segsum] phase {time.perf_counter() - t_phase:.1f} s")

    # GNN training: GAT, GraphSAGE (full and sampled), NequIP and
    # EquiformerV2 at full width, their message passing on K7
    t_phase = time.perf_counter()
    timing[GNN_ROW], launches[GNN_ROW], gnn_err = gnn_phase()
    launches["sorted_segment_sum"] += launches[GNN_ROW]
    log(f"[gnn] phase {time.perf_counter() - t_phase:.1f} s")

    kernels = []
    errs = {**checks16.err, **checks15.err, **checks_tc.err, **checks_1p.err,
            **checks_lm.err, "sorted_segment_sum": max(seg_err, gnn_err),
            GNN_ROW: gnn_err,
            MOE_FLASH_ROW: moe_err, TRAIN_FLASH_ROW: train_err}
    errs["flash_attention"] = max(errs["flash_attention"], moe_err,
                                  train_err)
    errs[K3_CF_ROW] = errs["extend_candidates"]
    # the K3 row at 4-CF's level 3 counts the launches at its shape
    if sum(K3_SHAPES.values()) != launches["extend_candidates"]:
        raise AssertionError(f"K3 launches by shape {dict(K3_SHAPES)}, not "
                             f"{launches['extend_candidates']} in all")
    launches[K3_CF_ROW] = K3_SHAPES[timing[K3_CF_ROW]["shape"]]
    log(f"[main] extend_candidates launches by (k, cand_cap): "
        f"{dict(K3_SHAPES)}")
    for more in (mc_errs, mixed_errs, plan_errs, blocks_errs, sharded_errs,
                 cli_errs):
        for name, err in more.items():
            errs[name] = max(errs.get(name, 0), err)
    for name, replaces in {**REPLACES, **K3_ROWS, **EDGE_REPLACES,
                           **LOOKBACK_REPLACES,
                           **MC_REPLACES, **MIXED_REPLACES,
                           **INTERSECT_REPLACES, **FLASH_REPLACES,
                           MOE_FLASH_ROW: FLASH_REPLACES["flash_attention"],
                           TRAIN_FLASH_ROW: FLASH_REPLACES["flash_attention"],
                           **SEGSUM_REPLACES,
                           GNN_ROW: SEGSUM_REPLACES["sorted_segment_sum"],
                           }.items():
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
            "library_ms": t.get("library_ms"),
            **{key: t[key] for key in ("live_slots", "tail_slots",
                                       *RESOURCE_KEYS) if key in t}})
    log(f"[main] chip_smoke.py: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
