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
              may have run.

The line before the last two is the kernels' JSON record; the line before
the last is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
TPU_KERNEL = "src/repro/kernels/extend_fused/extend.py"
KERNEL_SOURCE = "src/repro_torch/kernels/extend_fused/csrc/extend.cu"
REPLACES = {"extend_candidates": f"{TPU_KERNEL}:65",
            "extend_count": f"{TPU_KERNEL}:505",
            "extend_scatter": f"{TPU_KERNEL}:519"}


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


class KernelChecks:
    """While active, every launch of a kernel wrapper on the port's path is
    held against the wrapper's plain version on the same inputs.

    The plain versions run over tile-aligned slot ranges of ``chunk``
    slots (``ref``'s ``slots=``), since at 2^30 candidate slots their
    temporaries would not fit beside the kernel's outputs; the pieces
    cover every output element.  Each ``extend_scatter`` launch is also
    replayed with half its ``out_cap`` (an overflow case) and held against
    the plain version at that capacity.  While ``keep`` is set, the first
    launch of each kernel keeps its arguments (``kept``) for timing.
    """

    def __init__(self, chunk: int = 1 << 25):
        from repro_torch.kernels.extend_fused import ref
        assert chunk % ref.BLOCK_C == 0
        self.chunk = chunk
        self.err = {name: 0 for name in REPLACES}
        self.launches = {name: 0 for name in REPLACES}
        self.modes: set[str] = set()
        self.overflow_cases = 0
        self.kept: dict = {}
        self.keep = False

    def __enter__(self):
        from repro_torch.kernels.extend_fused import ops
        self._saved = {name: getattr(ops, name) for name in REPLACES}
        for name, fn in self._saved.items():
            setattr(ops, name, self._checked(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.extend_fused import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)

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
            if err:
                raise AssertionError(
                    f"{name} (cand_cap={kw['cand_cap']}, k={kw['k']}) "
                    f"differs from its plain version by {err}")
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

    def report(self, label: str) -> None:
        log(f"[check] {label}: launches {self.launches}, modes "
            f"{sorted(self.modes)}, overflow cases {self.overflow_cases}, "
            f"max_abs_err {self.err}")


def checked_runs(graph, apps, expected: dict, label: str,
                 pack_max_bytes: int = 4 << 20, keep: str | None = None,
                 chunk: int = 1 << 25) -> KernelChecks:
    """Cold then warm ``Miner.run`` of each app on the cuda backend, on the
    graph's device, every kernel launch held against its plain version, and
    each count against ``expected``.  ``keep`` names the app whose first
    launch of each kernel keeps its arguments for timing."""
    import torch
    from repro_torch.core import Miner

    on_card = graph.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    checks = KernelChecks(chunk)
    with checks:
        for name, app in apps:
            checks.keep = name == keep
            miner = Miner(graph, app, backend="cuda",
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
    offsets, col, cand_cap = a[1], a[0], kw["cand_cap"]
    parents = 5 * offsets.shape[0] * 4
    if name == "extend_candidates":
        return parents + col.shape[0] * 4 + 4 * cand_cap * 4
    bits = a[6].shape[0] * 4 if kw["conn_mode"] == "bitmap" else 0
    tiles = -(-cand_cap // ref.BLOCK_C) * 4
    base = parents + col.shape[0] * 4 + bits + tiles
    if name == "extend_count":
        return base
    return base + tiles + 2 * kw["out_cap"] * 4    # bases in, row/u out


def time_kernels(kept: dict) -> dict:
    """CUDA-event times of each kernel and its plain version on the
    arguments one main-path launch gave it, the two outputs compared, and
    the memory bound."""
    import torch
    from repro_torch.kernels.extend_fused import ops, ref

    plain = {"extend_candidates": ref.extend_candidates_ref,
             "extend_count": ref.extend_count_ref,
             "extend_scatter": ref.extend_scatter_ref}
    rows = {}
    for name in REPLACES:
        a, kw = kept[name]
        ms, got = cuda_ms(lambda: getattr(ops, name)(*a, **kw), reps=10)
        plain_ms, want = cuda_ms(lambda: plain[name](*a, **kw), reps=2)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        del got, want
        nbytes = bytes_moved(name, a, kw)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "max_abs_err": err}
        log(f"[timing] {name} (cand_cap={kw['cand_cap']}, k={kw['k']}): "
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"from {nbytes} B), max_abs_err {err}")
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


def main_path(graph, expected: dict) -> dict:
    """Cold then warm Miner.run for TC and 4-CF on the cuda backend."""
    import torch
    from repro_torch.core import Miner, make_cf_app, make_tc_app
    from repro_torch.kernels.extend_fused import ops

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for name, app in (("tc", make_tc_app()), ("4-cf", make_cf_app(4))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        miner = Miner(graph, app, backend="cuda")
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
        log(f"[main] {name}: cold {counts['cold']} in {times['cold']:.3f} s, "
            f"warm {counts['warm']} in {times['warm']:.3f} s, plan "
            f"{list(ex.plan.caps)}, replans {ex.n_replans}, peak "
            f"{peak} B, launches {got}, plain calls {plain}")
        for run in ("cold", "warm"):
            if counts[run] != expected[name]:
                raise AssertionError(f"{name} {run}: {counts[run]} != scipy "
                                     f"{expected[name]}")
        if plain:
            raise AssertionError(f"{name}: plain versions ran {plain} times "
                                 "on the main path")
        if min(got.values()) < 1:
            raise AssertionError(f"{name}: a kernel never launched: {got}")
        for k, v in got.items():
            launches[k] += v
        del miner
    return launches


def profile_warm(graph, app, label: str) -> None:
    """Device time by kernel, and the device's idle share, over one warm
    run (``torch.profiler``; falls back to saying so when it records no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Miner

    miner = Miner(graph, app, backend="cuda")
    miner.run()
    miner.run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        miner.run()
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
    log(f"[profile] {label} warm: wall {wall_us:.0f} us, device busy "
        f"{busy_us:.0f} us, idle share {1 - busy_us / wall_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"[profile]   {us:10.0f} us {100 * us / busy_us:5.1f}% "
            f"x{count:<3d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        from repro_torch.graph.generators import rmat
        from repro_torch.core import make_cf_app, make_tc_app
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
    for src, report in build.build_all([ops.SOURCE]).items():
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

    kernels = []
    for name in REPLACES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(checks16.err[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
