"""Time builds of the intersection kernel on the fused triangle count's
launch, each held against the plain version.

    PYTHONPATH=src python -m repro_torch.kernels.intersect.bench \
        [--scale 16] [SOURCE.cu ...]

Each source (by default the repository's ``csrc/intersect.cu``) must export
the C interface ``intersect_count`` of that file; all are built together
with ``kernels/build.py``'s flags.  The arguments are those
``triangle_count_fused`` gives the kernel on ``rmat(scale, 16, seed=0)``,
in four orders and id ranges:

- ``sorted``: the pairs in CSR order, so a source's pairs are neighbours;
- ``shuffled``: the same pairs in a random order (seed 0);
- ``spread``: sorted, with every id passed through a strictly increasing
  map with random gaps of 1 to 7 (seed 0), which keeps every row sorted and
  every count and widens each row's span about four times, past the
  kernel's bitmap for most pairs at scale 16;
- ``spread-shuffled``: both.

One line a (source, input): the time of one call in three CUDA-event
samples of 20 calls each, whether the output equals the plain version's,
the share of pairs on each of the kernel's paths (``ops.kernel_paths``),
and the registers, spills and static shared memory of the ``-Xptxas -v``
report.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.graph.dag import orient_dag
from repro_torch.graph.generators import rmat
from repro_torch.kernels import build
from repro_torch.kernels.intersect import ops, ref


def launch_args(scale: int, device="cuda") -> tuple[dict, dict]:
    """The fused triangle count's kernel arguments on RMAT-``scale``, by
    input name, and the keyword arguments."""
    dag = orient_dag(rmat(scale, 16, seed=0, device=device))
    src, dst = (t.long() for t in dag.edge_list())
    rp = dag.row_ptr
    kw = dict(max_deg=dag.max_degree,
              n_steps=max(1, math.ceil(math.log2(dag.max_degree + 1))))
    sorted_ = (dag.col_idx, rp[src], rp[src + 1], rp[dst], rp[dst + 1])
    gaps = np.random.default_rng(0).integers(1, 8, dag.n_vertices)
    ids = torch.from_numpy(np.cumsum(gaps) - 1).to(src.device)
    spread = (ids[dag.col_idx.long()].int(), *sorted_[1:])
    order = torch.randperm(src.shape[0],
                           generator=torch.Generator().manual_seed(0))

    def shuffled(a):
        return (a[0], *(t[order.to(t.device)].contiguous() for t in a[1:]))
    return {"sorted": sorted_, "shuffled": shuffled(sorted_),
            "spread": spread, "spread-shuffled": shuffled(spread)}, kw


def time_call(fn, reps: int = 3, calls: int = 20) -> list[float]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", type=Path,
                        default=[ops.SOURCE])
    parser.add_argument("--scale", type=int, default=16)
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    inputs, kw = launch_args(args.scale)
    want, shares = {}, {}
    for name, a in inputs.items():
        want[name] = ref.intersect_count_ref(*a, **kw)
        counts = ops.kernel_paths(*a, **kw).long().bincount(
            minlength=len(ops.PATHS)).tolist()
        shares[name] = " ".join(f"{p} {c / a[1].shape[0]:.4f}"
                                for p, c in zip(ops.PATHS, counts))
    print(f"rmat{args.scale}: {inputs['sorted'][1].shape[0]} pairs, {kw}")
    reports = build.build_all(args.sources)
    stream = torch.cuda.current_stream().cuda_stream
    for src in args.sources:
        (res,) = build.kernel_resources(reports[src]).values()
        lib = ctypes.CDLL(str(build.library_path(src)))
        fn = lib.intersect_count
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        for name, a in inputs.items():
            out = torch.empty_like(a[1])
            ptrs = [t.data_ptr() for t in a]

            def call():
                rc = fn(*ptrs, a[0].shape[0], a[1].shape[0], kw["max_deg"],
                        kw["n_steps"], out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{src}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            equal = torch.equal(out, want[name])
            ms = " ".join(f"{t:.4f}" for t in time_call(call))
            print(f"{src.stem} {name}: ms {ms}, equal {equal}, "
                  f"{res['registers']} registers, spills "
                  f"{res['spill_stores']} / {res['spill_loads']} B, smem "
                  f"{res['smem']} B; paths {shares[name]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
