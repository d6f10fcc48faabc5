"""Time builds of the segment-sum kernel at the GNN path's and
ogb_products' shapes, each held against the plain version.

    PYTHONPATH=src python -m repro_torch.kernels.segsum.bench \
        [--shapes dense,near,nequip,count,offset,ogb] [SOURCE.cu ...]

Each source (by default the repository's ``csrc/segsum.cu``) must export
the C interface ``sorted_segment_sum`` of that file, which takes
``ops.tile_plan``'s grid; each is built alone with ``kernels/build.py``'s
flags, and one that does not build is reported and skipped.  The inputs,
f32 from seed 0:

- ``dense``: EquiformerV2's aggregation on 128 joined molecules of 30
  atoms, ``[111,360, 6,272]`` into 3,840, ids sorted in runs of 29
  (``molecule_batch``'s edge order);
- ``near``: the same on each molecule's 64 nearest pairs, both ways,
  ``[16,384, 6,272]`` into 3,840: a molecule's pairs drawn uniformly (seed
  0), ids unsorted within a molecule, the two directions in two halves;
- ``nequip``: NequIP's widest message, ``[111,360, 160]``, ``dense``'s ids;
- ``count``: ``segment_mean``'s row counts on ``dense``'s ids, ``[111,360,
  1]`` (scalar loads);
- ``offset``: ``dense`` one element into its storage (scalar loads);
- ``ogb``: ogb_products, ``[61,859,140, 100]`` into 2,449,029, ids uniform
  and sorted.

One line a (source, input): the time of one call in three CUDA-event
samples of 10 calls each (the memset and the sum), the largest difference
from the plain version and whether it is within ``atol=1e-4, rtol=1e-5``,
and the registers, spills and static shared memory of each kernel in the
``-Xptxas -v`` report.  One line an input gives ``index_add_``'s time and
the bound from the bytes (data and ids read once, the sums written once)
at 3.35 TB/s.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.intersect.bench import time_call
from repro_torch.kernels.segsum import ops, ref

HBM_BYTES_PER_S = 3.35e12
SHAPES = ("dense", "near", "nequip", "count", "offset", "ogb")


def molecule_ids(n_mol: int = 128, atoms: int = 30,
                 pairs: int | None = None) -> np.ndarray:
    """Destination ids of ``n_mol`` joined molecules: every ordered pair
    (runs of ``atoms - 1``), or ``pairs`` random pairs a molecule both
    ways."""
    if pairs is None:
        return np.repeat(np.arange(n_mol * atoms), atoms - 1).astype(np.int32)
    rng = np.random.default_rng(0)
    i, j = np.triu_indices(atoms, 1)
    pick = np.stack([rng.choice(i.size, pairs, replace=False)
                     for _ in range(n_mol)])
    off = atoms * np.arange(n_mol)[:, None]
    return np.concatenate([(j[pick] + off).ravel(),
                           (i[pick] + off).ravel()]).astype(np.int32)


def inputs(name: str) -> tuple[torch.Tensor, torch.Tensor, int]:
    g = torch.Generator("cuda").manual_seed(0)
    if name == "ogb":
        n, s, d = 61_859_140, 2_449_029, 100
        seg = torch.sort(torch.randint(0, s, (n,), generator=g,
                                       device="cuda", dtype=torch.int32)
                         ).values
    else:
        ids = molecule_ids(pairs=64 if name == "near" else None)
        seg, s = torch.from_numpy(ids).cuda(), 3840
        d = {"nequip": 160, "count": 1}.get(name, 6272)
    if name == "offset":
        flat = torch.randn(1 + seg.shape[0] * d, generator=g, device="cuda")
        return flat[1:].view(-1, d), seg, s
    data = torch.randn(seg.shape[0], d, generator=g, device="cuda")
    return data, seg, s


def load(src: Path):
    """The source's bound ``sorted_segment_sum`` and its kernels'
    resources, or None and the compiler's error."""
    try:
        fn = ops._lib(src).sorted_segment_sum
    except RuntimeError as exc:
        return None, str(exc)
    return fn, build.kernel_resources(build.build_all([src])[src])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", type=Path,
                        default=[ops.SOURCE])
    parser.add_argument("--shapes", default=",".join(SHAPES))
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {}
    for src in args.sources:
        fn, res = load(src)
        if fn is None:
            print(f"{src}: does not build\n{res}", flush=True)
            continue
        libs[src] = fn
        for name, r in res.items():
            print(f"{src.stem} {name}: {r['registers']} registers, spills "
                  f"{r['spill_stores']} / {r['spill_loads']} B, stack "
                  f"{r['stack']} B, smem {r['smem']} B", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for name in args.shapes.split(","):
        data, seg, s = inputs(name)
        n, d = data.shape
        plan = ops.tile_plan(n, d, data.element_size(), data.data_ptr())
        want = ref.sorted_segment_sum_ref(data, seg, s)
        lib_ms = time_call(lambda: torch.zeros(s, d, device="cuda")
                           .index_add_(0, seg, data), calls=10)
        nbytes = (data.numel() + n + s * d) * 4
        print(f"{name} ({n} x {d} into {s}; {plan}): index_add_ ms "
              + " ".join(f"{t:.4f}" for t in lib_ms)
              + f", bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms from "
              f"{nbytes} B", flush=True)
        out = torch.empty(s, d, device="cuda")
        for src, fn in libs.items():
            def call():
                rc = fn(data.data_ptr(), seg.data_ptr(), n, d, s, 0,
                        int(plan.vector), plan.lanes, plan.group_rows,
                        plan.row_tiles, plan.col_tiles, out.data_ptr(),
                        out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{src}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            close = bool(torch.allclose(out, want, atol=1e-4, rtol=1e-5))
            ms = time_call(call, calls=10)
            print(f"{src.stem} {name}: ms "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f", {nbytes / min(ms) / 1e6:.0f} GB/s, max_abs_err "
                  f"{err:.3g}, close {close}", flush=True)
        del data, seg, want, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
