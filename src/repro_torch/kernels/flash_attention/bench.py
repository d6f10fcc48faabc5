"""Time builds of the f32 flash-attention kernel (``flash_fma``) at the
f32 path's shapes, each held against the plain version.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench \
        [--shapes check,chunk,long,long8k] [--parent REV] \
        [--chunk-tiles 2,5,...] [--samples N] [--profile] [--wrapper] \
        [SOURCE.cu ...]

Each source (by default the repository's ``csrc/flash.cu``) exports the C
interface ``flash_attention`` of that file and is built alone with
``kernels/build.py``'s flags; one that does not build is reported and
skipped.  ``--parent REV`` adds that commit's ``flash.cu``, bound with its
own interface (before the work list: no workspace, no plan): in a git
checkout it is written by ``git show`` to ``build/flash_bench/`` (not
committed); elsewhere the file an earlier run wrote there is used.
``--chunk-tiles`` also times each of those forced chunk lengths
(``ops.fma_plan(chunk_tiles=L)``) on the repository's source;
``--profile`` adds each CUDA kernel's device time a call
(``torch.profiler``), so a split call shows ``flash_fma`` and
``flash_fma_merge`` apart.  ``--wrapper`` times the repository's kernel
through ``ops.flash_attention``, as ``chip_smoke.py`` does, and splits a
call's time: the host's time to return from a call (wrapper and C entry
alone, ``time.perf_counter`` over the same 10-call samples) against the
device's (``torch.profiler``'s kernel time a call).

The inputs, f32, causal, d = 128, 16 query heads over 8 key/value heads,
from seed 0 (``SHAPES``):

- ``check``: ``chip_smoke.py``'s f32 Qwen3-0.6B layer, 1 x 512 over 512;
- ``chunk``: the last of eight 512-token chunks of a 4,096-token
  ``prefill_chunked``, 512 queries over 4,096 keys;
- ``long``: a Qwen3-0.6B-width f32 prefill of 4,096 tokens;
- ``long8k``: the card tests' largest f32 case, 8,192 tokens (not timed
  unless named in ``--shapes``).

One line a (source, input): the time of one call in ``--samples``
CUDA-event samples of 10 calls each, TFLOP/s and the share of the bound,
the largest difference from ``ref.attention_ref`` and whether it is
within atol 2e-5 (rtol 0), and whether two calls gave the same bits.  One
line an input gives ``scaled_dot_product_attention``'s time and the bound:
the kernel's products, 4 d flops a (query, key) pair run three times as
3xTF32, at 495 TFLOP/s (the TF32 tensor cores), or the bytes (q, k, v
read once, o written once) at 3.35 TB/s if more; the line also gives the
figure on the FMA pipes (the flops once at 67 TFLOP/s).  One line a
kernel gives its registers, spills and stack (``-Xptxas -v``), and
``flash_fma``'s dynamic shared memory.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.intersect.bench import time_call

F32_FLOPS_PER_S = 67e12         # the FMA pipes
TF32_FLOPS_PER_S = 495e12       # dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
# b, hq, hkv, lq, lk, d, causal
SHAPES = {"check": (1, 16, 8, 512, 512, 128, True),
          "chunk": (1, 16, 8, 512, 4096, 128, True),
          "long": (1, 16, 8, 4096, 4096, 128, True),
          "long8k": (1, 16, 8, 8192, 8192, 128, True)}
DEFAULT_SHAPES = "check,chunk,long"
PARENT_DIR = build.REPO_ROOT / "build" / "flash_bench"


def pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs computed, queries at the end of the keys."""
    if not causal:
        return lq * lk
    off = lk - lq
    return lq * (off + 1) + lq * (lq - 1) // 2


def parent_source(rev: str) -> Path:
    """``flash.cu`` at commit ``rev``, written under ``PARENT_DIR`` by
    ``git show`` where the repository is a git checkout."""
    path = PARENT_DIR / f"flash-{rev}.cu"
    rel = ops.SOURCE.relative_to(build.REPO_ROOT)
    if (build.REPO_ROOT / ".git").exists():
        text = subprocess.run(["git", "show", f"{rev}:{rel}"],
                              cwd=build.REPO_ROOT, capture_output=True,
                              text=True, check=True).stdout
        PARENT_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    if not path.exists():
        raise SystemExit(f"{path}: no git checkout here to write it from")
    return path


def bind(src: Path):
    """The source's library, whether it has this file's interface, and its
    ``-Xptxas -v`` report; or None and the compiler's error."""
    try:
        lib = build.load(src)
    except RuntimeError as exc:
        return None, False, str(exc)
    current = hasattr(lib, "flash_fma_smem")
    if current:
        ops._lib(src)
    else:                # the parent's interface
        lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib, current, build.build_all([src])[src]


def inputs(shape) -> tuple[torch.Tensor, ...]:
    b, hq, hkv, lq, lk, d, _ = shape
    g = torch.Generator("cuda").manual_seed(0)
    return tuple(torch.randn(s, generator=g, device="cuda")
                 for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))


def caller(lib, current: bool, shape, q, k, v, out, plan=None):
    """A no-argument call of the source's f32 kernel on these tensors."""
    b, hq, hkv, lq, lk, d, causal = shape
    stream = torch.cuda.current_stream().cuda_stream
    scale = d ** -0.5
    if not current:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
                b, hq, hkv, lq, lk, d, int(causal), scale, stream)
    else:
        plan = plan or ops.fma_plan(*shape)
        chunk_tiles, n_items, packed, ws_floats = ops.fma_launch_args(
            plan, d)
        table = None if packed is None else ops.device_table(packed,
                                                             q.device)
        ws = torch.empty(ws_floats, device="cuda")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws_floats else None, 0, b, hq, hkv, lq, lk,
                d, int(causal), scale, chunk_tiles, n_items,
                None if table is None else table.data_ptr(), stream)

    def call():
        rc = lib.flash_attention(*args)
        if rc:
            raise RuntimeError(f"launch failed ({rc}: "
                               f"{lib.flash_error_string(rc).decode()})")
    call.keep = None if not current else (ws, table)   # alive while timed
    return call


def device_ms(call, calls: int = 20) -> dict[str, float]:
    """Each CUDA kernel's device milliseconds a call under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def profile(call, calls: int = 20) -> str:
    """Each CUDA kernel's device time a call, by name."""
    times = device_ms(call, calls)
    return ", ".join(f"{re.sub(r'<.*', '', k)[-40:]} {t:.4f}"
                     for k, t in sorted(times.items(), key=lambda kv: -kv[1]))


def host_us(call, reps: int, calls: int = 10) -> list[float]:
    """Microseconds the host takes to return from one call, in samples of
    ``calls`` calls after a sync (the calls queue work and do not wait)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return times


def wrapper_split(name, shape, q, k, v, direct, samples: int) -> str:
    """The time a call through ``ops.flash_attention`` on these inputs, in
    CUDA events as ``chip_smoke.py`` times it, beside the host's time to
    return from a call through the wrapper and through the C entry
    ``direct`` alone, and the device's kernel time a call."""
    causal = shape[-1]

    def call():
        ops.flash_attention(q, k, v, causal=causal)
    call()
    ev = time_call(call, reps=samples, calls=10)
    host = host_us(call, samples)
    host_c = host_us(direct, samples)
    dev = sum(device_ms(call).values())

    def fmt(xs):
        return " ".join(f"{x:.1f}" for x in xs)
    return (f"wrapper {name}: events ms " + " ".join(f"{t:.4f}" for t in ev)
            + f"; host us a call {fmt(host)} (C entry alone {fmt(host_c)}); "
            f"device ms a call {dev:.4f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", type=Path,
                        default=[ops.SOURCE])
    parser.add_argument("--shapes", default=DEFAULT_SHAPES)
    parser.add_argument("--parent", help="a git revision of flash.cu")
    parser.add_argument("--chunk-tiles", default="",
                        help="forced chunk lengths to time as well")
    parser.add_argument("--samples", type=int, default=5)
    parser.add_argument("--profile", action="store_true",
                        help="each kernel's device time a call, by name")
    parser.add_argument("--wrapper", action="store_true",
                        help="host and device time a call through "
                        "ops.flash_attention")
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sources = [src.resolve() for src in args.sources]
    if args.parent:
        sources.insert(0, parent_source(args.parent))
    libs = {}
    for src in sources:
        lib, current, report = bind(src)
        if lib is None:
            print(f"{src}: does not build\n{report}", flush=True)
            continue
        libs[src] = lib, current
        for name, r in build.kernel_resources(report).items():
            if "flash_fma" not in name:
                continue
            d = int(m[1]) if (m := re.search(r"ILi(\d+)E", name)) else 0
            smem = (f", dynamic smem {lib.flash_fma_smem(d)} B"
                    if current and "merge" not in name else "")
            print(f"{src.stem} {name}: {r['registers']} registers, spills "
                  f"{r['spill_stores']} / {r['spill_loads']} B, stack "
                  f"{r['stack']} B, static smem {r['smem']} B{smem}",
                  flush=True)
    forced = [int(x) for x in args.chunk_tiles.split(",") if x]
    for name in args.shapes.split(","):
        shape = SHAPES[name]
        b, hq, hkv, lq, lk, d, causal = shape
        q, k, v = inputs(shape)
        want = torch.cat([ref.attention_ref(q, k, v, causal=causal,
                                            q_rows=(lo, min(lo + 1024, lq)))
                          for lo in range(0, lq, 1024)], dim=2)
        flops = 4 * b * hq * d * pairs(lq, lk, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
        bound_ms = max(3 * flops / TF32_FLOPS_PER_S,
                       nbytes / HBM_BYTES_PER_S) * 1e3
        fma_ms = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        sdpa = time_call(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             q, k, v, is_causal=causal, enable_gqa=True),
                         reps=args.samples, calls=10)
        plan = ops.fma_plan(*shape)
        print(f"{name} (q {tuple(q.shape)}, k {tuple(k.shape)}; plan "
              f"{len(plan.items) * plan.heads} items of at most "
              f"{plan.chunk_tiles} key tiles, split {plan.split}): bound "
              f"{bound_ms:.4f} ms (3xTF32; {fma_ms:.4f} ms on the FMA "
              f"pipes; {flops} flops), "
              "scaled_dot_product_attention ms "
              + " ".join(f"{t:.4f}" for t in sdpa), flush=True)
        runs = [(src, lib, current, None) for src, (lib, current)
                in libs.items()]
        if ops.SOURCE in libs:
            plans = (ops.fma_plan(*shape, chunk_tiles=L) for L in forced)
            runs += [(ops.SOURCE, libs[ops.SOURCE][0], True, p)
                     for p in plans]
        for src, lib, current, forced_plan in runs:
            label = src.stem + ("" if forced_plan is None
                                else f" L={forced_plan.chunk_tiles}")
            outs = [torch.empty_like(q) for _ in range(2)]
            calls = [caller(lib, current, shape, q, k, v, o, forced_plan)
                     for o in outs]
            for call in calls:
                call()
            torch.cuda.synchronize()
            err = float((outs[0] - want).abs().max())
            close = bool(torch.allclose(outs[0], want, atol=2e-5, rtol=0))
            same = torch.equal(outs[0], outs[1])
            ms = time_call(calls[0], reps=args.samples, calls=10)
            print(f"{label} {name}: ms " + " ".join(f"{t:.4f}" for t in ms)
                  + f", {flops / min(ms) / 1e9:.1f} TFLOP/s, "
                  f"{bound_ms / min(ms):.3f} of the bound, max_abs_err "
                  f"{err:.3g}, close {close}, same bits {same}", flush=True)
            if args.profile:
                print(f"{label} {name}: device ms a call "
                      + profile(calls[0]), flush=True)
            if args.wrapper and src == ops.SOURCE and forced_plan is None:
                print(wrapper_split(name, shape, q, k, v, calls[0],
                                    args.samples), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
