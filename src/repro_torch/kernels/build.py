"""Build the port's CUDA kernels from the sources in the repository.

Each ``csrc/*.cu`` file has a plain C interface and compiles with ``nvcc``
alone into a shared library that ``ctypes`` loads (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/kernels/`` at the repository
root, named by a hash of their source and flags, and are built at first
use; a changed source builds anew.  Nothing here runs at import time.
"""
# repro: host-module
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> list[Path]:
    """Every CUDA source of the port: ``kernels/<family>/csrc/*.cu``."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_all(sources: list[Path]) -> dict[Path, str]:
    """Compile every source that has no library yet, all ``nvcc`` processes
    started together.  Returns each source's ``-Xptxas -v`` report; for a
    library that was already built, the report its build wrote beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    reports = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            log = out.with_suffix(".log")
            reports[src] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs[src] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for src, (out, tmp, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{stderr}")
            continue
        reports[src] = stdout + stderr
        out.with_suffix(".log").write_text(reports[src])
        os.replace(tmp, out)     # atomic: concurrent builds never race
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build_all([source])
    return ctypes.CDLL(str(library_path(source)))


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def kernel_resources(report: str) -> dict[str, dict]:
    """Per kernel (its mangled name) in an ``-Xptxas -v`` report: the
    registers a thread uses, the spill stores and loads (bytes), the stack
    frame and the static shared memory (bytes)."""
    out: dict[str, dict] = {}
    name = None
    for line in report.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            out[name] = dict.fromkeys(("registers", "spill_stores",
                                       "spill_loads", "stack", "smem"), 0)
        elif name and (m := _FRAME.search(line)):
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := _USED.search(line)):
            out[name].update(registers=int(m.group(1)),
                             smem=int(m.group(2) or 0))
    return out
