"""Wrappers of the fused extend kernels: check, dispatch, count.

Each wrapper checks its tensors (int32, 1-D, contiguous, one device), then
dispatches on that device: a CPU tensor runs the plain PyTorch version in
``ref.py``; a CUDA tensor launches the CUDA kernel of ``csrc/extend.cu`` on
the current stream, or raises.  There is no fallback on the card.
``LAUNCHES`` counts each wrapper's kernel launches, and nothing else, so a
run can show that its path went through the kernels; ``VARIANT_LAUNCHES``
counts the pruned kernels' launches by the kind of spec they evaluated
(``clique``, ``conjunction``, ``canonical``, ``branches``), by whether it
read labels (``labeled``), and by whether it read the state column
(``state``).

The library is built (``repro_torch.kernels.build``) and loaded at the
first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_int32, launch
from repro_torch.kernels.extend_fused import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "extend.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

# Kernel launches per wrapper, counted where each wrapper launches.
LAUNCHES = dict.fromkeys(("extend_candidates", "extend_count",
                          "extend_scatter", "extend_edge",
                          "extend_pruned_1p"), 0)

# Pruned-kernel launches by spec kind, label reads and state reads.
VARIANT_LAUNCHES = dict.fromkeys(("clique", "conjunction", "canonical",
                                  "branches", "labeled", "state"), 0)

# Vertex slots per edge-induced embedding the edge kernel is built for
# (E + 1 for E = 1 .. 7 edges), as the JAX package's MAX_EDGE_SLOTS.
MAX_EDGE_SLOTS = 8


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.extend_candidates.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 5
    pruned = [_P] * 9 + [_I] * 8 + [_P, _I]
    lib.extend_count.argtypes = pruned + [_P] * 2
    lib.extend_scatter.argtypes = pruned + [_P, _I] + [_P] * 4
    lib.extend_edge.argtypes = [_P] * 10 + [_I] * 6 + [_P] * 6
    lib.extend_pruned_1p.argtypes = pruned + [_I] + [_P] * 6
    for fn in (lib.extend_candidates, lib.extend_count, lib.extend_scatter,
               lib.extend_edge, lib.extend_pruned_1p):
        fn.restype = ctypes.c_int
    lib.extend_error_string.argtypes = [_I]
    lib.extend_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, *args) -> None:
    launch(name, fn, _lib().extend_error_string, *args)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check_parents(name, offsets, starts, emb_flat, vlo, vhi, k):
    n = offsets.shape[0]
    if any(t.shape[0] != n for t in (starts, emb_flat, vlo, vhi)):
        raise ValueError(f"{name}: parent tables differ in length")
    if n % k:
        raise ValueError(f"{name}: {n} parent slots is not a multiple of "
                         f"k={k}")


def extend_candidates(col_idx, offsets, starts, emb_flat, vlo, vhi, *,
                      k: int, cand_cap: int, n_steps: int):
    """Unpruned enumeration for cold inspection: (row, u, src_slot, conn),
    each int32[cand_cap].  See :func:`ref.extend_candidates_ref`."""
    dev = check_int32("extend_candidates", col_idx=col_idx, offsets=offsets,
                 starts=starts, emb_flat=emb_flat, vlo=vlo, vhi=vhi)
    _check_parents("extend_candidates", offsets, starts, emb_flat, vlo, vhi,
                   k)
    if not 1 <= cand_cap <= 1 << 30:
        raise ValueError(f"extend_candidates: cand_cap={cand_cap}")
    if dev.type == "cpu":
        return ref.extend_candidates_ref(col_idx, offsets, starts, emb_flat,
                                         vlo, vhi, k=k, cand_cap=cand_cap,
                                         n_steps=n_steps)
    out = [torch.empty(cand_cap, dtype=torch.int32, device=dev)
           for _ in range(4)]
    lib = _lib()
    _launch("extend_candidates", lib.extend_candidates,
            *map(_ptr, (offsets, starts, emb_flat, vlo, vhi, col_idx)),
            offsets.shape[0], col_idx.shape[0], k, cand_cap,
            *map(_ptr, out))
    LAUNCHES["extend_candidates"] += 1
    return tuple(out)



def _pruned_args(name, col_idx, offsets, starts, emb_flat, vlo, vhi, bits,
                 k, cand_cap, n_vertices, n_words, spec, conn_mode, state,
                 labels):
    dev = check_int32(name, col_idx=col_idx, offsets=offsets, starts=starts,
                      emb_flat=emb_flat, vlo=vlo, vhi=vhi, bits=bits)
    _check_parents(name, offsets, starts, emb_flat, vlo, vhi, k)
    if not 1 <= cand_cap <= 1 << 30:
        raise ValueError(f"{name}: cand_cap={cand_cap}")
    if conn_mode not in ("bitmap", "search"):
        raise ValueError(f"{name}: conn_mode {conn_mode!r} not in "
                         "('bitmap', 'search')")
    if conn_mode == "bitmap" and bits.shape[0] < n_vertices * n_words:
        raise ValueError(f"{name}: bitmap mode needs the full pack "
                         f"({n_vertices} x {n_words} words)")
    if not callable(getattr(spec, "words", None)):
        raise TypeError(f"{name}: spec must be a kernel-readable spec "
                        "(PredicateSpec, CanonicalSpec or BranchSetSpec)")
    if spec.kind == "branches":
        if state is None:
            raise ValueError(f"{name}: a branch set reads the state column")
        check_int32(name, state=state, offsets=offsets)
        if state.shape[0] != offsets.shape[0] // k:
            raise ValueError(f"{name}: state has {state.shape[0]} rows, not "
                             f"{offsets.shape[0] // k}")
    elif state is not None:
        raise ValueError(f"{name}: a {spec.kind} spec reads no state")
    if spec.needs_labels:
        if labels is None:
            raise ValueError(f"{name}: a labeled spec reads the labels")
        check_int32(name, labels=labels, offsets=offsets)
    elif labels is not None:
        raise ValueError(f"{name}: an unlabeled spec reads no labels")
    words = spec.words()
    c_args = (*map(_ptr, (offsets, starts, emb_flat, vlo, vhi, col_idx,
                          bits)),
              None if state is None else _ptr(state),
              None if labels is None else _ptr(labels),
              offsets.shape[0], col_idx.shape[0], k, cand_cap,
              int(conn_mode == "bitmap"), n_words, n_vertices,
              0 if labels is None else labels.shape[0],
              (ctypes.c_int * len(words))(*words), len(words))
    return dev, c_args


def _count_variant(spec) -> None:
    VARIANT_LAUNCHES[spec.kind] += 1
    if spec.needs_labels:
        VARIANT_LAUNCHES["labeled"] += 1
    if spec.kind == "branches":
        VARIANT_LAUNCHES["state"] += 1


def _pruned_outputs(dev, out_cap: int, spec):
    """(row, u[, state]) output buffers: 0, -1 (and 0) where no survivor
    lands."""
    out = [torch.zeros(out_cap, dtype=torch.int32, device=dev),
           torch.full((out_cap,), -1, dtype=torch.int32, device=dev)]
    if spec.writes_state:
        out.append(torch.zeros(out_cap, dtype=torch.int32, device=dev))
    return out


def extend_count(col_idx, offsets, starts, emb_flat, vlo, vhi, bits, *,
                 k: int, cand_cap: int, n_steps: int, n_vertices: int,
                 n_words: int, spec, conn_mode: str, state=None,
                 labels=None):
    """Pass 1 of the pruned extend: survivors per tile of 512 slots.  See
    :func:`ref.extend_count_ref`."""
    dev, c_args = _pruned_args("extend_count", col_idx, offsets, starts,
                               emb_flat, vlo, vhi, bits, k, cand_cap,
                               n_vertices, n_words, spec, conn_mode, state,
                               labels)
    if dev.type == "cpu":
        return ref.extend_count_ref(col_idx, offsets, starts, emb_flat, vlo,
                                    vhi, bits, k=k, cand_cap=cand_cap,
                                    n_steps=n_steps, n_vertices=n_vertices,
                                    n_words=n_words, spec=spec,
                                    conn_mode=conn_mode, state=state,
                                    labels=labels)
    counts = torch.empty(-(-cand_cap // ref.BLOCK_C), dtype=torch.int32,
                         device=dev)
    _launch("extend_count", _lib().extend_count, *c_args, _ptr(counts))
    LAUNCHES["extend_count"] += 1
    _count_variant(spec)
    return counts


def extend_scatter(col_idx, offsets, starts, emb_flat, vlo, vhi, bits,
                   bases, *, k: int, cand_cap: int, out_cap: int,
                   n_steps: int, n_vertices: int, n_words: int, spec,
                   conn_mode: str, state=None, labels=None):
    """Pass 2 of the pruned extend: (row, u), each int32[out_cap], and for a
    branch set the compacted bitmap (row, u, state), with tile i's survivors
    at ``bases[i] + rank``.  See :func:`ref.extend_scatter_ref`."""
    dev, c_args = _pruned_args("extend_scatter", col_idx, offsets, starts,
                               emb_flat, vlo, vhi, bits, k, cand_cap,
                               n_vertices, n_words, spec, conn_mode, state,
                               labels)
    if (bases.dtype != torch.int32 or not bases.is_contiguous()
            or bases.device != dev
            or bases.shape != (-(-cand_cap // ref.BLOCK_C),)):
        raise ValueError("extend_scatter: bases must be int32[n_tiles] on "
                         "the inputs' device")
    if out_cap < 1:
        raise ValueError(f"extend_scatter: out_cap={out_cap}")
    if dev.type == "cpu":
        return ref.extend_scatter_ref(col_idx, offsets, starts, emb_flat,
                                      vlo, vhi, bits, bases, k=k,
                                      cand_cap=cand_cap, out_cap=out_cap,
                                      n_steps=n_steps, n_vertices=n_vertices,
                                      n_words=n_words, spec=spec,
                                      conn_mode=conn_mode, state=state,
                                      labels=labels)
    out = _pruned_outputs(dev, out_cap, spec)
    st_ptr = _ptr(out[2]) if spec.writes_state else None
    _launch("extend_scatter", _lib().extend_scatter, *c_args, _ptr(bases),
            out_cap, _ptr(out[0]), _ptr(out[1]), st_ptr)
    LAUNCHES["extend_scatter"] += 1
    _count_variant(spec)
    return tuple(out)


def extend_edge(col_idx, edge_uid, offsets, starts, slots_flat, vlo,
                eids_flat, usrc, udst, vmask=None, *, n_slots: int,
                cand_cap: int, n_uedges: int, n_vertices: int):
    """Edge-induced enumeration: (row, s, u, new_eid, add), each
    int32[cand_cap].  See :func:`ref.extend_edge_ref`."""
    tensors = dict(col_idx=col_idx, edge_uid=edge_uid, offsets=offsets,
                   starts=starts, slots_flat=slots_flat, vlo=vlo,
                   eids_flat=eids_flat, usrc=usrc, udst=udst)
    if vmask is not None:
        tensors["vmask"] = vmask
    dev = check_int32("extend_edge", **tensors)
    n = offsets.shape[0]
    if any(t.shape[0] != n for t in (starts, slots_flat, vlo)):
        raise ValueError("extend_edge: parent tables differ in length")
    if not 2 <= n_slots <= MAX_EDGE_SLOTS or n % n_slots:
        raise ValueError(f"extend_edge: {n} parent slots for n_slots="
                         f"{n_slots}")
    if eids_flat.shape[0] != n // n_slots * (n_slots - 1):
        raise ValueError("extend_edge: eids_flat is not [cap * E]")
    if edge_uid.shape[0] != col_idx.shape[0]:
        raise ValueError("extend_edge: edge_uid is not [m]")
    if usrc.shape[0] != n_uedges or udst.shape[0] != n_uedges:
        raise ValueError("extend_edge: usrc/udst are not [n_uedges]")
    if vmask is not None and vmask.shape[0] != n_vertices:
        raise ValueError("extend_edge: vmask is not [n_vertices]")
    if not 1 <= cand_cap <= 1 << 30:
        raise ValueError(f"extend_edge: cand_cap={cand_cap}")
    kw = dict(n_slots=n_slots, cand_cap=cand_cap, n_uedges=n_uedges,
              n_vertices=n_vertices)
    if dev.type == "cpu":
        return ref.extend_edge_ref(col_idx, edge_uid, offsets, starts,
                                   slots_flat, vlo, eids_flat, usrc, udst,
                                   vmask, **kw)
    out = [torch.empty(cand_cap, dtype=torch.int32, device=dev)
           for _ in range(5)]
    _launch("extend_edge", _lib().extend_edge,
            *map(_ptr, (offsets, starts, slots_flat, vlo, col_idx, edge_uid,
                        eids_flat, usrc, udst)),
            None if vmask is None else _ptr(vmask),
            n, col_idx.shape[0], n_slots, n_uedges, n_vertices, cand_cap,
            *map(_ptr, out))
    LAUNCHES["extend_edge"] += 1
    return tuple(out)


PLAIN_VERSIONS = (ref.extend_candidates_ref, ref.extend_count_ref,
                  ref.extend_scatter_ref, ref.extend_edge_ref,
                  ref.extend_pruned_1p_ref)


def reset_counts() -> None:
    """Zero ``LAUNCHES``, ``VARIANT_LAUNCHES`` and every plain version's
    ``calls``."""
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0
    for fn in PLAIN_VERSIONS:
        fn.calls = 0


def extend_pruned(col_idx, offsets, starts, emb_flat, vlo, vhi, bits, *,
                  k: int, cand_cap: int, out_cap: int, n_steps: int,
                  n_vertices: int, n_words: int, spec, conn_mode: str,
                  state=None, labels=None):
    """The two-pass pruned extend: count, exclusive scan, scatter.

    Pass 1 counts survivors per tile; an int32 ``torch.cumsum`` of the
    counts (left to PyTorch, as the JAX package leaves it to XLA) gives
    each tile's base and the true survivor total; pass 2 replays the
    predicate and writes each tile's survivors into its disjoint window.
    Returns (row int32[out_cap], u int32[out_cap], [state int32[out_cap],]
    n_surv int32[], tile_counts int32[n_tiles]) — the contract of
    ``repro.kernels.extend_fused.ref.fused_extend_pruned_mp_ref``.
    """
    kw = dict(k=k, cand_cap=cand_cap, n_steps=n_steps,
              n_vertices=n_vertices, n_words=n_words, spec=spec,
              conn_mode=conn_mode, state=state, labels=labels)
    counts = extend_count(col_idx, offsets, starts, emb_flat, vlo, vhi,
                          bits, **kw)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    bases = incl - counts
    out = extend_scatter(col_idx, offsets, starts, emb_flat, vlo, vhi,
                         bits, bases, out_cap=out_cap, **kw)
    return (*out, incl[-1], counts)


def extend_pruned_1p(col_idx, offsets, starts, emb_flat, vlo, vhi, bits, *,
                     k: int, cand_cap: int, out_cap: int, n_steps: int,
                     n_vertices: int, n_words: int, spec, conn_mode: str,
                     state=None, labels=None):
    """The single-pass pruned extend: (row int32[out_cap], u int32[out_cap],
    [state int32[out_cap],] n_surv int32[]), the survivors in slot order,
    and their true count; the state for a branch set.

    One kernel enumerates once; each CTA's tile (four 512-slot sub-tiles)
    finds its base by a decoupled look-back over the tiles before it.  The
    buffers equal the two-pass :func:`extend_pruned`'s bit for bit.  See
    :func:`ref.extend_pruned_1p_ref`.
    """
    dev, c_args = _pruned_args("extend_pruned_1p", col_idx, offsets, starts,
                               emb_flat, vlo, vhi, bits, k, cand_cap,
                               n_vertices, n_words, spec, conn_mode, state,
                               labels)
    if out_cap < 1:
        raise ValueError(f"extend_pruned_1p: out_cap={out_cap}")
    if dev.type == "cpu":
        return ref.extend_pruned_1p_ref(col_idx, offsets, starts, emb_flat,
                                        vlo, vhi, bits, k=k,
                                        cand_cap=cand_cap, out_cap=out_cap,
                                        n_steps=n_steps,
                                        n_vertices=n_vertices,
                                        n_words=n_words, spec=spec,
                                        conn_mode=conn_mode, state=state,
                                        labels=labels)
    out = _pruned_outputs(dev, out_cap, spec)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    # a status word per BLOCK_C slots (at least one per tile) and the
    # ticket, zeroed by the entry point on the stream before its launch
    scratch = torch.empty(-(-cand_cap // ref.BLOCK_C) + 1, dtype=torch.int64,
                          device=dev)
    st_ptr = _ptr(out[2]) if spec.writes_state else None
    _launch("extend_pruned_1p", _lib().extend_pruned_1p, *c_args, out_cap,
            _ptr(scratch), _ptr(out[0]), _ptr(out[1]), st_ptr, _ptr(n_surv))
    LAUNCHES["extend_pruned_1p"] += 1
    _count_variant(spec)
    return (*out, n_surv)
