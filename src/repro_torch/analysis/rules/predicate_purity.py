"""predicate-purity: predicate specs and hooks must be elementwise, with no
Python control flow over a tensor (counterpart of
``repro.analysis.rules.predicate_purity``).

A kernel predicate runs twice: as the plain PyTorch evaluation of a spec
(``spec(emb_cols, u, src_slot, state, conn[, lab_cols, lab_u])`` on flat
candidate batches, the reference backend's and every wrapper's plain
version) and, through its words, inside the CUDA kernels.  The contract
(``core/api.py``): every operation elementwise over the batch, and no
*Python* control flow over a tensor: ``if u > 3:`` reads the tensor on
the host (a sync on the card, an error for a batch), and a branch the
kernels cannot see makes the two evaluations differ.

Static half (this rule): find predicate-shaped functions (positional
parameters holding the contiguous ``(u, src_slot, state, conn)`` run, or
functions handed to ``to_add=``, ``to_add_bits=``,
``update_state_kernel=`` or ``to_extend_state=``) and flag ``if`` /
``while`` / ``for`` / conditional expressions whose condition (or
iterated value) depends on a tensor parameter, and any host-sync call.
Static constructs stay legal: ``self.<field>`` (a spec's own integer
fields), closure constants, ``len(emb_cols)``, ``range(k)``, iteration
over the ``emb_cols`` / ``conn`` / ``lab_cols`` tuples (static length),
and ``x is None`` tests.

Runtime half: :func:`verify_elementwise` runs a hook on ``device="meta"``
tensors and asserts that the output is the elementwise result: no data is
computed, and a meta tensor raises on any data-dependent op or host read.
Tests run it over the real pattern-compiler factories.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import callgraph as cg
from repro_torch.analysis.core import Finding, rule
from repro_torch.analysis.rules.host_sync import sync_calls

RULE = "predicate-purity"

# the tensor part of the hook signature, in order
SIG_RUN = ("u", "src_slot", "state", "conn")
# tuple-of-tensors params: static length (iterable), tensor elements
CONTAINER_PARAMS = {"emb_cols", "conn", "conn_cols", "lab_cols"}
HOOK_KWARGS = ("to_add", "to_add_bits", "update_state_kernel",
               "to_extend_state")
# parameters that are never tensors: the receiver
HOST_PARAMS = {"self", "cls"}
LAUNDER_CALLS = {"len", "range", "isinstance", "getattr", "hasattr",
                 "callable"}
STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device",
                "needs_labels"}


def _has_sig_run(fn_node) -> bool:
    names = [a.arg for a in fn_node.args.posonlyargs + fn_node.args.args]
    for i in range(len(names) - len(SIG_RUN) + 1):
        if tuple(names[i:i + len(SIG_RUN)]) == SIG_RUN:
            return True
    return False


def _hook_kwarg_names(tree):
    """Names passed as one of :data:`HOOK_KWARGS`."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg not in HOOK_KWARGS:
                continue
            vals = kw.value.elts if isinstance(
                kw.value, (ast.Tuple, ast.List)) else [kw.value]
            out.update(v.id for v in vals if isinstance(v, ast.Name))
    return out


def _is_none_test(node) -> bool:
    return isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)


def _tainted(expr, taint) -> bool:
    """Does ``expr`` depend on a tensor value (laundering-aware)?"""
    if expr is None:
        return False
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Name) and node.id in taint:
            return True
        if isinstance(node, ast.Call) and \
                cg.call_name(node.func) in LAUNDER_CALLS:
            continue  # whole subtree is a host constant
        if isinstance(node, ast.Attribute) and \
                node.attr in STATIC_ATTRS:
            continue
        if _is_none_test(node):
            continue  # identity against None: a host test
        stack.extend(ast.iter_child_nodes(node))
    return False


def _loop_iter_static(node, taint, containers):
    """Is a ``for`` loop's iterable static?  Returns (static, elt_taint).

    Iterating a container param (static-length tuple of tensors) is legal
    but binds *tainted* elements; ``range``/``enumerate`` over static
    values is fully static.
    """
    it = node.iter
    if isinstance(it, ast.Name):
        if it.id in containers:
            return True, True
        return not _tainted(it, taint), it.id in taint
    if isinstance(it, ast.Call):
        name = cg.call_name(it.func)
        if name in ("range", "len"):
            return True, False
        if name in ("enumerate", "zip", "reversed"):
            elt = any(isinstance(a, ast.Name) and a.id in containers
                      for a in it.args)
            static = all(
                (isinstance(a, ast.Name) and a.id in containers)
                or not _tainted(a, taint) for a in it.args)
            return static, elt
    if isinstance(it, (ast.Tuple, ast.List)):
        return True, _tainted(it, taint)
    return not _tainted(it, taint), False


def _target_names(tgt):
    return [n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)]


def _check_hook(fn_node, sf):
    rel = sf.rel.replace("\\", "/")
    args = fn_node.args
    params = [a.arg for a in args.posonlyargs + args.args
              + args.kwonlyargs]
    containers = {p for p in params if p in CONTAINER_PARAMS}
    # every other param but the receiver carries tensors; propagate taint
    # through assignments to a fixpoint (loops can feed back)
    taint = {p for p in params
             if p not in containers and p not in HOST_PARAMS}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                if _tainted(node.value, taint):
                    for tgt in node.targets:
                        for name in _target_names(tgt):
                            if name not in taint:
                                taint.add(name)
                                changed = True
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                if _tainted(node.value, taint) and \
                        node.target.id not in taint:
                    taint.add(node.target.id)
                    changed = True
            elif isinstance(node, ast.For):
                static, elt_taint = _loop_iter_static(node, taint,
                                                      containers)
                if not static or elt_taint:
                    for name in _target_names(node.target):
                        if name not in taint:
                            taint.add(name)
                            changed = True

    hook = fn_node.name
    for node in ast.walk(fn_node):
        if isinstance(node, ast.If) and _tainted(node.test, taint):
            yield Finding(
                RULE, rel, node.lineno, node.col_offset,
                f"hook {hook!r} branches on a tensor with Python `if` — "
                f"use torch.where / boolean algebra (a host read on the "
                f"card, an error for a batch)")
        elif isinstance(node, ast.IfExp) and _tainted(node.test, taint):
            yield Finding(
                RULE, rel, node.lineno, node.col_offset,
                f"hook {hook!r} uses a conditional expression over a "
                f"tensor — use torch.where")
        elif isinstance(node, ast.While) and _tainted(node.test, taint):
            yield Finding(
                RULE, rel, node.lineno, node.col_offset,
                f"hook {hook!r} loops `while` on a tensor — the kernels "
                f"cannot run it; unroll over a static bound")
        elif isinstance(node, ast.For):
            static, _elt = _loop_iter_static(node, taint, containers)
            if not static:
                yield Finding(
                    RULE, rel, node.lineno, node.col_offset,
                    f"hook {hook!r} iterates a tensor with Python `for` — "
                    f"only static-length structures (emb_cols, range(k), "
                    f"the spec's own fields) are iterable")
        elif isinstance(node, ast.Assert) and _tainted(node.test, taint):
            yield Finding(
                RULE, rel, node.lineno, node.col_offset,
                f"hook {hook!r} asserts on a tensor — a host read; drop "
                f"the assert")
    for node, msg in sync_calls(fn_node):
        yield Finding(RULE, rel, node.lineno, node.col_offset,
                      f"hook {hook!r}: {msg}")


@rule(RULE, "predicate specs and to_add/update_state_kernel hooks must "
            "be elementwise, with no Python control flow over a tensor")
def check(project):
    idx = cg.index(project)
    seen = set()
    for mod, fn_node in idx.all_functions():
        if _has_sig_run(fn_node):
            seen.add(id(fn_node))
            yield from _check_hook(fn_node, mod.sf)
    # hooks referenced by name at app-construction sites whose
    # signatures use different parameter names
    for modname, mod in idx.modules.items():
        if not any(f"{k}=" in mod.sf.text for k in HOOK_KWARGS):
            continue
        for name in sorted(_hook_kwarg_names(mod.sf.tree)):
            got = idx.resolve_name(modname, name)
            if isinstance(got, cg.FuncInfo) and id(got.node) not in seen:
                seen.add(id(got.node))
                tgt_mod = idx.modules.get(got.module)
                if tgt_mod is not None:
                    yield from _check_hook(got.node, tgt_mod.sf)


# ---------------------------------------------------------------------------
# Runtime half: used by tests and available to app authors.


def verify_elementwise(hook, k: int, *, batch: int = 8,
                       labeled: bool = False, is_state: bool = False):
    """Run ``hook`` on ``device="meta"`` tensors and assert elementwise-ness
    (the counterpart of the JAX package's ``jax.eval_shape`` check).

    Builds ``(batch,)`` candidate columns: ``emb_cols`` (int32) and
    ``conn`` (bool) as length-``k`` tuples, ``u`` / ``src_slot`` / ``state``
    as int32 columns, and for a labeled hook (``labeled`` or the hook's
    ``needs_labels``) ``lab_cols`` and ``lab_u``.  Checks that the hook
    (a) runs on meta tensors, which raise on any host read or
    data-dependent op, and (b) returns one value per candidate: shape
    ``(batch,)``, dtype bool (a predicate) or int32 (a state hook, such as
    ``BranchSetSpec.bits``, with ``is_state=True``).  Computes no data.
    Raises ``TypeError`` naming the violated contract.
    """
    import torch

    col = torch.empty(batch, dtype=torch.int32, device="meta")
    flag = torch.empty(batch, dtype=torch.bool, device="meta")
    args = [(col,) * k, col, col, col, (flag,) * k]
    if labeled or bool(getattr(hook, "needs_labels", False)):
        args += [(col,) * k, col]
    name = getattr(hook, "__name__", None) or type(hook).__name__
    try:
        out = hook(*args)
    except Exception as e:  # surface the contract, keep the cause
        raise TypeError(f"hook {name!r} does not run on meta tensors (a "
                        f"host read or a data-dependent op): {e}") from e
    shape = tuple(getattr(out, "shape", ()) or ())
    if not isinstance(out, torch.Tensor) or shape != (batch,):
        raise TypeError(f"hook {name!r} is not elementwise: output shape "
                        f"{shape} for batch ({batch},)")
    if is_state:
        if out.dtype != torch.int32:
            raise TypeError(f"state hook {name!r} must return the int32 "
                            f"state column, got {out.dtype}")
    elif out.dtype != torch.bool:
        raise TypeError(f"predicate {name!r} must return a bool keep-mask, "
                        f"got {out.dtype}")
    return out
