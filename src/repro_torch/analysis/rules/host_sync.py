"""host-sync: a warm replay must never wait for the host.

The port's contract (``MiningExecutor._run_once``: "one replay with no host
read"; ``core/phases/reference.py``: "no ``torch.unique``, ``nonzero`` or
boolean indexing"): once a plan exists, a mining run queues its levels on
the card and reads the device once, at the end.  A stray ``.item()`` or
``.tolist()`` in that set, or an op whose output size depends on the data,
blocks the host on the card mid-replay.  No parity test catches it:
results stay right while latency grows, and a replay that syncs cannot be
captured in a CUDA graph.

The rule walks the replay set (:class:`~repro_torch.analysis.callgraph.
ReplaySet`) and flags, outside host-guarded regions and a wrapper's CPU
branch:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or
  stream;
* ``int()`` / ``float()`` / ``bool()`` of a value that is not static:
  shape arithmetic (``.shape``, ``.numel()``, ``len()``, ...) and host
  values are exempt, a host value being a parameter annotated ``bool``,
  ``int``, ``float`` or ``str`` (or a container or ``Optional`` of them)
  or given a constant default, or a name bound from host values only;
* ``np.asarray`` / ``np.array``, and host data copied to the card:
  ``torch.tensor`` / ``torch.as_tensor`` with a ``device=``, and
  ``torch.from_numpy`` (a pageable host-to-device copy waits for the
  device);
* ops whose output size depends on the data: ``nonzero``, ``argwhere``,
  ``unique`` and ``unique_consecutive``, ``masked_select``,
  ``repeat_interleave`` of tensor repeats without ``output_size=``, and
  one-argument ``torch.where``;
* indexing by a boolean mask visible in the source: a comparison, or a
  name bound in the same function to a comparison, ``~``, ``&``, ``|`` of
  masks, ``.bool()`` or a ``torch.is*`` / ``logical_*`` test (a mask
  *store* of a scalar is a ``masked_fill_`` and stays legal);
* ``if`` / ``while`` / a conditional expression on a tensor reduction
  (``.any()``, ``.all()``).

Host-only code is exempted the way the port marks it: the
``traceable = False`` policy flag, ``if host:`` guards derived from
``policy.traceable``, the device dispatch of a kernel wrapper, and the
``# repro: host-module`` marker.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import callgraph as cg
from repro_torch.analysis.core import Finding, rule

RULE = "host-sync"

_COERCIONS = ("int", "float", "bool")
_STATIC_ATTRS = {"shape", "ndim", "size", "itemsize", "dtype",
                 "bit_length", "numel", "dim", "element_size", "nbytes",
                 "data_ptr", "stride", "device", "is_cuda", "type"}
_STATIC_CALLS = {"len", "getattr", "hasattr", "isinstance", "callable"}
_NP_NAMES = {"np", "numpy"}
# attribute calls that copy to the host or wait for the card
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize",
               "block_until_ready"}
# ops whose output size is data-dependent (the card reports the size)
_DYNAMIC_SIZE = {"nonzero", "argwhere", "unique", "unique_consecutive",
                 "masked_select"}
# constructors from host data: a copy to the card where a device is named
_HOST_DATA = {"tensor", "as_tensor", "from_numpy"}
_MASK_CALLS = {"bool", "isin", "isnan", "isinf", "isfinite", "isneginf",
               "isposinf", "signbit", "logical_and", "logical_or",
               "logical_not", "logical_xor"}
_REDUCTIONS = {"any", "all"}
_HOST_TYPES = {"bool", "int", "float", "str", "None", "tuple", "list",
               "Sequence", "Optional", "Union", "Tuple", "List"}
_HOST_BUILTINS = {"min", "max", "int", "float", "bool", "len", "abs",
                  "round", "range", "sum", "tuple", "list", "str",
                  "enumerate", "zip", "divmod"}


def _is_static_expr(expr: ast.expr) -> bool:
    """Is the coerced value a host constant (shape arithmetic)?"""
    if isinstance(expr, ast.Constant):
        return True
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and \
                node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node, ast.Call) and \
                cg.call_name(node.func) in _STATIC_CALLS:
            return True
    return False


def _host_annotation(ann) -> bool:
    """An annotation built only of host scalar types and containers."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = [n.id for n in ast.walk(ann) if isinstance(n, ast.Name)]
    names += [n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)]
    return bool(names) and all(n in _HOST_TYPES or n == "typing"
                               for n in names)


def _constant(expr) -> bool:
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.UnaryOp):
        return _constant(expr.operand)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_constant(e) for e in expr.elts)
    return False


def _names_in(expr) -> list[ast.Name]:
    return [n for n in ast.walk(expr) if isinstance(n, ast.Name)]


def _host_names(fn_node) -> set[str]:
    """Names that hold host values in ``fn_node``: parameters annotated with
    host types or given constant defaults, and locals whose every binding,
    by assignment or as a ``for`` target, is built of host names, module
    constants (upper-case names), host builtins and shape arithmetic."""
    if isinstance(fn_node, ast.Lambda):
        return set()
    args = fn_node.args
    host = set()
    pos = args.posonlyargs + args.args
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    for a, d in [*zip(pos, defaults), *zip(args.kwonlyargs,
                                           args.kw_defaults)]:
        if _host_annotation(a.annotation) or (d is not None and _constant(d)):
            host.add(a.arg)
    bindings: dict[str, list] = {}
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            pairs = [(t, node.value) for t in node.targets]
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            pairs = [(node.target, node.value)]
        elif isinstance(node, (ast.For, ast.comprehension)):
            pairs = [(node.target, node.iter)]
        else:
            continue
        for tgt, value in pairs:
            for n in _names_in(tgt):
                bindings.setdefault(n.id, []).append(value)

    def is_host(expr) -> bool:
        if expr is None or _is_static_expr(expr):
            return expr is not None
        calls = {id(n.func) for n in ast.walk(expr)
                 if isinstance(n, ast.Call)}
        return all(n.id in host or n.id.isupper()
                   or (id(n) in calls and n.id in _HOST_BUILTINS)
                   for n in _names_in(expr))

    # the greatest fixpoint, so a host local may feed its own rebinding
    # (``c = min(int(c), CAP)``); a parameter that is not a host value
    # stays a tensor whatever it is rebound to
    params = {a.arg for a in pos + args.kwonlyargs}
    if args.vararg:
        params.add(args.vararg.arg)
    if args.kwarg:
        params.add(args.kwarg.arg)
    host |= {n for n in bindings if n not in params}
    changed = True
    while changed:
        changed = False
        for name, values in bindings.items():
            if name in host and name not in params and \
                    not all(is_host(v) for v in values):
                host.discard(name)
                changed = True
    return host


def _mask_names(fn_node) -> set[str]:
    """Names bound in ``fn_node`` to a boolean-mask expression."""
    masks: set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and _is_mask(node.value, masks):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id not in masks:
                        masks.add(tgt.id)
                        changed = True
    return masks


def _is_mask(expr, masks: set[str]) -> bool:
    if isinstance(expr, ast.Compare):
        # `x is None` and `x in (...)` are host tests, not masks
        return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                       ast.NotIn)) for op in expr.ops)
    if isinstance(expr, ast.Name):
        return expr.id in masks
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_mask(expr.operand, masks)
    if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(expr.left, masks) or _is_mask(expr.right, masks)
    if isinstance(expr, ast.Call):
        if cg.call_name(expr.func) in _MASK_CALLS:
            return True
        return any(kw.arg == "dtype" and cg.call_name(kw.value) == "bool"
                   for kw in expr.keywords)
    return False


def _index_parts(sub: ast.Subscript):
    sl = sub.slice
    return sl.elts if isinstance(sl, ast.Tuple) else [sl]


def _is_reduction_test(test) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in _REDUCTIONS:
            return True
    return False


def sync_calls(fn_node, host: set[str] = frozenset()):
    """``(node, message)`` for each host-sync construct in ``fn_node``
    outside host guards.  ``host`` names hold host values (their
    coercions are exempt)."""
    name = getattr(fn_node, "name", "<lambda>")
    where = f"(function {name!r})"
    masks = _mask_names(fn_node)
    for node in cg.iter_unguarded(fn_node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) and \
                _is_reduction_test(node.test):
            yield node, (f"branching on a tensor reduction (.any()/.all())"
                         f" reads it on the host {where}; keep the "
                         f"decision on the device (torch.where)")
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                any(_is_mask(p, masks) for p in _index_parts(node)):
            yield node, (f"indexing by a boolean mask sizes its output on "
                         f"the host {where}; keep static shapes (a "
                         f"sentinel, torch.where, a sort)")
        elif isinstance(node, ast.Call):
            msg = _call_message(node, host, where)
            if msg is not None:
                yield node, msg


def _call_message(node: ast.Call, host: set[str], where: str):
    fn = node.func
    attr = fn.attr if isinstance(fn, ast.Attribute) else None
    if attr in _SYNC_ATTRS:
        return (f".{attr}() waits for the device inside the replay set "
                f"{where}")
    if attr == "to" and _to_cpu(node):
        return f".to('cpu') copies to the host inside the replay set {where}"
    if attr in ("asarray", "array") and isinstance(fn.value, ast.Name) \
            and fn.value.id in _NP_NAMES:
        return (f"np.{attr}() materializes a tensor on the host inside "
                f"the replay set {where}")
    name = cg.call_name(fn)
    if name in _HOST_DATA and not (name != "from_numpy" and _on_cpu(node)):
        return (f"{name}() copies host data to the card (a pageable copy "
                f"waits for the device) inside the replay set {where}; "
                f"make it before the replay or fill it on the device "
                f"(torch.full)")
    if name in _DYNAMIC_SIZE:
        return (f"{name}() has a data-dependent output size, read from "
                f"the device {where}; use a static-shape form")
    if name == "repeat_interleave" and not any(
            kw.arg == "output_size" for kw in node.keywords):
        torch_form = isinstance(fn, ast.Name) or (
            isinstance(fn.value, ast.Name) and fn.value.id == "torch")
        args = node.args[1:] if torch_form and len(node.args) > 1 \
            else node.args[:1] if torch_form else node.args
        reps = next((kw.value for kw in node.keywords
                     if kw.arg == "repeats"), args[0] if args else None)
        if reps is not None and not _constant(reps):
            return (f"repeat_interleave() of tensor repeats without "
                    f"output_size= sizes its output on the host {where}")
    if name == "where" and len(node.args) == 1 and not node.keywords:
        return (f"one-argument where() is nonzero(), a data-dependent "
                f"size {where}")
    if isinstance(fn, ast.Name) and fn.id in _COERCIONS and node.args:
        if not any(_is_static_expr(a) or _all_host(a, host)
                   for a in node.args):
            return (f"{fn.id}() coerces a tensor to a host scalar inside "
                    f"the replay set {where}; keep it on the device or "
                    f"guard the host path")
    return None


def _all_host(expr, host: set[str]) -> bool:
    names = _names_in(expr)
    return bool(names) and all(n.id in host or n.id.isupper()
                               for n in names)


def _on_cpu(node: ast.Call) -> bool:
    """A tensor constructor that stays on the host: no ``device=``, or the
    constant ``"cpu"``."""
    dev = next((kw.value for kw in node.keywords if kw.arg == "device"),
               None)
    return dev is None or (isinstance(dev, ast.Constant)
                           and dev.value == "cpu")


def _to_cpu(node: ast.Call) -> bool:
    vals = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if isinstance(v, ast.Call) and cg.call_name(v.func) == "device" \
                and v.args and isinstance(v.args[0], ast.Constant) \
                and v.args[0].value == "cpu":
            return True
    return False


@rule(RULE, "no host sync (.item/.tolist/.cpu/int()/data-dependent sizes/"
            "mask indexing) reachable from a warm replay")
def check(project):
    replay = cg.replay_set(project)
    for fn_node, sf, _modname, _cls in replay.items():
        rel = sf.rel.replace("\\", "/")
        for node, msg in sync_calls(fn_node, _host_names(fn_node)):
            yield Finding(RULE, rel, node.lineno, node.col_offset, msg)
