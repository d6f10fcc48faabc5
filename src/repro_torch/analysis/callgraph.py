"""Module/class/function index and the replay-set call-graph walk
(counterpart of ``repro.analysis.callgraph``).

This is not a general Python call graph: it is exactly the resolution the
port's contracts need, tuned to its idioms:

* absolute imports rooted at the analyzed package, at module level and
  inside functions (``from repro_torch.core import engine as E`` in a
  method), ``from pkg import submodule`` aliases, and one level of
  package re-export;
* class attribute seams resolved against the *concrete* receiver class
  (``super()`` dispatch included), among them the port's kernel seam: a
  class attribute holding a wrapper's *name*, called as
  ``getattr(ops, self._pruned_kernel)(...)``, resolves to that ``ops``
  function, so a ``cuda-1p`` subclass reaches its own kernel;
* the ``traceable`` class flag: classes declaring ``traceable = False``
  (the host inspection's capacity policy) are never entered;
* host-guard awareness: statements under ``if host:`` /
  ``if not policy.traceable:`` / ``if _T.on:`` / ``if collect_stats:`` /
  ``if _T.sync_enabled():`` (and the early-``return`` form) are host-only
  regions, which the walk neither reports nor follows calls out of;
* a kernel wrapper's dispatch on its tensors' device
  (``if dev.type == "cpu": return ref.…``): on the card the plain version
  never runs inside a replay, so the walk skips the CPU branch and goes on
  down the card's.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from repro_torch.analysis.core import Project, SourceFile

# Names whose truthiness marks a host-only (or obs-enabled) region.
HOST_GUARD_NAMES = {"host", "collect_stats", "checkpoint_cb"}
HOST_GUARD_ATTRS = {"traceable", "on"}
HOST_GUARD_CALLS = {"sync_enabled"}


@dataclasses.dataclass
class FuncInfo:
    qualname: str                 # module-relative dotted qualname
    module: str                   # dotted module name
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    sf: SourceFile
    cls: Optional["ClassInfo"] = None


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    node: ast.ClassDef
    sf: SourceFile
    bases: list[ast.expr] = dataclasses.field(default_factory=list)
    methods: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)  # name -> expr


@dataclasses.dataclass
class ModInfo:
    name: str
    sf: SourceFile
    functions: dict = dataclasses.field(default_factory=dict)
    classes: dict = dataclasses.field(default_factory=dict)
    # local name -> ("mod", dotted) | ("obj", dotted, original_name)
    imports: dict = dataclasses.field(default_factory=dict)


class ProjectIndex:
    """Symbol tables for every module in a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.modules: dict[str, ModInfo] = {}
        for sf in project.files:
            name = project.module_name(sf)
            self.modules[name] = ModInfo(name=name, sf=sf)
        for mod in self.modules.values():
            for node in mod.sf.tree.body:
                self._index_stmt(mod, node)
            # imports inside functions (the port imports lazily to break
            # cycles) bind too, where the module level does not
            for node in ast.walk(mod.sf.tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    self._index_import(mod, node, override=False)

    # -- indexing ----------------------------------------------------------

    def _index_stmt(self, mod: ModInfo, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = FuncInfo(node.name, mod.name, node,
                                                mod.sf)
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo(name=node.name, module=mod.name, node=node,
                           sf=mod.sf, bases=list(node.bases))
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    ci.methods[item.name] = FuncInfo(
                        f"{node.name}.{item.name}", mod.name, item,
                        mod.sf, cls=ci)
                elif isinstance(item, ast.Assign):
                    for tgt in item.targets:
                        if isinstance(tgt, ast.Name):
                            ci.attrs[tgt.id] = item.value
                elif (isinstance(item, ast.AnnAssign)
                      and isinstance(item.target, ast.Name)
                      and item.value is not None):
                    ci.attrs[item.target.id] = item.value
            mod.classes[node.name] = ci
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            self._index_import(mod, node, override=True)
        elif isinstance(node, (ast.If, ast.Try)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    self._index_stmt(mod, child)

    def _index_import(self, mod: ModInfo, node, override: bool) -> None:
        bind = (mod.imports.__setitem__ if override
                else mod.imports.setdefault)
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                bind(local, ("mod", target))
            return
        base = self._resolve_from(mod, node)
        if base is None:
            return
        for alias in node.names:
            bind(alias.asname or alias.name, ("obj", base, alias.name))

    def _resolve_from(self, mod: ModInfo,
                      node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        parts = mod.name.split(".")
        # a package's own dotted name ends at its directory
        is_pkg = mod.sf.rel.endswith("__init__.py")
        cut = len(parts) - (node.level - 1 if is_pkg else node.level)
        if cut < 1:
            return None
        base = parts[:cut]
        if node.module:
            base.append(node.module)
        return ".".join(base)

    # -- symbol resolution -------------------------------------------------

    def module_alias(self, modname: str, name: str) -> Optional[str]:
        """The dotted module a local ``name`` of ``modname`` binds, if it
        binds one of the analyzed tree's modules."""
        mod = self.modules.get(modname)
        imp = mod.imports.get(name) if mod else None
        if imp is None:
            return None
        dotted = imp[1] if imp[0] == "mod" else f"{imp[1]}.{imp[2]}"
        return dotted if dotted in self.modules else None

    def resolve_name(self, modname: str, name: str, _depth: int = 0):
        """A name visible in ``modname`` -> FuncInfo | ClassInfo | None."""
        mod = self.modules.get(modname)
        if mod is None or _depth > 8:
            return None
        if name in mod.functions:
            return mod.functions[name]
        if name in mod.classes:
            return mod.classes[name]
        imp = mod.imports.get(name)
        if imp is None or imp[0] == "mod":
            return None
        _, target_mod, orig = imp
        return self.resolve_name(target_mod, orig, _depth + 1)

    def resolve_base(self, ci: ClassInfo,
                     base: ast.expr) -> Optional[ClassInfo]:
        if isinstance(base, ast.Name):
            out = self.resolve_name(ci.module, base.id)
        elif isinstance(base, ast.Attribute) and isinstance(base.value,
                                                            ast.Name):
            target = self.module_alias(ci.module, base.value.id)
            out = (self.resolve_name(target, base.attr)
                   if target is not None else None)
        else:
            out = None
        return out if isinstance(out, ClassInfo) else None

    def mro(self, ci: ClassInfo) -> list[ClassInfo]:
        """Own-class-first linearization (good enough: single bases)."""
        out, stack, seen = [], [ci], set()
        while stack:
            c = stack.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            out.append(c)
            for b in c.bases:
                rb = self.resolve_base(c, b)
                if rb is not None:
                    stack.append(rb)
        return out

    def effective_attr(self, ci: ClassInfo, name: str):
        for c in self.mro(ci):
            if name in c.attrs:
                return c.attrs[name]
        return None

    def effective_method(self, ci: ClassInfo,
                         name: str) -> Optional[FuncInfo]:
        for c in self.mro(ci):
            if name in c.methods:
                return c.methods[name]
        return None

    def inherits_from(self, ci: ClassInfo, base_name: str) -> bool:
        return any(c.name == base_name for c in self.mro(ci))

    def const_attr(self, ci: ClassInfo, name: str):
        """Effective class attr as a Python constant, else None."""
        expr = self.effective_attr(ci, name)
        if isinstance(expr, ast.Constant):
            return expr.value
        return None

    def all_classes(self):
        for mod in self.modules.values():
            yield from mod.classes.values()

    def all_functions(self):
        """Every function/method, including nested defs."""
        for mod in self.modules.values():
            for node in ast.walk(mod.sf.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield mod, node

    def visible_classes(self, modname: str) -> list[ClassInfo]:
        """Classes defined in or imported into ``modname``, and those of
        the modules it binds by name."""
        mod = self.modules.get(modname)
        if mod is None:
            return []
        out = list(mod.classes.values())
        for local, imp in mod.imports.items():
            target = self.module_alias(modname, local)
            if target is not None:
                out.extend(self.modules[target].classes.values())
            elif imp[0] == "obj":
                got = self.resolve_name(imp[1], imp[2])
                if isinstance(got, ClassInfo):
                    out.append(got)
        return out


# ---------------------------------------------------------------------------
# Host-guard-aware traversal


def call_name(fn: ast.expr):
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def is_host_guard(test: ast.expr) -> bool:
    """Does ``test`` condition on a host/obs flag the warm path pins?"""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in HOST_GUARD_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in \
                HOST_GUARD_ATTRS:
            return True
        if isinstance(node, ast.Call) and \
                call_name(node.func) in HOST_GUARD_CALLS:
            return True
    return False


def cpu_branch(test: ast.expr) -> Optional[str]:
    """For a dispatch on a tensor's device, ``<x>.type == "cpu"`` (or
    ``!=``), the branch that runs on the CPU: ``"body"`` or ``"orelse"``;
    None for any other test."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Eq, ast.NotEq))):
        return None
    sides = (test.left, test.comparators[0])
    has_type = any(isinstance(s, ast.Attribute) and s.attr == "type"
                   for s in sides)
    has_cpu = any(isinstance(s, ast.Constant) and s.value == "cpu"
                  for s in sides)
    if not (has_type and has_cpu):
        return None
    return "body" if isinstance(test.ops[0], ast.Eq) else "orelse"


def _leaves(body: list[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise))


def _ends_obs_fast_path(node: ast.If) -> bool:
    """``if not <guard>: return ...``: the guard's off path leaves early,
    so the rest of the block runs only with the guard on.  (A guarded
    ``raise``, or ``if <guard>: return``, leaves the rest on the replay
    path.)"""
    return (isinstance(node.test, ast.UnaryOp)
            and isinstance(node.test.op, ast.Not) and bool(node.body)
            and isinstance(node.body[-1],
                           (ast.Return, ast.Continue, ast.Break)))


_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _iter_block(items, skip_nested):
    for item in items:
        if not isinstance(item, ast.AST):
            continue
        if isinstance(item, ast.If):
            if is_host_guard(item.test):
                if _ends_obs_fast_path(item):
                    return        # the rest of the block is the host path
                continue
            side = cpu_branch(item.test)
            if side is not None:
                card = item.orelse if side == "body" else item.body
                yield from _iter_block(card, skip_nested)
                if side == "orelse" and _leaves(item.body):
                    return        # the rest of the block is the CPU path
                continue
        yield from _iter_one(item, skip_nested)


def _iter_one(value, skip_nested):
    if isinstance(value, ast.IfExp):
        if is_host_guard(value.test):
            return
        side = cpu_branch(value.test)
        if side is not None:
            yield from _iter_one(value.orelse if side == "body"
                                 else value.body, skip_nested)
            return
    yield value
    if skip_nested and isinstance(value, _NESTED):
        return
    yield from iter_unguarded(value, skip_nested=skip_nested)


def iter_unguarded(node: ast.AST, *, skip_nested: bool = True):
    """Yield descendants of ``node`` outside host-guarded regions.

    Skips ``if <host-guard>:`` statements wholesale (both branches are
    picked by a flag the warm path pins); a negated guard's early return
    (``if not _T.on: return ...``) additionally ends the scan of the
    remaining statements in that block, which are then the obs-enabled
    slow path.
    A dispatch on a tensor's device yields only the card's branch.  With
    ``skip_nested`` (default) nested function/class definitions are
    yielded but not entered: they are separate call-graph nodes.
    """
    for _field, value in ast.iter_fields(node):
        if isinstance(value, list):
            yield from _iter_block(value, skip_nested)
        elif isinstance(value, ast.AST):
            yield from _iter_one(value, skip_nested)


def local_defs(fn_node: ast.AST) -> dict[str, ast.AST]:
    """Nested function definitions of ``fn_node`` by name."""
    out = {}
    for item in ast.walk(fn_node):
        if item is fn_node:
            continue
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(item.name, item)
    return out


def is_ops_module(sf: SourceFile) -> bool:
    """A kernel family's wrappers: ``kernels/<family>/ops.py``."""
    parts = sf.rel.replace("\\", "/").split("/")
    return len(parts) >= 3 and parts[-3] == "kernels" and \
        parts[-1] == "ops.py"


# ---------------------------------------------------------------------------
# The replay set


class ReplaySet:
    """Functions reachable from what runs inside a warm replay, guard-aware.

    Roots: ``MiningExecutor._run_once`` (one replay with no host read), the
    engine's level loop and bounded runs (``run_level_loop``,
    ``bounded_mine_vertex``, ``bounded_mine_edge``), the methods of
    ``traceable = True`` policy classes, the op methods of ``PhaseBackend``
    descendants, every public wrapper of ``kernels/*/ops.py``, and the app
    hooks handed to ``MiningApp(...)`` (which the phase ops call).  The
    walk follows name, import, ``self``/``super``, method-name attribute
    calls and the string kernel seam; it never enters host-marked modules
    or ``traceable = False`` classes, and never follows calls out of
    host-guarded regions or a wrapper's CPU branch.  Build scripts,
    benchmarks, launchers and CSR construction are not roots.
    """

    NAMED_ROOTS = ("run_level_loop", "bounded_mine_vertex",
                   "bounded_mine_edge")
    # MiningApp fields whose hooks a replay calls
    APP_HOOKS = ("to_extend", "to_extend_state", "to_add",
                 "to_add_vertex_mask", "update_state_kernel",
                 "state_histogram", "get_pattern", "init_state")
    METHOD_ROOTS = (("MiningExecutor", "_run_once"),)
    BACKEND_BASE = "PhaseBackend"
    NON_OP_METHODS = {"capabilities", "__repr__", "__init__"}

    def __init__(self, idx: ProjectIndex):
        self.idx = idx
        # (function, receiver class) -> record: a method is walked once
        # per receiver, since its seams resolve against the receiver
        self.traced: dict[tuple[int, int], tuple[ast.AST, SourceFile, str,
                                                 Optional[ClassInfo]]] = {}
        self._walk()

    def _roots(self):
        idx = self.idx
        roots = []
        for modname, mod in idx.modules.items():
            sf = mod.sf
            if sf.is_host_module:
                continue
            if is_ops_module(sf):
                for name, fi in mod.functions.items():
                    if not name.startswith("_"):
                        roots.append((fi.node, sf, modname, None))
            roots.extend(self._hook_roots(mod))
            for fname in self.NAMED_ROOTS:
                fi = mod.functions.get(fname)
                if fi is not None:
                    roots.append((fi.node, sf, modname, None))
            for ci in mod.classes.values():
                for cname, mname in self.METHOD_ROOTS:
                    if ci.name == cname and mname in ci.methods:
                        roots.append((ci.methods[mname].node, sf, modname,
                                      ci))
                traceable = idx.const_attr(ci, "traceable")
                is_backend = idx.inherits_from(ci, self.BACKEND_BASE)
                if traceable is not True and not is_backend:
                    continue
                # inherited methods too, bound to this receiver (a
                # subclass's seams are its own)
                for c in idx.mro(ci):
                    for mname, mi in c.methods.items():
                        if idx.effective_method(ci, mname) is not mi or (
                                is_backend and mname in self.NON_OP_METHODS):
                            continue
                        roots.append((mi.node, idx.modules[mi.module].sf,
                                      mi.module, ci))
        return roots

    def _hook_roots(self, mod: ModInfo):
        """The app hooks handed to ``MiningApp(...)`` in ``mod``: a named
        function (a closure of the enclosing factory first), a lambda, or
        the closures a hook factory ``_make_x(...)`` defines."""
        idx = self.idx
        if "MiningApp(" not in mod.sf.text:
            return
        for call, encl in _calls_in_scope(mod.sf.tree, None):
            if call_name(call.func) != "MiningApp":
                continue
            nested = local_defs(encl) if encl is not None else {}
            for kw in call.keywords:
                v = kw.value
                if kw.arg not in self.APP_HOOKS:
                    continue
                if isinstance(v, ast.Lambda):
                    yield v, mod.sf, mod.name, None
                elif isinstance(v, ast.Name) and v.id in nested:
                    yield nested[v.id], mod.sf, mod.name, None
                elif isinstance(v, (ast.Name, ast.Call)):
                    name = v.id if isinstance(v, ast.Name) else \
                        call_name(v.func)
                    got = idx.resolve_name(mod.name, name or "")
                    if not isinstance(got, FuncInfo):
                        continue
                    fmod = idx.modules[got.module]
                    if isinstance(v, ast.Name):
                        yield got.node, fmod.sf, got.module, None
                    else:
                        for node in local_defs(got.node).values():
                            yield node, fmod.sf, got.module, None

    def _walk(self) -> None:
        stack = list(self._roots())
        while stack:
            node, sf, modname, cls = stack.pop()
            key = (id(node), id(cls))
            if key in self.traced:
                continue
            self.traced[key] = (node, sf, modname, cls)
            stack.extend(self.callees(node, sf, modname, cls))

    def callees(self, fn_node: ast.AST, sf: SourceFile, modname: str,
                cls: Optional[ClassInfo]):
        """Resolved (node, sf, modname, cls) callees of one function."""
        idx = self.idx
        nested = local_defs(fn_node)
        for node in iter_unguarded(fn_node):
            if not isinstance(node, ast.Call):
                continue
            for tgt in resolve_call(idx, node, sf, modname, cls, nested):
                _tnode, tsf, _tmod, tcls = tgt
                if tsf.is_host_module:
                    continue
                if tcls is not None and \
                        idx.const_attr(tcls, "traceable") is False:
                    continue
                yield tgt

    def items(self):
        """One record per function reached (whatever its receivers)."""
        return list({id(rec[0]): rec for rec in self.traced.values()}
                    .values())


def _calls_in_scope(node: ast.AST, encl):
    """``(call, innermost enclosing function or None)`` under ``node``."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Call):
            yield child, encl
        inner = child if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef)) else encl
        yield from _calls_in_scope(child, inner)


def index(project: Project) -> ProjectIndex:
    """The project's :class:`ProjectIndex`, built once per project."""
    if getattr(project, "_index", None) is None:
        project._index = ProjectIndex(project)
    return project._index


def replay_set(project: Project) -> ReplaySet:
    """The project's :class:`ReplaySet`, built once per project."""
    if getattr(project, "_replay", None) is None:
        project._replay = ReplaySet(index(project))
    return project._replay


def _string_seam(idx: ProjectIndex, call: ast.Call, modname: str,
                 cls: Optional[ClassInfo]):
    """``getattr(<module>, <name>)`` as a callee: the module's function of
    that name, the name a string constant or a class attribute holding one
    (receiver-bound)."""
    if call_name(call.func) != "getattr" or len(call.args) < 2:
        return None
    recv, key = call.args[0], call.args[1]
    if not isinstance(recv, ast.Name):
        return None
    target = idx.module_alias(modname, recv.id)
    if target is None:
        return None
    if isinstance(key, ast.Attribute) and isinstance(key.value, ast.Name) \
            and key.value.id == "self" and cls is not None:
        key = idx.effective_attr(cls, key.attr)
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return idx.resolve_name(target, key.value)
    return None


def resolve_call(idx: ProjectIndex, call: ast.Call, sf: SourceFile,
                 modname: str, cls: Optional[ClassInfo], nested: dict):
    """Best-effort targets of one call: (node, sf, module, cls) tuples.

    Resolution order mirrors the codebase's dispatch idioms: nested defs,
    module/import names, the string kernel seam, ``super()``/``self`` with
    receiver-class binding (``staticmethod`` class-attr seams included),
    imported submodule attributes, then method-name matching over classes
    visible in the calling module.
    """
    fn = call.func
    out = []

    def add_funcinfo(fi):
        if isinstance(fi, FuncInfo):
            mod = idx.modules.get(fi.module)
            if mod is not None:
                out.append((fi.node, mod.sf, fi.module, fi.cls))
        elif isinstance(fi, ClassInfo):
            if idx.const_attr(fi, "traceable") is False:
                return
            init = idx.effective_method(fi, "__init__")
            if init is not None:
                mod = idx.modules.get(init.module)
                if mod is not None:
                    out.append((init.node, mod.sf, init.module, fi))

    def add_methods(attr):
        for ci in idx.visible_classes(modname):
            mi = idx.effective_method(ci, attr)
            if mi is not None and \
                    idx.const_attr(ci, "traceable") is not False:
                mod2 = idx.modules.get(mi.module)
                if mod2 is not None:
                    out.append((mi.node, mod2.sf, mi.module, ci))

    if isinstance(fn, ast.Name):
        if fn.id in nested:
            out.append((nested[fn.id], sf, modname, cls))
        else:
            add_funcinfo(idx.resolve_name(modname, fn.id))
    elif isinstance(fn, ast.Call):
        add_funcinfo(_string_seam(idx, fn, modname, cls))
    elif isinstance(fn, ast.Attribute):
        recv = fn.value
        if isinstance(recv, ast.Call) and \
                call_name(recv.func) == "super" and cls is not None:
            # super().m(...) -> parent method, receiver class preserved
            for c in idx.mro(cls)[1:]:
                if fn.attr in c.methods:
                    mi = c.methods[fn.attr]
                    mod = idx.modules.get(mi.module)
                    if mod is not None:
                        out.append((mi.node, mod.sf, mi.module, cls))
                    break
        elif isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                and cls is not None:
            mi = idx.effective_method(cls, fn.attr)
            if mi is not None:
                mod = idx.modules.get(mi.module)
                if mod is not None:
                    out.append((mi.node, mod.sf, mi.module, cls))
            else:
                # class-attr seam: self._kernel = staticmethod(fn)
                name = attr_value_name(idx.effective_attr(cls, fn.attr))
                if name is not None:
                    add_funcinfo(idx.resolve_name(cls.module, name))
        elif isinstance(recv, ast.Name):
            target = idx.module_alias(modname, recv.id)
            if target is not None:
                add_funcinfo(idx.resolve_name(target, fn.attr))
            else:
                add_methods(fn.attr)
        else:
            add_methods(fn.attr)
    return out


def attr_value_name(expr) -> Optional[str]:
    """``staticmethod(fn)`` / plain ``fn`` class-attr value -> ``"fn"``."""
    if isinstance(expr, ast.Call) and call_name(expr.func) in (
            "staticmethod", "classmethod") and expr.args:
        expr = expr.args[0]
    if isinstance(expr, ast.Name):
        return expr.id
    return None
