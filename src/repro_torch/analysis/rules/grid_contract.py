"""grid-contract: every CUDA kernel declares its grid contract, and a
concurrent-grid backend reaches only kernels that honour it (counterpart
of ``repro.analysis.rules.grid_contract``, which reads Pallas bodies; this
one reads the CUDA sources).

Each ``__global__`` in ``kernels/*/csrc/*.cu`` carries a declaration on
the line above it:

* ``// repro: grid[concurrent]`` — correct under any order and any
  co-residency of its thread blocks: no value passes between CTAs through
  global memory;
* ``// repro: grid[lookback]`` — a CTA waits on values its predecessors
  publish (a decoupled look-back): correct on any concurrent grid whose
  backend runs ``compaction = "decoupled-lookback"``, which takes tiles in
  ticket order;
* ``// repro: grid[sequential]`` — correct only when the blocks run one
  after another.

A backend class declaring ``grid_contract = "concurrent"`` promises its
kernels are legal on a concurrent grid.  The rule walks every function
reachable from such a backend (receiver-bound, so a subclass's kernel seam
is its own), follows each wrapper's ``launch(name, lib.<symbol>, ...)`` to
the ``extern "C"`` entry ``<symbol>`` of its family's CUDA source and on
to the ``__global__``s it launches, and flags:

* a ``__global__`` with no (or an unknown) declaration;
* a ``sequential`` kernel reached from a concurrent backend;
* a ``lookback`` kernel reached from a backend whose ``compaction`` is not
  ``"decoupled-lookback"``;
* a kernel declared ``concurrent`` whose body (or a device function it
  calls) waits on or carries a value through global memory written by
  another CTA: a loop around a ``volatile`` or ``ld.*.relaxed`` /
  ``ld.*.acquire`` load, an ``atomicCAS``, or an ``atomicAdd`` whose
  result is used.  This is the CUDA counterpart of the JAX rule's "load
  and store the same ref" carry.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis import callgraph as cg
from repro_torch.analysis.core import Finding, rule

RULE = "grid-contract"

CONTRACTS = ("concurrent", "lookback", "sequential")
DECL_RE = re.compile(r"//\s*repro:\s*grid\[([\w-]*)\]")
LOAD_RE = re.compile(r"ld\.(?:\w+\.)*?(?:relaxed|acquire|volatile)\b")
ATOMIC_RE = re.compile(r"\b(atomicCAS|atomicAdd)\s*\(")
LONE_ASSIGN_RE = re.compile(r"(?<![=!<>+\-*/%&|^])=(?!=)|\breturn\b")
IDENT_RE = re.compile(r"\b[A-Za-z_]\w*\b")
VOLATILE_DECL_RE = re.compile(r"(?<!asm )\bvolatile\b[^;(){}=,]*?(\w+)\s*"
                              r"(?=[,)=;\[])")
SCOPE_HEAD_RE = re.compile(
    r"^\s*(?:template\s*<[^{]*>\s*)?(?:namespace\b|extern\s*\"\s*\"|"
    r"struct\b|class\b|union\b)")
QUALIFIERS_RE = re.compile(r"(?:\s*\b(?:const|noexcept|override|final)\b)*"
                           r"\s*$")


# ---------------------------------------------------------------------------
# A CUDA source, read as far as the rule needs


_TOKEN_RE = re.compile(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"|"
                       r"'(?:\\.|[^'\\\n])*'|^[ \t]*#(?:\\\n|[^\n])*",
                       re.S | re.M)


def _blank(s: str) -> str:
    return re.sub(r"[^\n]", " ", s)


def _scan(text: str) -> tuple[str, str]:
    """``(code, masked)``: ``code`` is ``text`` with its comments blanked;
    ``masked`` also blanks string and character literals' contents and
    preprocessor lines, for brace and parenthesis matching.  Both keep
    every offset and newline of ``text``."""
    code, masked = [], []
    last = 0
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        code.append(text[last:m.start()])
        masked.append(text[last:m.start()])
        if tok.startswith(("//", "/*")):
            code.append(_blank(tok))
            masked.append(_blank(tok))
        elif tok[0] in "\"'":
            code.append(tok)
            masked.append(tok[0] + _blank(tok[1:-1]) + tok[-1])
        else:                                   # a directive
            code.append(tok)
            masked.append(_blank(tok))
        last = m.end()
    code.append(text[last:])
    masked.append(text[last:])
    return "".join(code), "".join(masked)


def _match(masked: str, i: int, open_c: str, close_c: str) -> int:
    """Offset of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(masked)):
        if masked[j] == open_c:
            depth += 1
        elif masked[j] == close_c:
            depth -= 1
            if depth == 0:
                return j
    return len(masked) - 1


class CudaFunction:
    def __init__(self, name, head, body, body_start, kernel_line):
        self.name = name
        self.head = head              # declaration text (comments blanked)
        self.body = body              # body text (comments blanked)
        self.body_start = body_start  # offset of the body in the source
        self.kernel_line = kernel_line  # line of __global__, or None


class CudaUnit:
    """The functions of one CUDA source: kernels (``__global__``), device
    and host functions, each with its body."""

    def __init__(self, src):
        self.src = src
        self.code, self.masked = _scan(src.text)
        self.lines = src.text.splitlines()
        self.functions: list[CudaFunction] = []
        self._parse()
        self.by_name: dict[str, list[CudaFunction]] = {}
        for f in self.functions:
            self.by_name.setdefault(f.name, []).append(f)

    def line_of(self, offset: int) -> int:
        return self.code.count("\n", 0, offset) + 1

    def _parse(self) -> None:
        m, code = self.masked, self.code
        i, stmt = 0, 0
        while i < len(m):
            c = m[i]
            if c in ";}":
                stmt = i + 1
            elif c == "{":
                head = m[stmt:i]
                if SCOPE_HEAD_RE.match(head):
                    stmt = i + 1          # namespace, extern "C", struct
                else:
                    end = _match(m, i, "{", "}")
                    name = self._function_name(head)
                    if name is not None:
                        g = code.find("__global__", stmt, i)
                        self.functions.append(CudaFunction(
                            name, code[stmt:i], code[i:end + 1], i,
                            None if g < 0 else self.line_of(g)))
                    i, stmt = end + 1, end + 1
                    continue
            i += 1

    @staticmethod
    def _function_name(head: str):
        head = QUALIFIERS_RE.sub("", head)
        if not head.endswith(")"):
            return None
        depth = 0
        for j in range(len(head) - 1, -1, -1):
            if head[j] == ")":
                depth += 1
            elif head[j] == "(":
                depth -= 1
                if depth == 0:
                    m = re.search(r"(\w+)\s*$", head[:j])
                    if m is None or m.group(1) in ("if", "for", "while",
                                                   "switch", "return"):
                        return None
                    return m.group(1)
        return None

    def contract(self, f: CudaFunction):
        """The kernel's declaration on the line above its ``__global__``
        (above its ``template`` line, or among the comment lines right
        above either): the contract string, or None."""
        j = f.kernel_line - 2
        while j >= 0 and self.lines[j].strip().startswith("template"):
            j -= 1
        while j >= 0 and self.lines[j].strip().startswith("//"):
            m = DECL_RE.search(self.lines[j])
            if m:
                return m.group(1)
            j -= 1
        return None

    def reach(self, f: CudaFunction) -> list[CudaFunction]:
        """``f`` and the functions of this source it names, transitively."""
        out, stack, seen = [], [f], set()
        while stack:
            g = stack.pop()
            if id(g) in seen:
                continue
            seen.add(id(g))
            out.append(g)
            for name in set(IDENT_RE.findall(g.body)):
                if name != g.name:
                    stack.extend(self.by_name.get(name, ()))
        return out

    def launched(self, symbol: str) -> list[CudaFunction]:
        """The kernels the entry point ``symbol`` launches."""
        out = []
        for entry in self.by_name.get(symbol, ()):
            if entry.kernel_line is not None:
                continue
            for g in self.reach(entry):
                if g.kernel_line is not None and g not in out:
                    out.append(g)
        return out

    def carries(self, kernel: CudaFunction):
        """``(line, what)`` for each way ``kernel`` waits on or carries a
        value written by another CTA."""
        reached = self.reach(kernel)
        loaders = {g.name for g in reached if _has_load(g.body)}
        for g in reached:
            # names declared volatile (a parameter or a local)
            volatile = set(VOLATILE_DECL_RE.findall(g.head + g.body))
            for start, end in _loops(self.masked, g.body_start, len(g.body)):
                text = self.code[start:end]
                if _has_load(text) or any(
                        re.search(rf"\b{re.escape(n)}\s*\(", text)
                        for n in loaders) or any(
                        re.search(rf"\b{re.escape(n)}\b", text)
                        for n in volatile):
                    yield (self.line_of(start), "spins in a loop on a "
                           "volatile / relaxed / acquire load")
            for m in ATOMIC_RE.finditer(g.body):
                off = g.body_start + m.start()
                if m.group(1) == "atomicCAS":
                    yield self.line_of(off), "uses atomicCAS"
                    continue
                prev = max(self.masked.rfind(ch, 0, off) for ch in ";{}")
                if LONE_ASSIGN_RE.search(self.masked[prev + 1:off]):
                    yield (self.line_of(off), "uses the result of "
                           "atomicAdd")


def _has_load(text: str) -> bool:
    if LOAD_RE.search(text):
        return True
    # `volatile` as a type qualifier, not `asm volatile`
    return any(not re.search(r"\b(?:asm|__asm__)\s*$", text[:m.start()])
               for m in re.finditer(r"\bvolatile\b", text))


def _loops(masked: str, start: int, length: int):
    """``(start, end)`` offsets of each loop in ``masked[start:start +
    length]``, condition and body together."""
    end_all = start + length
    for m in re.finditer(r"\b(for|while|do)\b", masked[start:end_all]):
        i = start + m.end()
        while i < end_all and masked[i].isspace():
            i += 1
        if m.group(1) == "do":
            if i >= end_all or masked[i] != "{":
                continue
            close = _match(masked, i, "{", "}")
            tail = re.match(r"\s*while\s*\(", masked[close + 1:end_all])
            if tail:
                close = _match(masked, close + 1 + tail.end() - 1, "(", ")")
            yield start + m.start(), close + 1
            continue
        if i >= end_all or masked[i] != "(":
            continue
        close = _match(masked, i, "(", ")")
        j = close + 1
        while j < end_all and masked[j].isspace():
            j += 1
        if j < end_all and masked[j] == "{":
            body_end = _match(masked, j, "{", "}")
        else:
            body_end = masked.find(";", j)
            body_end = end_all if body_end < 0 else body_end
        yield start + m.start(), body_end + 1


# ---------------------------------------------------------------------------
# The backends


def class_reachable(idx, ci):
    """Functions reachable from ``ci``'s methods, receiver-bound."""
    seen = {}
    stack = []
    for c in idx.mro(ci):
        for name, mi in c.methods.items():
            if idx.effective_method(ci, name) is mi:
                mod = idx.modules.get(mi.module)
                if mod is not None:
                    stack.append((mi.node, mod.sf, mi.module, ci))
    while stack:
        item = stack.pop()
        node, sf, modname, cls = item
        if id(node) in seen:
            continue
        seen[id(node)] = item
        nested = cg.local_defs(node)
        for call in ast.walk(node):
            if isinstance(call, ast.Call):
                stack.extend(cg.resolve_call(idx, call, sf, modname, cls,
                                             nested))
    return seen.values()


def _launches(node):
    """``(call, symbol)`` for each ``launch(name, <lib>.<symbol>, ...)``."""
    for call in ast.walk(node):
        if isinstance(call, ast.Call) and \
                cg.call_name(call.func) in ("launch", "_launch") and \
                len(call.args) >= 2 and \
                isinstance(call.args[1], ast.Attribute):
            yield call, call.args[1].attr


def _family(sf) -> str:
    parts = sf.rel.replace("\\", "/").split("/")
    return parts[-2] if len(parts) >= 2 else ""


def _contract_line(ci) -> int:
    for item in ci.node.body:
        if isinstance(item, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "grid_contract"
                for t in item.targets):
            return item.lineno
    return ci.node.lineno


@rule(RULE, "every __global__ declares its grid contract; concurrent-grid "
            "backends reach no sequential kernel, no look-back kernel "
            "without look-back compaction, and no cross-CTA carry")
def check(project):
    units = [CudaUnit(src) for src in project.cuda_files]
    contract = {}
    for u in units:
        rel = u.src.rel.replace("\\", "/")
        for f in u.functions:
            if f.kernel_line is None:
                continue
            c = u.contract(f)
            contract[id(f)] = c
            if c not in CONTRACTS:
                yield Finding(
                    RULE, rel, f.kernel_line, 0,
                    f"kernel {f.name!r} declares "
                    f"{'no grid contract' if c is None else f'grid[{c}]'}"
                    f": put `// repro: grid[concurrent|lookback|"
                    f"sequential]` on the line above its __global__")
            elif c == "concurrent":
                for line, what in u.carries(f):
                    yield Finding(
                        RULE, rel, f.kernel_line, 0,
                        f"kernel {f.name!r} is declared grid[concurrent] "
                        f"but {what} (line {line}): a value carried "
                        f"between CTAs is defined only under grid"
                        f"[lookback] or grid[sequential]")
    by_family: dict[str, list[CudaUnit]] = {}
    for u in units:
        by_family.setdefault(u.src.family, []).append(u)

    idx = cg.index(project)
    for ci in idx.all_classes():
        if idx.const_attr(ci, "grid_contract") != "concurrent":
            continue
        compaction = idx.const_attr(ci, "compaction")
        for node, sf, _modname, _cls in class_reachable(idx, ci):
            if not cg.is_ops_module(sf):
                continue
            for call, symbol in _launches(node):
                for u in by_family.get(_family(sf), ()):
                    for k in u.launched(symbol):
                        c = contract.get(id(k))
                        bad = (c == "sequential" or (
                            c == "lookback"
                            and compaction != "decoupled-lookback"))
                        if not bad:
                            continue
                        yield Finding(
                            RULE, ci.sf.rel.replace("\\", "/"),
                            _contract_line(ci), 0,
                            f"backend {ci.name!r} (grid_contract="
                            f"\"concurrent\", compaction={compaction!r}) "
                            f"reaches grid[{c}] kernel {k.name!r} through "
                            f"{getattr(node, 'name', '?')}() -> {symbol} "
                            f"({u.src.rel.replace(chr(92), '/')}:"
                            f"{k.kernel_line})")
