"""Analyzer core: source loading, rule registry, suppressions, reporting
(counterpart of ``repro.analysis.core``).

The contract linter is dependency-free by design (stdlib ``ast`` and
``re`` only): it must run before ``torch`` imports, and it must be able to
lint *fixture* trees that are not importable at all.  A rule is a function
``rule(project) -> iterable[Finding]`` registered under a stable id;
``run_analysis`` loads every ``*.py`` under a root directory and every
CUDA source under ``kernels/*/csrc/``, runs the selected rules, and drops
findings suppressed at their line.

Source-level escape hatches (the JAX package's syntax, parsed here and
consumed by the rules):

* ``# repro: ignore[rule-id]`` on the offending line suppresses that
  rule there (comma-separate several ids; empty brackets suppress all);
  in a CUDA source the comment is ``// repro: ignore[rule-id]``.  Use it
  for single sites where the contract is bent by design, with the reason
  on the line.
* ``# repro: host-module`` on a line of its own marks a whole module as
  host-only: the call-graph rules (host-sync, obs-purity) never extend
  the replay set into it.  Use it for modules that build, benchmark or
  launch on the host by construction, not as a bulk suppression.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Optional

SUPPRESS_RE = re.compile(r"(?:#|//)\s*repro:\s*ignore\[([A-Za-z0-9_,\- ]*)\]")
MARKER_RE = re.compile(r"^\s*#\s*repro:\s*([a-z][a-z-]*)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location.

    ``path`` is relative to the analyzed root, so fixture runs and real
    runs report stable, comparable locations.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


def _suppressions(text: str) -> dict[int, set[str]]:
    out = {}
    for i, line in enumerate(text.splitlines(), 1):
        m = SUPPRESS_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = rules or {"*"}
    return out


class SourceFile:
    """One parsed module: AST + suppression lines + module markers."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.suppressions = _suppressions(text)
        self.markers: set[str] = set()
        for line in text.splitlines():
            m = MARKER_RE.match(line)
            if m and m.group(1) != "ignore":
                self.markers.add(m.group(1))

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressions.get(line)
        return rules is not None and ("*" in rules or rule in rules)

    @property
    def is_host_module(self) -> bool:
        return "host-module" in self.markers


class CudaSource:
    """One CUDA source under ``kernels/<family>/csrc/``, kept as text (the
    grid-contract rule parses it) with its ``// repro: ignore[...]``
    lines."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.suppressions = _suppressions(text)
        parts = rel.replace(os.sep, "/").split("/")
        # kernels/<family>/csrc/<name>.cu -> "<family>"
        self.family = parts[-3] if len(parts) >= 3 else ""

    suppressed = SourceFile.suppressed


class Project:
    """Every parseable ``*.py`` under ``root``, every ``kernels/*/csrc/*.cu``
    and the root package name.

    ``package`` (the root directory's basename) anchors absolute-import
    resolution: ``from <package>.x.y import z`` binds into the analyzed
    tree, anything else is external and opaque to the rules.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.package = os.path.basename(self.root.rstrip(os.sep))
        self.files: list[SourceFile] = []
        self.cuda_files: list[CudaSource] = []
        self.errors: list[tuple[str, str]] = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, self.root)
                parts = rel.replace(os.sep, "/").split("/")
                is_cuda = (name.endswith(".cu") and len(parts) >= 4
                           and parts[-4] == "kernels"
                           and parts[-2] == "csrc")
                if not (name.endswith(".py") or is_cuda):
                    continue
                try:
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                    if is_cuda:
                        self.cuda_files.append(CudaSource(path, rel, text))
                    else:
                        self.files.append(SourceFile(path, rel, text))
                except (OSError, SyntaxError, ValueError) as e:
                    self.errors.append((rel, str(e)))

    def module_name(self, sf: SourceFile) -> str:
        """Dotted module name of ``sf`` rooted at the package name."""
        parts = sf.rel.replace(os.sep, "/").split("/")
        if parts[-1] == "__init__.py":
            parts = parts[:-1]
        else:
            parts[-1] = parts[-1][:-3]
        return ".".join([self.package] + [p for p in parts if p])


# ---------------------------------------------------------------------------
# Rule registry

RULES: dict[str, Callable[[Project], Iterable[Finding]]] = {}
RULE_DOCS: dict[str, str] = {}


def rule(rule_id: str, doc: str):
    """Register a rule function under a stable id (decorator)."""
    def deco(fn):
        RULES[rule_id] = fn
        RULE_DOCS[rule_id] = doc
        fn.rule_id = rule_id
        return fn
    return deco


def run_analysis(root: str,
                 rules: Optional[Iterable[str]] = None
                 ) -> tuple[Project, list[Finding]]:
    """Run the selected rules (default: all) over the tree at ``root``.

    Returns the loaded project and the surviving (non-suppressed)
    findings sorted by location.
    """
    # rule modules self-register on import; import here so a partial
    # import of repro_torch.analysis.core never sees an empty registry
    from repro_torch.analysis import register_builtin_rules
    register_builtin_rules()
    project = Project(root)
    selected = list(RULES) if rules is None else list(rules)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise KeyError(f"unknown rule id(s) {unknown}; "
                       f"available: {sorted(RULES)}")
    by_path = {sf.rel.replace(os.sep, "/"): sf
               for sf in (*project.files, *project.cuda_files)}
    findings = []
    for rid in selected:
        for f in RULES[rid](project):
            sf = by_path.get(f.path)
            if sf is not None and sf.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return project, findings


def render_text(project: Project, findings: list[Finding]) -> str:
    lines = [f.format() for f in findings]
    lines.append(f"[repro_torch.analysis] {len(findings)} finding(s) in "
                 f"{len(project.files)} .py and {len(project.cuda_files)} "
                 f".cu files under {project.root}")
    for rel, err in project.errors:
        lines.append(f"[repro_torch.analysis] warning: could not parse "
                     f"{rel}: {err}")
    return "\n".join(lines)


def render_json(project: Project, findings: list[Finding]) -> str:
    """The JAX package's report schema, plus ``checked_cuda_files``."""
    return json.dumps({
        "root": project.root,
        "checked_files": len(project.files),
        "checked_cuda_files": len(project.cuda_files),
        "parse_errors": [{"path": p, "error": e}
                         for p, e in project.errors],
        "findings": [dataclasses.asdict(f) for f in findings],
    }, indent=2)
