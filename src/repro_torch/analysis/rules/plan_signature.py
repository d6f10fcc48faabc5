"""plan-signature: every semantic MiningApp field must reach the plan keys
(counterpart of ``repro.analysis.rules.plan_signature``).

The port's planner caches ``MiningPlan``s under ``plan_app_key(app, ...)``
and transfers them across graphs, backends and the two packages under
``plan_transfer_key(app, ...)``.  A field of :class:`MiningApp` that
changes mining semantics but is digested into neither key aliases two
different apps onto one cached plan: capacities planned for one app
silently run another.  This is the bug class a field addition brings: the
dataclass grows, the key functions don't, and nothing fails until the
capacities are wrong on the second app.

The rule cross-checks the ``MiningApp`` dataclass fields against the
``app.<field>`` attribute loads inside each key function:

* ``Callable``-annotated fields are exempt: hooks are digested
  indirectly via ``plan_key`` (the app author's hash hook), since function
  identity is not stable across processes;
* ``backend`` is exempt: the resolved backend name is an explicit
  component of ``plan_app_key`` and, by design, none of the transfer key.

Absent either symbol (fixture trees), the rule is silent.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import callgraph as cg
from repro_torch.analysis.core import Finding, rule

RULE = "plan-signature"

APP_CLASS = "MiningApp"
KEY_FUNCS = ("plan_app_key", "plan_transfer_key")
EXEMPT_FIELDS = {"backend"}


def _is_callable_field(annotation) -> bool:
    if annotation is None:
        return False
    for node in ast.walk(annotation):
        if isinstance(node, ast.Name) and node.id == "Callable":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "Callable":
            return True
        # string annotations ("Optional[Callable]") under future import
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and "Callable" in node.value:
            return True
    return False


def _dataclass_fields(ci):
    """(name, annotation, lineno, col) of every dataclass field."""
    for item in ci.node.body:
        if isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            yield (item.target.id, item.annotation, item.lineno,
                   item.col_offset)


def _digested_attrs(fn_node):
    """Attribute names loaded off any name inside a key function."""
    return {node.attr for node in ast.walk(fn_node)
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)}


@rule(RULE, "every non-hook MiningApp field must be digested into "
            "plan_app_key and plan_transfer_key (plan-cache aliasing "
            "guard)")
def check(project):
    idx = cg.index(project)
    app_ci = next((ci for ci in idx.all_classes() if ci.name == APP_CLASS),
                  None)
    keys = {}
    for mod in idx.modules.values():
        for name in KEY_FUNCS:
            if name in mod.functions:
                keys[name] = mod.functions[name]
    if app_ci is None or not keys:
        return
    rel = app_ci.sf.rel.replace("\\", "/")
    for name, annotation, lineno, col in _dataclass_fields(app_ci):
        if name in EXEMPT_FIELDS or name.startswith("_") or \
                _is_callable_field(annotation):
            continue
        missing = [k for k, fi in keys.items()
                   if name not in _digested_attrs(fi.node)]
        if missing:
            yield Finding(
                RULE, rel, lineno, col,
                f"MiningApp.{name} is not digested into "
                f"{', '.join(f'{k}()' for k in missing)} — two apps "
                f"differing only in {name!r} would alias onto one cached "
                f"plan; add it to the key (or exempt it with a documented "
                f"suppression if it is plan-neutral)")
