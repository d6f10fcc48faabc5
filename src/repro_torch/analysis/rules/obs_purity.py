"""obs-purity: observability must stay off the measured path
(counterpart of ``repro.analysis.rules.obs_purity``).

The port's tracing and metrics (:mod:`repro_torch.obs`) cost nothing when
off: every hot-path call site sits behind ``trace.on``,
``policy.traceable``-derived ``host`` flags, or the ``_obs_op`` early
return.  An unguarded ``_T.span`` / ``_M.inc`` on the replay path either
perturbs the numbers the observability layer reports or, with
``--trace-sync``, waits for the card mid-replay.  Three contracts:

* ``kernels/`` must not import ``repro_torch.obs`` at all: the wrappers
  count their launches in their own tables, and nothing of the obs layer
  belongs between a check and a launch;
* inside ``phases/`` every obs call site must be host-guarded (op bodies
  run inside every replay);
* everywhere else, functions in the replay set must not make unguarded
  obs calls (host-path spans outside it, such as the ``executor.*`` spans
  around ``_run_once``, are fine: they no-op when tracing is off).
"""
from __future__ import annotations

import ast

from repro_torch.analysis import callgraph as cg
from repro_torch.analysis.core import Finding, rule

RULE = "obs-purity"


def _obs_aliases(idx, mod, obs_prefix):
    """Local names bound to obs modules / obs functions in ``mod``."""
    mod_aliases, fn_aliases = set(), set()
    for local, imp in mod.imports.items():
        if imp[0] == "mod":
            if imp[1] == obs_prefix or \
                    imp[1].startswith(obs_prefix + "."):
                mod_aliases.add(local)
        else:
            _, base, orig = imp
            dotted = f"{base}.{orig}"
            if not (base == obs_prefix
                    or base.startswith(obs_prefix + ".")
                    or dotted == obs_prefix
                    or dotted.startswith(obs_prefix + ".")):
                continue
            if dotted in idx.modules:
                mod_aliases.add(local)
            else:
                fn_aliases.add(local)
    return mod_aliases, fn_aliases


def _is_obs_call(call, mod_aliases, fn_aliases):
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        return fn.value.id in mod_aliases
    if isinstance(fn, ast.Name):
        return fn.id in fn_aliases
    return False


def _obs_import_lines(sf, obs_prefix, pkg):
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == obs_prefix or \
                        alias.name.startswith(obs_prefix + "."):
                    yield node
                    break
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            if node.module == obs_prefix or \
                    node.module.startswith(obs_prefix + ".") or \
                    (node.module == pkg and
                     any(a.name == "obs" for a in node.names)):
                yield node


def _unguarded_obs_calls(fn_node, mod_aliases, fn_aliases):
    for node in cg.iter_unguarded(fn_node):
        if isinstance(node, ast.Call) and \
                _is_obs_call(node, mod_aliases, fn_aliases):
            yield node


@rule(RULE, "obs imports banned in kernels/; every obs call in phases/ "
            "and the replay set must be host-guarded")
def check(project):
    idx = cg.index(project)
    pkg = project.package
    obs_prefix = pkg + ".obs"
    traced = cg.replay_set(project)
    seen: set[tuple[str, int, int]] = set()

    def emit(sf, node, message):
        rel = sf.rel.replace("\\", "/")
        key = (rel, node.lineno, node.col_offset)
        if key in seen:
            return None
        seen.add(key)
        return Finding(RULE, rel, node.lineno, node.col_offset, message)

    for modname, mod in idx.modules.items():
        sf = mod.sf
        rel = sf.rel.replace("\\", "/")
        if rel.startswith("obs/") or "/obs/" in rel:
            continue
        in_kernels = rel.startswith("kernels/") or "/kernels/" in rel
        in_phases = rel.startswith("phases/") or "/phases/" in rel
        if in_kernels:
            for node in _obs_import_lines(sf, obs_prefix, pkg):
                f = emit(sf, node,
                         "kernels/ must not import the obs layer: a "
                         "wrapper counts its launches itself")
                if f:
                    yield f
            continue
        if not in_phases:
            continue
        mod_aliases, fn_aliases = _obs_aliases(idx, mod, obs_prefix)
        if not (mod_aliases or fn_aliases):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for call in _unguarded_obs_calls(node, mod_aliases,
                                             fn_aliases):
                f = emit(sf, call,
                         f"unguarded obs call in phases/ op body "
                         f"{node.name!r}; guard with trace.on / "
                         f"policy.traceable or move to the host path")
                if f:
                    yield f

    # the replay set outside phases/ (engine roots, policies, wrappers)
    for fn_node, sf, modname, _cls in traced.items():
        rel = sf.rel.replace("\\", "/")
        if rel.startswith("obs/") or "/obs/" in rel:
            continue
        mod = idx.modules.get(modname)
        if mod is None:
            continue
        mod_aliases, fn_aliases = _obs_aliases(idx, mod, obs_prefix)
        if not (mod_aliases or fn_aliases):
            continue
        for call in _unguarded_obs_calls(fn_node, mod_aliases,
                                         fn_aliases):
            f = emit(sf, call,
                     f"unguarded obs call inside the replay set "
                     f"(function "
                     f"{getattr(fn_node, 'name', '<lambda>')!r}); obs "
                     f"work must sit behind trace.on or a host guard")
            if f:
                yield f
