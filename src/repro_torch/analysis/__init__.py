"""repro_torch.analysis — the port's contract linter (stdlib-only).

``python -m repro_torch.analysis`` checks the port's tree against the
contracts its CPU tests cannot see (they fail silently, or only at scale,
or only on the card), the JAX package's five rules read in the port's
idioms:

* ``grid-contract`` — every ``__global__`` in ``kernels/*/csrc/*.cu``
  declares its grid contract, and a concurrent-grid backend reaches no
  sequential kernel, nor a look-back kernel without look-back compaction;
* ``host-sync`` — nothing reachable from a warm replay waits for the
  host (``.item()``, ``.tolist()``, ``.cpu()``, a data-dependent output
  size, a boolean mask index, ...);
* ``obs-purity`` — observability guarded off the measured path;
* ``plan-signature`` — every semantic MiningApp field digested into the
  plan keys;
* ``predicate-purity`` — predicate specs and hooks elementwise, with no
  Python control flow over a tensor.

See ``repro_torch.analysis.core`` for the ``# repro: ignore[rule]`` /
``# repro: host-module`` escape hatches.
"""
from repro_torch.analysis.core import (Finding, Project, RULE_DOCS, RULES,
                                       SourceFile, render_json, render_text,
                                       rule, run_analysis)

__all__ = ["Finding", "Project", "RULES", "RULE_DOCS", "SourceFile",
           "register_builtin_rules", "render_json", "render_text",
           "rule", "run_analysis"]


def register_builtin_rules() -> None:
    """Import the built-in rule modules (idempotent self-registration)."""
    from repro_torch.analysis import rules  # noqa: F401  (import = register)
