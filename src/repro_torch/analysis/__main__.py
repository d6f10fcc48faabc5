"""CLI: ``python -m repro_torch.analysis [root] [--format text|json] ...``

Exit status is the contract gate: 0 on a clean tree, 1 when findings
survive suppression, 2 on usage errors.  With no ``root`` the linter
lints its own installed package tree (``src/repro_torch``), so the gate
is exactly ``python -m repro_torch.analysis --format json``.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import (RULE_DOCS, register_builtin_rules,
                                  render_json, render_text, run_analysis)


def default_root() -> str:
    """The installed ``repro_torch`` package's directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch contract linter (stdlib-only, AST-based)")
    parser.add_argument("root", nargs="?", default=None,
                        help="tree to analyze (default: the installed "
                             "repro_torch package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print rule ids + one-line docs and exit")
    parser.add_argument("--output", default=None, metavar="FILE",
                        help="also write the report to FILE")
    args = parser.parse_args(argv)

    register_builtin_rules()
    if args.list_rules:
        from repro_torch.analysis import RULES
        for rid in sorted(RULES):
            print(f"{rid}: {RULE_DOCS.get(rid, '')}")
        return 0

    root = args.root or default_root()
    if not os.path.isdir(root):
        print(f"error: not a directory: {root}", file=sys.stderr)
        return 2
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        project, findings = run_analysis(root, rules)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    report = (render_json if args.format == "json" else
              render_text)(project, findings)
    print(report)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(report + "\n")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
