"""The port lint's CLI: ``python -m pytorch_mnist_ddp_tpu_torch.analysis
[paths...]`` (the JAX package's ``analysis/__main__.py``: the same flags,
report and exit codes).

Exit codes: 0 clean (or warnings without ``--fail-on-warning``), 1 when
findings fail the run, 2 on usage errors.  ``--json`` emits a machine-
readable report for CI annotation tooling.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .concurrency import CONCURRENCY_RULES
from .engine import LintEngine, Severity
from .rules import ALL_RULES


def _default_target() -> str:
    """The package itself — so the bare module invocation lints the repo."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _baseline_keys(path: str) -> set[tuple[str, str, str]] | None:
    """Load a ``--baseline`` file: the ``--json`` report format (or a
    bare findings list).  Findings match on (path, rule, message) —
    line numbers drift with every edit, messages name the class/method
    and move with the code."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"jaxlint: cannot read baseline {path}: {exc}", file=sys.stderr)
        return None
    rows = data.get("findings", data) if isinstance(data, dict) else data
    keys: set[tuple[str, str, str]] = set()
    for row in rows:
        if isinstance(row, dict):
            keys.add((
                str(row.get("path", "")),
                str(row.get("rule", row.get("rule_id", ""))),
                str(row.get("message", "")),
            ))
    return keys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="jaxlint",
        description="AST-based analyzer of the torch port (rules JL009, "
        "JL011-JL018 and JL022-JL024; concurrency rules JL019-JL021 via "
        "--concurrency)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the "
        "pytorch_mnist_ddp_tpu_torch package)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as a JSON report on stdout",
    )
    parser.add_argument(
        "--fail-on-warning", action="store_true",
        help="exit nonzero on warnings, not just errors (the CI setting)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--concurrency", action="store_true",
        help="run the concurrency pass (JL019-JL021: lock order, "
        "unguarded shared state, blocking under a lock) instead of the "
        "default rule set",
    )
    parser.add_argument(
        "--rules", metavar="JL0xx[,JL0yy]",
        help="run only these rule ids (drawn from the active set; "
        "composes with --concurrency)",
    )
    parser.add_argument(
        "--baseline", metavar="FILE",
        help="suppress findings recorded in FILE (a previous --json "
        "report); only NEW findings count toward the exit code",
    )
    args = parser.parse_args(argv)

    rules = CONCURRENCY_RULES if args.concurrency else ALL_RULES
    if args.list_rules:
        for rule in rules:
            print(f"{rule.rule_id} [{rule.severity}] {rule.summary}")
        return 0

    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",") if r.strip()}
        by_id = {rule.rule_id: rule for rule in rules}
        unknown = wanted - set(by_id)
        if unknown:
            print(
                f"jaxlint: unknown rule id(s) for this rule set: "
                f"{', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2
        rules = tuple(rule for rule in rules if rule.rule_id in wanted)

    baseline: set[tuple[str, str, str]] = set()
    if args.baseline:
        loaded = _baseline_keys(args.baseline)
        if loaded is None:
            return 2
        baseline = loaded

    paths = args.paths or [_default_target()]
    for path in paths:
        if not os.path.exists(path):
            print(f"jaxlint: no such path: {path}", file=sys.stderr)
            return 2

    engine = LintEngine(rules)
    findings, suppressed = engine.run(paths)
    if baseline:
        kept = []
        for f in findings:
            if (f.path, f.rule_id, f.message) in baseline:
                suppressed += 1
            else:
                kept.append(f)
        findings = kept
    errors = sum(1 for f in findings if f.severity is Severity.ERROR)
    warnings = len(findings) - errors

    if args.as_json:
        print(json.dumps(
            {
                "findings": [f.to_dict() for f in findings],
                "errors": errors,
                "warnings": warnings,
                "suppressed": suppressed,
            },
            indent=2,
        ))
    else:
        for f in findings:
            print(f.format())
        print(
            f"jaxlint: {errors} error(s), {warnings} warning(s), "
            f"{suppressed} suppressed"
        )

    if errors or (warnings and args.fail_on_warning):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
