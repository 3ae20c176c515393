"""AST rule engine: file walker, rule registry, findings, suppressions
(the JAX package's ``analysis/engine.py``, unchanged in behaviour).

Deliberately dependency-free (stdlib ``ast`` only) so the analyzer runs
in CI images and pre-commit hooks without torch imported — linting must
never pay a CUDA-init cost.

Suppressions
------------
A finding on line N is suppressed by a trailing comment on that line::

    losses = out.cpu()  # jaxlint: disable=JL009 -- serial benchmark, the read is the point

Multiple rules: ``disable=JL002,JL006``; everything: ``disable=all``.
Whole-file: a line anywhere containing ``# jaxlint: disable-file=JL014``
(or ``disable-file=all``).  The ``-- reason`` tail is free text; review
convention in this repo is that every suppression carries one.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import os
import re
import tokenize
from typing import Iterable, Iterator


class Severity(enum.Enum):
    WARNING = "warning"
    ERROR = "error"

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.value


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One structured analyzer hit, orderable for stable output.

    ``end_line`` is the last physical line of the flagged node, so a
    waiver comment trailing a multi-line call (after the closing paren)
    still applies to it.
    """

    path: str
    line: int
    col: int
    rule_id: str
    severity: Severity = dataclasses.field(compare=False)
    message: str = dataclasses.field(compare=False)
    end_line: int = dataclasses.field(default=0, compare=False)

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule_id} [{self.severity}] {self.message}"
        )

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule_id,
            "severity": str(self.severity),
            "message": self.message,
        }


_SUPPRESS_RE = re.compile(r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*--.*)?$")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*jaxlint:\s*disable-file=([A-Za-z0-9_,\s]+?)(?:\s*--.*)?$"
)


class Suppressions:
    """Per-line and per-file rule suppressions parsed from comments.

    Comments are read with :mod:`tokenize` (not substring search) so a
    ``# jaxlint:`` inside a string literal never suppresses anything.
    """

    def __init__(self, source: str):
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        try:
            tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                match = _SUPPRESS_FILE_RE.search(tok.string)
                if match:
                    self.file_wide.update(_parse_rule_list(match.group(1)))
                    continue
                match = _SUPPRESS_RE.search(tok.string)
                if match:
                    rules = _parse_rule_list(match.group(1))
                    self.by_line.setdefault(tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass  # half-written file: lint what parsed, suppress nothing extra

    def is_suppressed(self, finding: Finding) -> bool:
        if "all" in self.file_wide or finding.rule_id in self.file_wide:
            return True
        # A waiver anywhere on the flagged node's physical lines counts —
        # multi-line calls naturally carry the comment after the closing
        # paren, not on the opening line the finding anchors to.
        last = max(finding.end_line, finding.line)
        for line in range(finding.line, last + 1):
            scope = self.by_line.get(line, ())
            if "all" in scope or finding.rule_id in scope:
                return True
        return False


def _parse_rule_list(raw: str) -> set[str]:
    return {"all" if part.strip().lower() == "all" else part.strip().upper()
            for part in raw.split(",") if part.strip()}


@dataclasses.dataclass
class ModuleContext:
    """Everything a rule gets to look at for one file."""

    path: str
    source: str
    tree: ast.Module
    suppressions: Suppressions


class Rule:
    """Base class for one analyzer rule.

    Subclasses set ``rule_id``/``severity``/``summary`` and implement
    :meth:`check` yielding findings (suppression filtering happens in the
    engine, so rules stay oblivious to comments).
    """

    rule_id: str = "JL000"
    severity: Severity = Severity.WARNING
    summary: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            path=ctx.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            rule_id=self.rule_id,
            severity=self.severity,
            message=message,
            end_line=getattr(node, "end_lineno", None) or line,
        )


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into a sorted stream of ``*.py`` paths.

    Cache/VCS directories are pruned; a directory argument is walked
    recursively so ``python -m pytorch_mnist_ddp_tpu_torch.analysis pkg/`` covers new modules
    without CI edits.
    """
    skip_dirs = {"__pycache__", ".git", ".hypothesis", ".pytest_cache"}
    seen: set[str] = set()

    def once(path: str) -> bool:
        # Overlapping arguments (a file plus its parent directory, or a
        # repeated path) must not double every finding and count.
        real = os.path.realpath(path)
        if real in seen:
            return False
        seen.add(real)
        return True

    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py") and once(path):
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in skip_dirs)
            for name in sorted(files):
                if name.endswith(".py"):
                    full = os.path.join(root, name)
                    if once(full):
                        yield full


class LintEngine:
    """Run a rule set over files, applying suppressions.

    ``run`` returns ``(findings, suppressed_count)`` — the latter so the
    CLI summary can say how many hits carry a reviewed waiver instead of
    silently swallowing them.
    """

    def __init__(self, rules: Iterable[Rule]):
        self.rules = list(rules)

    def check_source(
        self, source: str, path: str = "<string>"
    ) -> tuple[list[Finding], int]:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            finding = Finding(
                path=path,
                line=exc.lineno or 1,
                col=(exc.offset or 0) + 1,
                rule_id="JL000",
                severity=Severity.ERROR,
                message=f"file does not parse: {exc.msg}",
            )
            return [finding], 0
        ctx = ModuleContext(
            path=path,
            source=source,
            tree=tree,
            suppressions=Suppressions(source),
        )
        findings: list[Finding] = []
        suppressed = 0
        seen: set[tuple] = set()
        for rule in self.rules:
            for finding in rule.check(ctx):
                # Dedupe identical findings (nested loops make some rules
                # visit a node once per enclosing loop level): one hazard,
                # one line of output, one suppression unit.
                key = (finding.rule_id, finding.line, finding.col,
                       finding.message)
                if key in seen:
                    continue
                seen.add(key)
                if ctx.suppressions.is_suppressed(finding):
                    suppressed += 1
                else:
                    findings.append(finding)
        return sorted(findings), suppressed

    def check_file(self, path: str) -> tuple[list[Finding], int]:
        with open(path, "r", encoding="utf-8") as f:
            return self.check_source(f.read(), path)

    def run(self, paths: Iterable[str]) -> tuple[list[Finding], int]:
        findings: list[Finding] = []
        suppressed = 0
        for path in iter_python_files(paths):
            file_findings, file_suppressed = self.check_file(path)
            findings.extend(file_findings)
            suppressed += file_suppressed
        return findings, suppressed
