"""fluxlint core: findings, suppressions, baseline, runner, reports.

The framework half of the repo's AST-based invariant checker (the rules
themselves live in :mod:`.rules`; the control-flow machinery they share
in :mod:`.flow`; repo-level knowledge — metric schema, fault-site
registry, env-var docs table — in :mod:`.context`). The port's own copy
of :mod:`fluxmpi_tpu.analysis.core`, with the same behaviour, report and
baseline schemas (one reader takes both packages' reports). Pure stdlib,
importing neither torch nor jax: ``scripts/fluxlint_torch.py`` loads this
package standalone so a lint run never initialises CUDA.

Vocabulary:

- A **rule** has an ``id`` (the name used in suppressions and baseline
  entries), a ``severity`` (``error``/``warning`` — both fail the lint;
  the split is report metadata), and a ``check(module, ctx)`` generator
  over findings. File-scoped rules run per parsed module;
  project-scoped rules (``project_check(modules, ctx)``) run once over
  the whole scanned set (cross-file invariants: env-var table symmetry,
  fault-site test coverage).
- A **finding** carries a stable ``key`` besides its line/col: the
  thing that is wrong (a metric name, an env var, ``function:callee``),
  not where it currently sits. Baseline entries match on
  ``(rule, path, key)`` so a grandfathered finding survives unrelated
  line churn but dies with the code that caused it.
- An inline ``# fluxlint: disable=rule-a,rule-b`` comment suppresses
  those rules on its line (trailing or own-line form; an own-line
  comment suppresses the next statement line).
- The **baseline** file (``.fluxlint-torch-baseline.json``) grandfathers
  findings; every entry must carry a non-empty ``justification`` and
  must still match a live finding — an unjustified or stale entry is
  itself a finding, so the baseline cannot rot silently.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Any, Callable, Iterable, Iterator

BASELINE_BASENAME = ".fluxlint-torch-baseline.json"

JSON_SCHEMA = "fluxmpi_tpu.fluxlint/v1"

_SUPPRESS_RE = re.compile(r"#\s*fluxlint:\s*disable=([A-Za-z0-9_,\- ]+)")


def _comment_tokens(text: str) -> list[tuple[int, int, str]]:
    """(line, col, comment-text) for every COMMENT token. Tokenization
    of a file that already ast-parsed can still hit edge cases; degrade
    to no suppressions rather than crash the lint."""
    import io
    import tokenize

    out: list[tuple[int, int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return []
    return out


class Finding:
    """One lint finding. ``key`` is the stable identity used by the
    baseline (see module docstring); ``line``/``col`` are 1-based /
    0-based like CPython's AST."""

    __slots__ = ("rule", "severity", "path", "line", "col", "message", "key")

    def __init__(
        self,
        rule: str,
        severity: str,
        path: str,
        line: int,
        col: int,
        message: str,
        key: str,
    ):
        self.rule = rule
        self.severity = severity
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.key = key

    def to_json(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "key": self.key,
        }

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity} [{self.rule}] {self.message}"
        )

    __repr__ = __str__


class ModuleSource:
    """A parsed source file plus its per-line suppression map."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text)
        # line -> set of rule ids disabled there. Directives are read
        # from COMMENT tokens only (a string literal quoting the
        # directive must not disable anything). An own-line comment
        # covers the next code line, skipping blank and further comment
        # lines — so a directive may sit above its justification
        # comment, which sits above the statement.
        self.suppressions: dict[int, set[str]] = {}
        lines = text.splitlines()
        for lineno, col, comment in _comment_tokens(text):
            m = _SUPPRESS_RE.search(comment)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            self.suppressions.setdefault(lineno, set()).update(rules)
            own_line = lines[lineno - 1][:col].strip() == ""
            if own_line:
                for j in range(lineno + 1, len(lines) + 1):
                    stripped = lines[j - 1].strip()
                    if not stripped or stripped.startswith("#"):
                        continue
                    self.suppressions.setdefault(j, set()).update(rules)
                    break

    def suppressed(self, line: int, rule_id: str) -> bool:
        return rule_id in self.suppressions.get(line, ())


class Rule:
    """Base rule. Subclasses set ``id``/``severity``/``description`` and
    implement :meth:`check` (file-scoped) and/or :meth:`project_check`
    (whole-scan-scoped; default: nothing)."""

    id: str = ""
    severity: str = "error"
    description: str = ""

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        return iter(())

    def project_check(
        self, modules: list[ModuleSource], ctx: Any
    ) -> Iterator[Finding]:
        return iter(())

    def finding(
        self, module_path: str, node: ast.AST | None, message: str, key: str
    ) -> Finding:
        line = getattr(node, "lineno", 0) if node is not None else 0
        col = getattr(node, "col_offset", 0) if node is not None else 0
        return Finding(
            self.id, self.severity, module_path, line, col, message, key
        )


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


class Baseline:
    """Checked-in grandfather list. ``entries`` is a list of
    ``{"rule", "path", "key", "justification"}`` objects; matching and
    hygiene rules are in the module docstring."""

    def __init__(self, entries: list[dict[str, Any]], path: str = ""):
        self.entries = entries
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls([], path)
        entries = data.get("entries", []) if isinstance(data, dict) else []
        return cls([e for e in entries if isinstance(e, dict)], path)

    def _matches(self, finding: Finding) -> dict[str, Any] | None:
        for entry in self.entries:
            if (
                entry.get("rule") == finding.rule
                and entry.get("path") == finding.path
                and entry.get("key") == finding.key
            ):
                return entry
        return None

    def apply(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[Finding]]:
        """Split ``findings`` into (active, baselined) and append the
        baseline's own hygiene findings (stale entry, missing
        justification) to the active list via the third return."""
        active: list[Finding] = []
        baselined: list[Finding] = []
        used: set[int] = set()
        for f in findings:
            entry = self._matches(f)
            if entry is None:
                active.append(f)
                continue
            used.add(id(entry))
            if not str(entry.get("justification", "")).strip():
                active.append(
                    Finding(
                        "fluxlint-baseline",
                        "error",
                        f.path,
                        f.line,
                        f.col,
                        f"baseline entry for [{f.rule}] {f.key!r} has no "
                        f"justification — every grandfathered finding "
                        f"must say why it is kept",
                        f"unjustified:{f.rule}:{f.key}",
                    )
                )
            else:
                baselined.append(f)
        hygiene: list[Finding] = []
        for entry in self.entries:
            if id(entry) in used:
                continue
            hygiene.append(
                Finding(
                    "fluxlint-baseline",
                    "error",
                    str(entry.get("path", self.path or BASELINE_BASENAME)),
                    0,
                    0,
                    f"stale baseline entry: [{entry.get('rule')}] "
                    f"{entry.get('key')!r} no longer matches any finding — "
                    f"delete it",
                    f"stale:{entry.get('rule')}:{entry.get('key')}",
                )
            )
        return active, baselined, hygiene


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class Report:
    def __init__(self) -> None:
        self.findings: list[Finding] = []  # active (fail the lint)
        self.baselined: list[Finding] = []
        self.suppressed: int = 0
        self.files: int = 0
        self.unreadable: list[str] = []  # "path: error" strings

    @property
    def exit_code(self) -> int:
        """0 clean / 1 findings / 2 unreadable input — the
        ``check_metrics_schema.py`` exit-code convention."""
        if self.unreadable:
            return 2
        return 1 if self.findings else 0

    def to_json(self) -> dict[str, Any]:
        return {
            "schema": JSON_SCHEMA,
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressed": self.suppressed,
            "unreadable": list(self.unreadable),
            "exit_code": self.exit_code,
        }

    def text(self) -> str:
        out = [str(f) for f in self.findings]
        out.extend(f"unreadable: {u}" for u in self.unreadable)
        out.append(
            f"fluxlint: {self.files} file(s), {len(self.findings)} "
            f"finding(s), {len(self.baselined)} baselined, "
            f"{self.suppressed} suppressed"
        )
        return "\n".join(out)


def lint_modules(
    modules: list[ModuleSource],
    rules: Iterable[Rule],
    ctx: Any,
    baseline: Baseline | None = None,
) -> Report:
    """Run ``rules`` over parsed ``modules``; apply suppressions, then
    the baseline. The shared core of the CLI and the in-process tests."""
    report = Report()
    report.files = len(modules)
    raw: list[Finding] = []
    rules = list(rules)
    for rule in rules:
        for module in modules:
            for f in rule.check(module, ctx):
                if module.suppressed(f.line, f.rule):
                    report.suppressed += 1
                else:
                    raw.append(f)
        for f in rule.project_check(modules, ctx):
            by_path = {m.path: m for m in modules}
            m = by_path.get(f.path)
            if m is not None and m.suppressed(f.line, f.rule):
                report.suppressed += 1
            else:
                raw.append(f)
    raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if baseline is None:
        report.findings = raw
        return report
    active, baselined, hygiene = baseline.apply(raw)
    report.findings = active + hygiene
    report.baselined = baselined
    return report


def parse_files(
    paths: Iterable[str],
    repo_root: str,
    read: Callable[[str], str],
) -> tuple[list[ModuleSource], list[str]]:
    """Parse ``paths`` (absolute) into modules keyed by repo-relative
    posix paths; unreadable/unparsable files land in the error list."""
    import os

    modules: list[ModuleSource] = []
    errors: list[str] = []
    for path in paths:
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            modules.append(ModuleSource(rel, read(path)))
        except (OSError, SyntaxError, ValueError) as exc:
            errors.append(f"{rel}: {exc}")
    return modules, errors
