"""Project knowledge the port's fluxlint rules check against (the port's
copy of :mod:`fluxmpi_tpu.analysis.context`, reading the port's files).

Every registry the rules consult is **single-sourced from the artifact
that owns it** — never a copied list in this package:

- metric names / closed namespaces / trace-event constants come from
  ``fluxmpi_tpu_torch/telemetry/schema.py``, loaded **by file path** (the
  module is deliberately stdlib-only, so this imports neither torch nor
  jax);
- fault sites come from the ``KNOWN_SITES`` literal in
  ``fluxmpi_tpu_torch/faults.py``, extracted from its AST (importing
  faults.py would pull in torch — the literal IS the registry, so reading
  it statically keeps the lint backend-free);
- the default mesh-axis names come from ``fluxmpi_tpu_torch/config.py``'s
  ``_DEFAULTS`` literal;
- documented env vars come from the reference-table rows of
  ``docs/torch_static_analysis.md`` (lines starting with ``|`` whose
  cells name a backticked ``FLUXMPI_TPU_*`` variable);
- the tests corpus is the concatenated text of the port's tests,
  ``tests/test_torch_*.py`` and their ``tests/_torch_*`` workers (fault-
  site test coverage is a lint-time grep, per the rule contract).

Tests build synthetic contexts directly instead of loading a repo.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
from typing import Any, Iterable

ENV_VAR_RE = re.compile(r"\bFLUXMPI_TPU_[A-Z0-9_]+\b")

_DOC_ROW_RE = re.compile(r"^\s*\|")

SCHEMA_RELPATH = os.path.join("fluxmpi_tpu_torch", "telemetry", "schema.py")
FAULTS_RELPATH = os.path.join("fluxmpi_tpu_torch", "faults.py")
CONFIG_RELPATH = os.path.join("fluxmpi_tpu_torch", "config.py")
ENV_DOC_RELPATH = os.path.join("docs", "torch_static_analysis.md")

# Files outside the default scan set that legitimately read FLUXMPI_TPU_*
# env vars (none: chip_smoke.py and the port's scripts are scanned); the
# undocumented-env-var rule's reverse check scans these too.
EXTRA_ENV_ROOTS: tuple[str, ...] = ()


def load_schema_module(repo_root: str) -> Any:
    """Load ``fluxmpi_tpu_torch/telemetry/schema.py`` by file path — no
    package import, no torch."""
    path = os.path.join(repo_root, SCHEMA_RELPATH)
    spec = importlib.util.spec_from_file_location("_fluxmpi_torch_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def known_fault_sites(repo_root: str) -> frozenset[str]:
    """The ``KNOWN_SITES`` literal of ``fluxmpi_tpu_torch/faults.py``,
    extracted statically (see module docstring)."""
    path = os.path.join(repo_root, FAULTS_RELPATH)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not (isinstance(target, ast.Name) and target.id == "KNOWN_SITES"):
            continue
        value = node.value
        if isinstance(value, ast.Call) and value.args:
            value = value.args[0]  # frozenset({...})
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            elems = [
                e.value
                for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
            return frozenset(elems)
    raise ValueError(
        f"no KNOWN_SITES literal found in {path} — the fault-site "
        f"registry the unregistered-fault-site rule checks against"
    )


def axis_name_literals(repo_root: str) -> frozenset[str]:
    """The default mesh-axis names from ``fluxmpi_tpu_torch/config.py``'s
    ``_DEFAULTS`` literal (the ``*_axis_name`` rows), extracted
    statically — the registry the hand-built-mesh rule checks axis-name
    literals against. Single-sourced: a renamed default axis updates the
    lint with no copy to drift."""
    path = os.path.join(repo_root, CONFIG_RELPATH)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names: set[str] = set()
    for node in ast.walk(tree):
        # `_DEFAULTS: dict[...] = {...}` is an AnnAssign; a bare
        # `_DEFAULTS = {...}` would be an Assign — accept both.
        if isinstance(node, ast.AnnAssign):
            target = node.target
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == "_DEFAULTS"):
            continue
        if isinstance(node.value, ast.Dict):
            for key, value in zip(node.value.keys, node.value.values):
                if (
                    isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and key.value.endswith("_axis_name")
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                ):
                    names.add(value.value)
    if not names:
        raise ValueError(
            f"no *_axis_name defaults found in {path} — the axis-name "
            f"registry the hand-built-mesh rule checks against"
        )
    return frozenset(names)


def documented_env_vars(repo_root: str) -> dict[str, int]:
    """Env vars named in the docs reference table → line number of the
    row. Only table rows count (prose mentions are documentation *about*
    a variable, not its reference entry)."""
    path = os.path.join(repo_root, ENV_DOC_RELPATH)
    out: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            if not _DOC_ROW_RE.match(line):
                continue
            for var in ENV_VAR_RE.findall(line):
                out.setdefault(var, i)
    return out


def tests_corpus(repo_root: str) -> str:
    """Concatenated text of the port's tests (``tests/test_torch_*.py``
    and the ``tests/_torch_*.py`` workers) for coverage greps."""
    tests_dir = os.path.join(repo_root, "tests")
    chunks: list[str] = []
    try:
        names = sorted(os.listdir(tests_dir))
    except FileNotFoundError:
        return ""
    for name in names:
        if not name.endswith(".py") or not name.startswith(("test_torch_", "_torch_")):
            continue
        try:
            with open(
                os.path.join(tests_dir, name), encoding="utf-8"
            ) as f:
                chunks.append(f.read())
        except OSError:
            continue
    return "\n".join(chunks)


def env_vars_in_source(
    text: str, tree: ast.AST | None = None
) -> dict[str, int]:
    """``FLUXMPI_TPU_*`` string literals in python source → first line,
    docstrings excluded (a variable mentioned only in prose is not a
    read). Pass an already-parsed ``tree`` to skip the re-parse; falls
    back to a raw-text regex when the file doesn't parse."""
    if tree is None:
        try:
            tree = ast.parse(text)
        except (SyntaxError, ValueError):
            out: dict[str, int] = {}
            for i, line in enumerate(text.splitlines(), 1):
                for var in ENV_VAR_RE.findall(line):
                    out.setdefault(var, i)
            return out
    doc_consts: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                doc_consts.add(id(body[0].value))
    out = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in doc_consts
        ):
            for var in ENV_VAR_RE.findall(node.value):
                out.setdefault(var, node.lineno)
    return out


class ProjectContext:
    """Everything the rules need to know about the repo. Built once per
    lint run by :meth:`load`; tests construct instances directly with
    synthetic registries."""

    def __init__(
        self,
        *,
        known_metric_names: frozenset[str] = frozenset(),
        closed_namespaces: tuple[str, ...] = (),
        preemption_event: str = "train.preemption",
        anomaly_event_prefix: str = "anomaly.",
        known_fault_sites: frozenset[str] = frozenset(),
        documented_env_vars: dict[str, int] | None = None,
        extra_env_vars: Iterable[str] = (),
        tests_corpus: str = "",
        env_doc_path: str = "docs/torch_static_analysis.md",
        faults_path: str = "fluxmpi_tpu_torch/faults.py",
        axis_name_literals: frozenset[str] = frozenset(),
    ):
        self.known_metric_names = known_metric_names
        self.closed_namespaces = closed_namespaces
        self.preemption_event = preemption_event
        self.anomaly_event_prefix = anomaly_event_prefix
        self.known_fault_sites = known_fault_sites
        self.documented_env_vars = documented_env_vars or {}
        # Env vars read by files outside the scan set.
        self.extra_env_vars = frozenset(extra_env_vars)
        self.tests_corpus = tests_corpus
        self.env_doc_path = env_doc_path
        self.faults_path = faults_path
        self.axis_name_literals = axis_name_literals

    @classmethod
    def load(cls, repo_root: str) -> "ProjectContext":
        schema = load_schema_module(repo_root)
        extra: set[str] = set()
        for rel in EXTRA_ENV_ROOTS:
            try:
                with open(
                    os.path.join(repo_root, rel), encoding="utf-8"
                ) as f:
                    extra.update(env_vars_in_source(f.read()))
            except OSError:
                continue
        return cls(
            known_metric_names=frozenset(schema.KNOWN_METRIC_NAMES),
            closed_namespaces=tuple(schema._CLOSED_NAMESPACES),
            preemption_event=schema.PREEMPTION_EVENT,
            anomaly_event_prefix=schema.ANOMALY_EVENT_PREFIX,
            known_fault_sites=known_fault_sites(repo_root),
            documented_env_vars=documented_env_vars(repo_root),
            extra_env_vars=extra,
            tests_corpus=tests_corpus(repo_root),
            axis_name_literals=axis_name_literals(repo_root),
        )
