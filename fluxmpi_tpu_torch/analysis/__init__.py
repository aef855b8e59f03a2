"""fluxlint for the port — the AST-based SPMD / hot-path invariant
checker over ``fluxmpi_tpu_torch``, its examples and scripts.

The port's own copy of :mod:`fluxmpi_tpu.analysis`, pure stdlib: it
imports neither torch nor jax. It enforces statically that every rank
executes the same collective sequence (the port's ``comm`` surface, the
``torch.distributed`` rendezvous, the checkpoint save and restore),
instrumentation stays behind the zero-cost-when-off guard on the hot
paths, meshes and process groups come from the plan, and the string
registries (metric names, fault sites, ``FLUXMPI_TPU_*`` env vars) stay
in sync with the port's ``telemetry/schema.py``, ``faults.KNOWN_SITES``
and ``docs/torch_static_analysis.md``. Run it via
``scripts/fluxlint_torch.py`` (which loads this package by path, so a
lint run never initialises CUDA) or in-process::

    report = lint_repo("/path/to/repo")
    assert report.exit_code == 0, report.text()

Rule catalogue, suppression (``# fluxlint: disable=<rule>``) and baseline
workflow: docs/torch_static_analysis.md.
"""

from __future__ import annotations

import os
from typing import Iterable

from .context import ProjectContext, load_schema_module
from .core import (
    BASELINE_BASENAME,
    JSON_SCHEMA,
    Baseline,
    Finding,
    ModuleSource,
    Report,
    Rule,
    lint_modules,
    parse_files,
)
from .rules import DEFAULT_HOT_FUNCTIONS, default_rules

__all__ = [
    "BASELINE_BASENAME",
    "JSON_SCHEMA",
    "Baseline",
    "DEFAULT_HOT_FUNCTIONS",
    "DEFAULT_TARGETS",
    "Finding",
    "ModuleSource",
    "ProjectContext",
    "Report",
    "Rule",
    "default_rules",
    "lint_modules",
    "lint_repo",
    "lint_source",
    "load_schema_module",
    "collect_py_files",
]


def collect_py_files(targets: Iterable[str], repo_root: str) -> list[str]:
    """Absolute paths of the ``.py`` files under ``targets`` (files or
    directories, absolute or repo-root-relative), ``__pycache__``
    pruned, sorted for stable reports."""
    out: list[str] = []
    for target in targets:
        path = (
            target
            if os.path.isabs(target)
            else os.path.join(repo_root, target)
        )
        if os.path.isfile(path):
            out.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in filenames:
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(out)


# The port's lint targets: the package, its examples, the card script and
# the port's own scripts.
DEFAULT_TARGETS = (
    "fluxmpi_tpu_torch",
    "examples_torch",
    "chip_smoke.py",
    "scripts/kernel_ab.py",
    "scripts/bf16_grad_bound.py",
    "scripts/resnet_f32_probe.py",
    "scripts/zoo_grad_probe.py",
    "scripts/resnet_determinism_probe.py",
    "scripts/fluxlint_torch.py",
)


def lint_repo(
    repo_root: str,
    targets: Iterable[str] = DEFAULT_TARGETS,
    *,
    baseline_path: str | None = None,
    context: ProjectContext | None = None,
    rules: Iterable[Rule] | None = None,
) -> Report:
    """Lint ``targets`` under ``repo_root`` with the default rule set,
    project context, and baseline (``.fluxlint-torch-baseline.json`` at
    the repo root unless overridden)."""
    repo_root = os.path.abspath(repo_root)
    ctx = context if context is not None else ProjectContext.load(repo_root)
    files = collect_py_files(targets, repo_root)

    def read(path: str) -> str:
        with open(path, encoding="utf-8") as f:
            return f.read()

    modules, errors = parse_files(files, repo_root, read)
    if baseline_path is None:
        baseline_path = os.path.join(repo_root, BASELINE_BASENAME)
    # An empty baseline_path means "no baseline" (every finding active).
    baseline = Baseline.load(baseline_path) if baseline_path else None
    report = lint_modules(
        modules,
        rules if rules is not None else default_rules(),
        ctx,
        baseline,
    )
    report.unreadable.extend(errors)
    return report


def lint_source(
    source: str,
    path: str,
    context: ProjectContext,
    rules: Iterable[Rule] | None = None,
    baseline: Baseline | None = None,
) -> Report:
    """Lint one in-memory source snippet as if it lived at ``path``
    (repo-relative) — the fixture-test entry point."""
    module = ModuleSource(path, source)
    return lint_modules(
        [module],
        rules if rules is not None else default_rules(),
        context,
        baseline,
    )
