#!/usr/bin/env python
"""fluxlint for the port — run the AST-based SPMD/hot-path invariant
checker of ``fluxmpi_tpu_torch/analysis/`` over the port's source trees.

Usage:
    python scripts/fluxlint_torch.py [PATH ...] [--json] [--baseline FILE]
                                     [--no-baseline]

- PATHs are files or directories, absolute or repo-root-relative;
  default: the package's ``DEFAULT_TARGETS`` (``fluxmpi_tpu_torch``,
  ``examples_torch``, ``chip_smoke.py`` and the port's scripts).
- ``--json`` emits one ``fluxmpi_tpu.fluxlint/v1`` report object on
  stdout instead of text lines.
- ``--baseline FILE`` overrides the default
  ``.fluxlint-torch-baseline.json`` at the repo root; ``--no-baseline``
  runs raw (every finding active).

Exit codes: 0 clean, 1 findings, 2 unreadable input (unparsable file,
missing registry source).

The analysis package is loaded **by file path** — not via
``import fluxmpi_tpu_torch`` — so a lint run imports neither torch nor
jax and never initialises CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PKG_NAME = "_fluxmpi_torch_analysis"


def load_analysis(repo_root: str = _REPO):
    """Load ``fluxmpi_tpu_torch/analysis`` as a standalone package (no
    parent ``fluxmpi_tpu_torch`` import, hence no torch)."""
    if _PKG_NAME in sys.modules:
        return sys.modules[_PKG_NAME]
    pkg_dir = os.path.join(repo_root, "fluxmpi_tpu_torch", "analysis")
    spec = importlib.util.spec_from_file_location(
        _PKG_NAME,
        os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_PKG_NAME] = mod  # registered first so `from .x import`
    try:                          # inside the package resolves
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(_PKG_NAME, None)
        raise
    return mod


def main(argv: list[str]) -> int:
    as_json = False
    baseline_path: str | None = None
    no_baseline = False
    targets: list[str] = []
    it = iter(argv)
    for arg in it:
        if arg == "--json":
            as_json = True
        elif arg == "--baseline":
            baseline_path = next(it, None)
            if baseline_path is None:
                print("--baseline needs a FILE argument", file=sys.stderr)
                return 2
        elif arg == "--no-baseline":
            no_baseline = True
        elif arg in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            targets.append(arg)
    try:
        analysis = load_analysis()
    except (OSError, SyntaxError) as exc:
        print(f"fluxlint: cannot load analysis package: {exc}", file=sys.stderr)
        return 2
    if not targets:
        targets = list(analysis.DEFAULT_TARGETS)
    if no_baseline:
        baseline_path = ""
    try:
        report = analysis.lint_repo(
            _REPO, targets, baseline_path=baseline_path
        )
    except (OSError, ValueError) as exc:
        # Missing/garbled registry sources (schema.py, faults.py, the
        # docs table) are unreadable-input failures, not findings.
        print(f"fluxlint: {exc}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(report.to_json(), indent=1, sort_keys=True))
    else:
        print(report.text())
    return report.exit_code


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
