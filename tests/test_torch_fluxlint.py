"""fluxlint for the port (``fluxmpi_tpu_torch/analysis/``, driven by
``scripts/fluxlint_torch.py``), AST-only and fast:

- the port's ``core`` and ``flow`` give the JAX package's output on the
  same inputs: ``Report.text()``/``to_json()``, baseline matching and
  staleness, suppression, ``parse_files`` errors, and
  ``rank_condition``/``classify_guard`` on a shared corpus of snippets;
  the port's rank conditions also know ``dist.get_rank()`` and a mesh
  coordinate;
- each of the six carried rules, on mirrored fixtures (the JAX idiom
  through the JAX rule, the torch idiom through the port's rule), gives
  the same rule id, severity, lines and count, positive and negative;
- violations planted in copies of real port files are found;
- the default targets lint clean, and the CLI's exit codes;
- the package, loaded by path, imports neither torch nor jax.
"""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLI = os.path.join(_REPO, "scripts", "fluxlint_torch.py")


def _load(script):
    spec = importlib.util.spec_from_file_location(
        f"_{script}_cli", os.path.join(_REPO, "scripts", f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_analysis(_REPO)


JAX = _load("fluxlint")
PORT = _load("fluxlint_torch")
J = {n: sys.modules[f"{JAX.__name__}.{n}"] for n in ("core", "flow", "rules")}
T = {n: sys.modules[f"{PORT.__name__}.{n}"] for n in ("core", "flow", "rules")}


def _ctx(pkg, **kw):
    defaults = dict(
        known_metric_names=frozenset({"train.loss", "fault.injected"}),
        closed_namespaces=("fault.",),
        known_fault_sites=frozenset({"ckpt.write", "data.fetch"}),
        documented_env_vars={"FLUXMPI_TPU_DOCUMENTED": 10},
        tests_corpus="scope('ckpt.write') scope('data.fetch')",
        axis_name_literals=frozenset({"dp", "tp", "sp"}),
    )
    defaults.update(kw)
    return pkg.ProjectContext(**defaults)


def _found(report):
    return [(f.rule, f.severity, f.line) for f in report.findings]


# ---------------------------------------------------------------------------
# core and flow: the same output as the JAX package's
# ---------------------------------------------------------------------------

_SNIPPET = textwrap.dedent('''
    def f(reg):
        reg.counter("bad.metric").inc()
        reg.counter("train.loss").inc()
        reg.gauge("also.bad").set(1)  # fluxlint: disable=unknown-metric-name
        # fluxlint: disable=unknown-metric-name
        reg.histogram("own.line")
''')


def _report(pkg, rules_mod, src=_SNIPPET, baseline=None):
    return pkg.lint_source(src, "pkg/b.py", _ctx(pkg), rules=[rules_mod.UnknownMetricName()],
                           baseline=baseline)


def test_reports_text_and_json_match_jax():
    j, t = _report(JAX, J["rules"]), _report(PORT, T["rules"])
    assert t.text() == j.text()
    assert t.to_json() == j.to_json()
    assert t.to_json()["schema"] == "fluxmpi_tpu.fluxlint/v1"
    assert (t.suppressed, t.exit_code) == (j.suppressed, j.exit_code) == (2, 1)


@pytest.mark.parametrize("entries,src", [
    ([{"rule": "unknown-metric-name", "path": "pkg/b.py", "key": "bad.metric",
       "justification": "legacy name"}], _SNIPPET),
    ([{"rule": "unknown-metric-name", "path": "pkg/b.py", "key": "bad.metric",
       "justification": ""}], _SNIPPET),
    ([{"rule": "unknown-metric-name", "path": "pkg/b.py", "key": "gone.metric",
       "justification": "was real once"}], "x = 1\n"),
], ids=["justified", "unjustified", "stale"])
def test_baseline_matching_and_staleness_match_jax(entries, src, tmp_path):
    path = tmp_path / "base.json"
    path.write_text(json.dumps({"entries": entries}))
    j = _report(JAX, J["rules"], src, J["core"].Baseline.load(str(path)))
    t = _report(PORT, T["rules"], src, T["core"].Baseline.load(str(path)))
    assert t.to_json() == j.to_json()


def test_parse_file_errors_match_jax(tmp_path):
    good, bad = tmp_path / "good.py", tmp_path / "bad.py"
    good.write_text("x = 1\n")
    bad.write_text("def f(:\n")

    def run(core):
        mods, errs = core.parse_files([str(good), str(bad)], str(tmp_path),
                                      lambda p: open(p).read())
        return [m.path for m in mods], errs

    assert run(T["core"]) == run(J["core"])


# A shared corpus: (function source, the `if` test of its last statement).
_CORPUS = [
    "def f():\n    if jax.process_index() == 0:\n        pass",
    "def f():\n    lead = process_index() == 0\n    ok = lead\n    if ok:\n        pass",
    "def f():\n    if process_count() > 1:\n        pass",
    "def f():\n    if local_rank() != 0 and x:\n        pass",
    "def f():\n    if _instrumentation_on():\n        pass",
    "def f():\n    if not reg.enabled:\n        pass",
    "def f():\n    on = reg.enabled or tracer.enabled\n    if on:\n        pass",
    "def f():\n    off = not reg.enabled\n    if off:\n        pass",
    "def f():\n    h = reg.gauge('x') if reg.enabled else None\n    if h is not None:\n        pass",
    "def f():\n    h = reg.gauge('x') if reg.enabled else None\n    if h is None:\n        pass",
    "def f():\n    if reg.enabled and x:\n        pass",
    "def f():\n    if x or reg.enabled:\n        pass",
]


@pytest.mark.parametrize("src", _CORPUS)
def test_rank_condition_and_classify_guard_match_jax(src):
    fn = ast.parse(src).body[0]
    test = fn.body[-1].test
    out = []
    for flow in (J["flow"], T["flow"]):
        out.append((flow.rank_condition(test, flow.rank_derived_names(fn)),
                    flow.classify_guard(test, flow.guard_derived_names(fn))))
    assert out[0] == out[1]


@pytest.mark.parametrize("expr,rank", [
    ("dist.get_rank() == 0", True), ("mesh.coords(mesh.my_rank())['sp'] == 0", True),
    ("fm.local_rank() == 0", True), ("runtime.local_rank() > 0", True),
    ("mesh.block_index(me, 'tp')[0] == 0", True), ("dist.get_world_size() > 1", False),
])
def test_port_rank_conditions_know_the_torch_spellings(expr, rank):
    assert T["flow"].rank_condition(ast.parse(expr, mode="eval").body, set()) is rank


# ---------------------------------------------------------------------------
# The six carried rules: mirrored fixtures, JAX idiom vs torch idiom
# ---------------------------------------------------------------------------

# (rule class, path, JAX source, port source, expected finding count)
_MIRRORED = {
    "spmd-branch": ("SpmdDivergentCollective", "pkg/a.py", """
        def f(x):
            if jax.process_index() == 0:
                comm.allreduce(x)
        """, """
        def f(x):
            if dist.get_rank() == 0:
                dist.barrier()
        """, 1),
    "spmd-early-exit": ("SpmdDivergentCollective", "pkg/a.py", """
        def f(x):
            lead = jax.process_index() == 0
            if not lead:
                return None
            multihost_utils.sync_global_devices("x")
        """, """
        def f(x):
            lead = mesh.coords(mesh.my_rank())["sp"] == 0
            if not lead:
                return None
            dist.all_reduce(x)
        """, 1),
    "spmd-consistent": ("SpmdDivergentCollective", "pkg/a.py", """
        def f(x):
            if jax.process_count() > 1:
                comm.allreduce(x)
        """, """
        def f(x):
            if dist.get_world_size() > 1:
                dist.all_reduce(x)
                dist.new_group([0, 1])
        """, 0),
    "hot-unguarded": ("UnguardedHotPathInstrumentation", "HOT", """
        def _run_collective(x):
            t0 = time.perf_counter()
            _record_op("allreduce", "device", 4, t0, None)
        """, """
        def _instrumented(op_name, path, nbytes, call):
            t0 = time.perf_counter()
            _record_op(op_name, path, nbytes, t0, None)
        """, 2),
    "hot-guarded": ("UnguardedHotPathInstrumentation", "HOT", """
        def _run_collective(x):
            if not _instrumentation_on():
                return x
            t0 = time.perf_counter()
        """, """
        def _instrumented(op_name, path, nbytes, call):
            if not _instrumentation_on():
                return call()
            t0 = time.perf_counter()
        """, 0),
    "metric-unknown": ("UnknownMetricName", "pkg/m.py", """
        def f(reg):
            reg.counter("train.lost").inc()
        """, """
        def f(reg):
            reg.counter("train.lost").inc()
        """, 1),
    "metric-known": ("UnknownMetricName", "pkg/m.py", """
        def f(reg):
            reg.counter("train.loss").inc()
        """, """
        def f(reg):
            reg.counter("train.loss").inc()
        """, 0),
    "fault-unknown": ("UnregisteredFaultSite", "pkg/f.py", """
        def f():
            _faults.check("data.fetc")
        """, """
        def f():
            faults.check("data.fetc")
        """, 1),
    "fault-known": ("UnregisteredFaultSite", "pkg/f.py", """
        def f():
            _faults.check("data.fetch")
        """, """
        def f():
            faults.check("data.fetch")
        """, 0),
    "mesh-built": ("HandBuiltMesh", "MESH", """
        def f(devs):
            m = Mesh(devs, ("x",))
            return P("dp")
        """, """
        def f(devs):
            m = Mesh(devs, ("x",))
            return P("dp")
        """, 2),
    "mesh-constants": ("HandBuiltMesh", "MESH", """
        def f(x):
            return P(config.DP_AXIS_NAME)
        """, """
        def f(x):
            return P(config.DP_AXIS_NAME)
        """, 0),
    "env-undocumented": ("UndocumentedEnvVar", "pkg/e.py", """
        import os
        X = os.environ.get("FLUXMPI_TPU_NOT_IN_TABLE")
        """, """
        import os
        X = os.environ.get("FLUXMPI_TPU_NOT_IN_TABLE")
        """, 1),
    "env-documented": ("UndocumentedEnvVar", "pkg/e.py", """
        import os
        X = os.environ.get("FLUXMPI_TPU_DOCUMENTED")
        """, """
        import os
        X = os.environ.get("FLUXMPI_TPU_DOCUMENTED")
        """, 0),
}
_PATHS = {
    "HOT": ("fluxmpi_tpu/comm.py", "fluxmpi_tpu_torch/comm.py"),
    "MESH": ("fluxmpi_tpu/parallel/ring.py", "fluxmpi_tpu_torch/parallel/ring.py"),
}


@pytest.mark.parametrize("case", sorted(_MIRRORED))
def test_mirrored_fixtures_give_the_same_findings(case):
    rule, path, jsrc, tsrc, count = _MIRRORED[case]
    jpath, tpath = _PATHS.get(path, (path, path))
    j = JAX.lint_source(textwrap.dedent(jsrc), jpath, _ctx(JAX),
                        rules=[getattr(J["rules"], rule)()])
    t = PORT.lint_source(textwrap.dedent(tsrc), tpath, _ctx(PORT),
                         rules=[getattr(T["rules"], rule)()])
    assert _found(t) == _found(j)
    assert len(t.findings) == count
    assert {f.rule for f in t.findings} <= {getattr(T["rules"], rule).id}


def test_port_rules_are_the_jax_rules_but_jax_compat_drift():
    ids = [r.id for r in PORT.default_rules()]
    assert ids == [r.id for r in JAX.default_rules() if r.id != "jax-compat-drift"]
    assert [r.severity for r in PORT.default_rules()] == [
        r.severity for r in JAX.default_rules() if r.id != "jax-compat-drift"]
    assert "jax-compat-drift" in T["rules"].__doc__


# ---------------------------------------------------------------------------
# Violations planted in copies of real port files
# ---------------------------------------------------------------------------

def _plant(tmp_path, rel, edit):
    src = open(os.path.join(_REPO, rel)).read()
    new = edit(src)
    assert new != src, "the plant did not apply"
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(new)
    return PORT.lint_repo(str(tmp_path), [rel], context=CTX, baseline_path="")


CTX = PORT.ProjectContext.load(_REPO)
_APPEND = "\n\ndef _planted(x):\n{}\n"
_PLANTS = {
    "guard-removed": ("fluxmpi_tpu_torch/comm.py", "unguarded-hot-path-instrumentation",
                      lambda s: s.replace("    if not _instrumentation_on():\n"
                                          "        return call()\n", "", 1)),
    "rank-barrier": ("fluxmpi_tpu_torch/sync.py", "spmd-divergent-collective",
                     lambda s: s + _APPEND.format(
                         "    if dist.get_rank() == 0:\n        dist.barrier()")),
    "unknown-metric": ("fluxmpi_tpu_torch/comm.py", "unknown-metric-name",
                       lambda s: s + _APPEND.format(
                           '    _telemetry_registry().counter("comm.call").inc()')),
    "unregistered-site": ("fluxmpi_tpu_torch/data.py", "unregistered-fault-site",
                          lambda s: s + _APPEND.format('    faults.check("data.fetched")')),
    "new-group": ("fluxmpi_tpu_torch/parallel/ring.py", "hand-built-mesh",
                  lambda s: s + _APPEND.format("    return dist.new_group([0, 1])")),
    "undocumented-env": ("fluxmpi_tpu_torch/data.py", "undocumented-env-var",
                         lambda s: s + _APPEND.format(
                             '    return os.environ.get("FLUXMPI_TPU_PLANTED")')),
}


@pytest.mark.parametrize("plant", sorted(_PLANTS))
def test_planted_violation_in_a_port_file_is_found(tmp_path, plant):
    rel, rule, edit = _PLANTS[plant]
    report = _plant(tmp_path, rel, edit)
    assert report.findings and {f.rule for f in report.findings} == {rule}, report.text()
    assert report.exit_code == 1


# ---------------------------------------------------------------------------
# The repo, the CLI, the imports
# ---------------------------------------------------------------------------

def test_port_is_fluxlint_clean():
    report = PORT.lint_repo(_REPO)
    assert report.unreadable == []
    assert report.findings == [], report.text()
    assert report.files > 60
    base = json.load(open(os.path.join(_REPO, ".fluxlint-torch-baseline.json")))
    assert base["schema"] == "fluxmpi_tpu.fluxlint/v1-baseline" and base["entries"] == []


def _cli(*args):
    return subprocess.run([sys.executable, _CLI, *args], capture_output=True, text=True,
                          cwd=_REPO)


def test_cli_exit_codes(tmp_path):
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["schema"] == "fluxmpi_tpu.fluxlint/v1" and data["findings"] == []
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    if dist.get_rank() == 0:\n        dist.all_reduce(x)\n")
    proc = _cli(str(bad), "--no-baseline")
    assert proc.returncode == 1 and "spmd-divergent-collective" in proc.stdout
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert _cli(str(broken)).returncode == 2
    assert _cli("--baseline").returncode == 2


def test_loaded_by_path_it_imports_neither_torch_nor_jax():
    code = ("import sys; sys.path.insert(0, 'scripts'); import fluxlint_torch as f; "
            "a = f.load_analysis(); r = a.lint_repo('.'); "
            "bad = [m for m in ('torch', 'jax', 'fluxmpi_tpu', 'fluxmpi_tpu_torch') "
            "if m in sys.modules]; print(r.exit_code, bad)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0 []"
    for name in os.listdir(os.path.join(_REPO, "fluxmpi_tpu_torch", "analysis")):
        if name.endswith(".py"):
            text = open(os.path.join(_REPO, "fluxmpi_tpu_torch", "analysis", name)).read()
            assert not re.search(r"^\s*(import|from)\s+(torch|jax|flax)\b", text, re.M), name
