"""C.9: ``init`` wires the fault and preemption planes and ``shutdown``
resets them, in the port as in the JAX package.

Each script below runs through the JAX package (on its CPU mesh) and then
through the port (``device="cpu"``), and after every step the two must
agree on the armed fault schedule (``faults.active()``, as strings), the
preemption flag (``preemption_requested()``) and whether the
flag-setting signal handlers are installed
(``preemption_handlers_installed()``): the environment variables
``FLUXMPI_TPU_FAULTS`` and ``FLUXMPI_TPU_PREEMPTION`` read by the first
``init``; ``init(faults=, preemption=)`` on a first and a repeated call; a
schedule and handlers installed by hand, a requested preemption, then
``shutdown``, which leaves neither plane armed. Exact equality: these are
flags and strings. Each test leaves both runtimes initialized or not, as
it found them.
"""

import importlib

import pytest
import torch

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm

torch.set_num_threads(1)

PACKAGES = {"jax": jfm, "port": tfm}


def _init(pkg, **kw):
    return pkg.init(**kw) if pkg is jfm else pkg.init(device="cpu", **kw)


def _faults(pkg):
    return importlib.import_module(pkg.__name__ + ".faults")


def _runtime(pkg):
    return importlib.import_module(pkg.__name__ + ".runtime")


def _snap(pkg):
    rt = _runtime(pkg)
    return ([str(s) for s in _faults(pkg).active()], rt.preemption_requested(),
            rt.preemption_handlers_installed())


def _reset(pkg):
    pkg.shutdown()
    _faults(pkg).clear()
    _runtime(pkg).uninstall_preemption_handlers()


@pytest.fixture(autouse=True)
def _restore_runtimes():
    """Leave each package's runtime as the test found it: other test files
    in this process keep an initialized JAX runtime in a session fixture."""
    was = {label: pkg.is_initialized() for label, pkg in PACKAGES.items()}
    yield
    for label, pkg in PACKAGES.items():
        _reset(pkg)
        if was[label]:
            _init(pkg)


SCRIPTS = {
    "environment": (
        {"FLUXMPI_TPU_FAULTS": "data.fetch@step=3", "FLUXMPI_TPU_PREEMPTION": "1"},
        [("init", lambda p: _init(p)),
         ("repeated init", lambda p: _init(p)),
         ("shutdown", lambda p: p.shutdown())]),
    "environment, one signal": (
        {"FLUXMPI_TPU_FAULTS": "comm.allreduce@step=2:times=2",
         "FLUXMPI_TPU_PREEMPTION": "int"},
        [("init", lambda p: _init(p)),
         ("shutdown", lambda p: p.shutdown())]),
    "by hand, then shutdown": (
        {},
        [("init", lambda p: _init(p)),
         ("faults.install", lambda p: _faults(p).install("data.fetch@step=3")),
         ("install_preemption_handlers",
          lambda p: _runtime(p).install_preemption_handlers()),
         ("request_preemption", lambda p: _runtime(p).request_preemption()),
         ("shutdown", lambda p: p.shutdown())]),
    "arguments": (
        {},
        [("init(faults=, preemption=)",
          lambda p: _init(p, faults="data.fetch@step=5", preemption="term")),
         ("repeated init(faults=False, preemption=False)",
          lambda p: _init(p, faults=False, preemption=False)),
         ("repeated init(preemption=True)", lambda p: _init(p, preemption=True)),
         ("shutdown", lambda p: p.shutdown())]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_fault_and_preemption_planes_follow_the_jax_package(script, monkeypatch):
    env, steps = SCRIPTS[script]
    for name in ("FLUXMPI_TPU_FAULTS", "FLUXMPI_TPU_PREEMPTION"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    seen = {}
    for label, pkg in PACKAGES.items():
        _reset(pkg)
        try:
            seen[label] = [(step, (run(pkg), _snap(pkg))[1]) for step, run in steps]
        finally:
            _reset(pkg)
    assert seen["port"] == seen["jax"]
    # Every script arms something before its shutdown, and nothing after.
    assert any(s[0] or s[2] for _, s in seen["port"][:-1])
    assert seen["port"][-1][1] == ([], False, False)


def test_a_bad_preemption_spec_raises_as_in_the_jax_package(monkeypatch):
    monkeypatch.delenv("FLUXMPI_TPU_PREEMPTION", raising=False)
    messages = {}
    for label, pkg in PACKAGES.items():
        _reset(pkg)
        try:
            with pytest.raises(ValueError) as err:
                _init(pkg, preemption="sometimes")
            messages[label] = str(err.value)
        finally:
            _reset(pkg)
    assert messages["port"] == messages["jax"]
    assert "'sometimes'" in messages["port"]
