"""The port's compile plane, auto-profiler and compile cache against the
JAX package's, on the CPU.

- ``CompileMonitor``: the same sequence of tracked callables, builds and
  flushes through both packages' monitors gives the same flush infos,
  retrace logs and ``compile.*`` records (each package's build event is its
  own: ``jax.monitoring``'s backend compile, the port's ``nvcc`` build or
  CUDA-graph capture). A callable without ``_cache_size`` stays untracked.
- ``train_loop``: the tiny LM fused through both packages with a forced
  width change (a monitor whose warmup does not reopen between two runs,
  the second at another ``flush_every``) fires ``steady_state_retrace``
  naming ``train_loop.window`` in both. The port's CPU windows run eagerly
  and build nothing, so its program's first call is patched to report a
  build, as a capture does on the card. Without the forced change neither
  package reports a retrace.
- ``ops/_build.py`` reports one compile event per source it builds (the
  build command replaced by a stand-in that writes the library file; the
  CPU has no ``nvcc``), into the directory ``enable_compile_cache`` names
  on the card (``torch.cuda.is_available`` patched) and warns and does
  nothing on the CPU.
- Serving: the port's counterpart of the JAX package's
  ``test_midflight_join_zero_retrace`` (the port has no jit cache: zero
  compile events after the warmup boundary, and the engine's steps stay
  untracked).
- The auto-profiler over ``torch.profiler``: a triggered capture writes one
  Chrome trace into the directory, the per-run budget and the forced
  capture behave as the JAX package's, ``profile_trace`` refuses to start
  inside a CUDA-graph capture and leaves no profiler running when its
  block raises, and the configure forms and environment variables match.
"""

import json
import os
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.parallel import train as ttrain
from fluxmpi_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)
JAX_BUILD = "/jax/core/compile/backend_compile_duration"


def _monitor_script(cp, build_event):
    """A fixed sequence through one package's compile plane; returns the
    flush infos, the retrace log and the compile.* records."""
    reg = (jtel if cp.__name__.startswith("fluxmpi_tpu.") else ttel).MetricsRegistry()
    mon = cp.CompileMonitor(registry=reg)

    class Cached:
        def __init__(self):
            self.n = 1

        def _cache_size(self):
            return self.n

    step, eager = Cached(), (lambda: None)
    mon.track("train_loop.step", step)
    mon.track("serving.decode_step", eager)
    mon.track_aot("train_loop.window")
    infos = []
    mon._note_duration(build_event, 0.5)
    mon.note_aot_compile("train_loop.window", 0.5)
    infos.append(mon.observe_flush(reg))           # warmup boundary
    infos.append(mon.observe_flush(reg))           # quiet
    step.n = 3                                      # two retraces of the step
    mon._note_duration(build_event, 0.25)
    mon._note_duration(build_event, 0.25)
    infos.append(mon.observe_flush(reg))
    mon._note_duration(build_event, 0.125)         # nobody grew: untracked
    infos.append(mon.observe_flush(reg))
    mon.note_aot_compile("train_loop.window", 0.25)
    mon._note_duration(build_event, 0.25)
    infos.append(mon.observe_flush(reg))
    retraces = list(mon.retraces)
    mon.reset_run()
    mon.note_aot_compile("train_loop.window", 0.25)
    mon._note_duration(build_event, 0.25)
    infos.append(mon.observe_flush(reg))           # a new run's warmup
    recs = sorted((m["name"], tuple(sorted(m["labels"].items())), m["value"])
                  for m in reg.snapshot())
    return infos, retraces, recs, mon._cache_size(eager)


def test_monitor_attribution_matches_the_jax_monitor():
    from fluxmpi_tpu.telemetry import compileplane as jcp
    from fluxmpi_tpu_torch.telemetry import compileplane as tcp

    want = _monitor_script(jcp, JAX_BUILD)
    for event in (tcp.BUILD_EVENT, tcp.CAPTURE_EVENT):
        assert _monitor_script(tcp, event) == want
    infos, retraces, recs, untracked = want
    assert [i["steady"] for i in infos] == [False, True, True, True, True, False]
    assert infos[2]["functions"] == ["train_loop.step"]
    assert infos[3]["functions"] == ["<untracked>"] and tcp.UNTRACKED == jcp.UNTRACKED
    assert infos[4]["functions"] == ["train_loop.window"]
    assert len(retraces) == 3 and untracked == -1
    assert tcp.get_compile_monitor() is None
    tcp.note_duration(tcp.BUILD_EVENT, 1.0)  # no monitor: nothing to do


def test_configure_forms_match(monkeypatch):
    from fluxmpi_tpu.telemetry import compileplane as jcp
    from fluxmpi_tpu_torch.telemetry import compileplane as tcp

    for cp in (tcp, jcp):
        # Whatever an earlier test of this process installed stays out of
        # the way, and comes back after.
        prev = cp.set_compile_monitor(None)
        try:
            assert cp.configure() is None
            monkeypatch.setenv("FLUXMPI_TPU_COMPILEPLANE", "1")
            mon = cp.configure()
            assert isinstance(mon, cp.CompileMonitor) and cp.configure(True) is mon
            with pytest.raises(ValueError, match="compileplane spec"):
                cp.configure("sometimes")
            assert cp.configure("0") is None and cp.get_compile_monitor() is None
            monkeypatch.delenv("FLUXMPI_TPU_COMPILEPLANE")
        finally:
            cp.set_compile_monitor(prev)


# ---------------------------------------------------------------------------
# train_loop: the window program's builds, and a forced width change
# ---------------------------------------------------------------------------


def _corpus(n=32, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 97, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % 97)
    return np.concatenate(seqs, axis=1).astype(np.int32)


class _SpanningMonitor:
    """Mix-in: a compile monitor whose warmup does not reopen when a new
    ``train_loop`` starts (a monitor spanning an outer loop's runs)."""

    def reset_run(self):
        self.retraces = []


@pytest.fixture(scope="module")
def lm_params():
    jlm = JaxLM(**CFG, attention="flash")
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False)
    return jlm, jax.tree_util.tree_map(np.asarray, params)


def _jax_widths(lm_params, widths, spanning):
    jlm, params = lm_params
    corpus = _corpus()
    base = jtel.compileplane.CompileMonitor
    mon = (type("M", (_SpanningMonitor, base), {})() if spanning else base())
    det = jtel.AnomalyDetector(dump=False, registry=jtel.MetricsRegistry())
    jtel.compileplane.set_compile_monitor(mon)
    jtel.anomaly.set_anomaly_detector(det)
    try:
        loader = jfm.DistributedDataLoader(
            jfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8)

        def loss_fn(p, ms, b):
            return jlm.apply(p, b[0], train=False, targets=b[1], loss_chunk=64).mean(), ms

        opt = optax.adamw(1e-3)
        step = jax_make_train_step(loss_fn, opt)
        state = replicate(JaxTrainState.create(params, opt))
        summaries = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for w in widths:
                state, s = jax_train_loop(step, state, loader, steps=4, flush_every=w,
                                          fuse="window")
                summaries.append(s)
    finally:
        jtel.compileplane.set_compile_monitor(None)
        jtel.anomaly.set_anomaly_detector(None)
    return summaries, det


def _port_widths(lm_params, widths, spanning, monkeypatch):
    _, params = lm_params
    corpus = _corpus()
    real_run = ttrain.WindowProgram._run

    def run(self, *args):
        # On the card a program's build is its capture; the CPU's windows
        # run eagerly, so its first call reports one as the card's would.
        first = not getattr(self, "_reported", False)
        self._reported = True
        out = real_run(self, *args)
        if first:
            self.last_compile_seconds = 0.01
            self.capture_seconds += 0.01
            ttel.compileplane.note_duration(ttel.compileplane.CAPTURE_EVENT, 0.01)
        return out

    monkeypatch.setattr(ttrain.WindowProgram, "_run", run)
    base = ttel.compileplane.CompileMonitor
    mon = (type("M", (_SpanningMonitor, base), {})() if spanning else base())
    det = ttel.AnomalyDetector(dump=False, registry=ttel.MetricsRegistry())
    ttel.compileplane.set_compile_monitor(mon)
    ttel.anomaly.set_anomaly_detector(det)
    try:
        loader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            device="cpu")
        tlm = TransformerLM(**CFG, attention="flash", device="cpu")
        load_flax_params(tlm, params)

        def loss_fn(p, ms, b):
            return tlm(b[0], targets=b[1], loss_chunk=64).mean(), ms

        opt = optim.adamw(1e-3)
        step = make_train_step(loss_fn, opt)
        state = TrainState.create(tlm, opt)
        summaries = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for w in widths:
                state, s = train_loop(step, state, loader, steps=4, flush_every=w,
                                      fuse="window")
                summaries.append(s)
    finally:
        ttel.compileplane.set_compile_monitor(None)
        ttel.anomaly.set_anomaly_detector(None)
    return summaries, det


def _retrace_names(det):
    return [(e["function"], e["step"]) for e in det.triggered
            if e["rule"] == "steady_state_retrace"]


@pytest.mark.parametrize("spanning", [True, False])
def test_forced_width_change_names_train_loop_window_in_both(world, lm_params,
                                                             monkeypatch, spanning):
    jsum, jdet = _jax_widths(lm_params, (4, 2), spanning)
    tfm.init(device="cpu")
    try:
        tsum, tdet = _port_widths(lm_params, (4, 2), spanning, monkeypatch)
    finally:
        tfm.shutdown()
    assert _retrace_names(tdet) == _retrace_names(jdet)
    assert _retrace_names(tdet) == ([("train_loop.window", 2)] if spanning else [])
    for t, j in zip(tsum, jsum):
        assert set(j) <= set(t)  # C.12: window_compile_seconds is there
        assert t["window_compile_seconds"] == pytest.approx(0.01)
        assert (t["fused_window"], t["window_cache"]) == (j["fused_window"],
                                                          j["window_cache"])


def test_no_retrace_and_no_build_seconds_without_a_capture(lm_params):
    """The CPU's windows build nothing: no compile event, no retrace, and
    ``window_compile_seconds`` 0.0, with the warmup boundary at the first
    flush."""
    _, params = lm_params
    corpus = _corpus()
    mon = ttel.compileplane.CompileMonitor(registry=ttel.MetricsRegistry())
    ttel.compileplane.set_compile_monitor(mon)
    tfm.init(device="cpu")
    try:
        loader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            device="cpu")
        tlm = TransformerLM(**CFG, device="cpu")
        load_flax_params(tlm, params)
        opt = optim.adamw(1e-3)
        step = make_train_step(lambda p, ms, b: (tlm(b[0], targets=b[1]).mean(), ms), opt)
        _, s = train_loop(step, TrainState.create(tlm, opt), loader, steps=4,
                          flush_every=2, fuse="window")
    finally:
        tfm.shutdown()
        ttel.compileplane.set_compile_monitor(None)
    assert s["window_compile_seconds"] == 0.0 and mon.steady and mon.retraces == []
    assert mon.events == 0


# ---------------------------------------------------------------------------
# Kernel builds and the compile cache
# ---------------------------------------------------------------------------


def test_kernel_builds_are_compile_events_into_the_cache_dir(tmp_path, monkeypatch):
    from fluxmpi_tpu_torch import runtime
    from fluxmpi_tpu_torch.ops import _build

    default = _build.BUILD_DIR
    monkeypatch.setattr(_build, "_command", lambda name, out: [
        "python3", "-c", f"open({str(out)!r}, 'w').close()"])
    mon = ttel.compileplane.CompileMonitor(registry=ttel.MetricsRegistry())
    ttel.compileplane.set_compile_monitor(mon)
    try:
        with pytest.warns(UserWarning, match="compile cache skipped"):
            assert runtime.enable_compile_cache(str(tmp_path / "cpu")) is False
        assert _build.BUILD_DIR == default
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert runtime.enable_compile_cache(str(tmp_path / "cache")) is True
        assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
        paths = _build.build_all()
        assert set(paths) == set(_build.SOURCES)
        assert all(p.parent == (tmp_path / "cache").resolve() and p.exists()
                   for p in paths.values())
        assert mon.events == len(_build.SOURCES)
        assert mon.compile_seconds("compile") > 0
        _build.build_all()  # cached: nothing built, no event
        assert mon.events == len(_build.SOURCES)
        monkeypatch.setenv("FLUXMPI_TPU_COMPILE_CACHE", str(tmp_path / "env"))
        runtime._configure_compile_cache(None)
        assert _build.BUILD_DIR == (tmp_path / "env").resolve()
        with pytest.raises(ValueError, match="compile_cache spec"):
            runtime._configure_compile_cache(3.5)
    finally:
        _build.set_build_dir(None)
        ttel.compileplane.set_compile_monitor(None)
    assert _build.BUILD_DIR == default


# ---------------------------------------------------------------------------
# Serving: a mid-flight join costs no build
# ---------------------------------------------------------------------------


def test_midflight_join_zero_retrace():
    """Counterpart of the JAX package's ``test_midflight_join_zero_retrace``:
    after the warmup boundary a request admitted mid-flight (and another of
    another length in the same buckets) costs zero compile events; the
    engine's decode and prefill steps are eager callables, tracked
    untracked. Streams equal ``generate()``."""
    from fluxmpi_tpu_torch.models import generate
    from fluxmpi_tpu_torch.serving import InferenceEngine

    lm = TransformerLM(vocab_size=31, max_len=32, num_layers=1, d_model=16, num_heads=2,
                       d_ff=32, device="cpu", generator=torch.Generator().manual_seed(0))
    mon = ttel.compileplane.CompileMonitor(registry=ttel.MetricsRegistry())
    ttel.compileplane.set_compile_monitor(mon)
    try:
        eng = InferenceEngine(lm, slots=2, block_size=8)
        eng.warmup(prompt_lengths=(5, 9, 16))
        mon.observe_flush()  # warmup boundary
        rng = np.random.default_rng(1)
        eng.submit(rng.integers(1, 31, 9).tolist(), 8)
        for _ in range(3):
            eng.step()
        late = eng.submit(rng.integers(1, 31, 5).tolist(), 8)
        later = eng.submit(rng.integers(1, 31, 12).tolist(), 6)
        summary = eng.run()
        eng.close()
        assert summary["completed"] == 3
        info = mon.observe_flush()
        assert info["events"] == 0, f"steady-state builds: {info}"
        assert mon.retraces == []
        assert {n for n in mon._tracked} >= {"serving.decode_step", "serving.prefill_8",
                                            "serving.prefill_16"}
        assert set(mon._cache_sizes.values()) == {-1}
        ref = generate(lm, np.asarray([late.prompt]), 8)[0][5:]
        assert list(late.tokens) == ref.tolist()
        assert later.status == "finished"
    finally:
        ttel.compileplane.set_compile_monitor(None)


# ---------------------------------------------------------------------------
# The auto-profiler over torch.profiler
# ---------------------------------------------------------------------------


def _traces(path):
    return sorted(p for p in os.listdir(path) if p.endswith(".pt.trace.json"))


def test_auto_profiler_capture_budget_and_trace(tmp_path):
    ap = profiling.AutoProfiler(str(tmp_path), seconds=0.05, limit=1)
    prev = profiling.set_auto_profiler(ap)
    try:
        assert profiling.maybe_auto_capture("anomaly:step_time_regression") == str(tmp_path)
        ap.wait(30)
        assert profiling.maybe_auto_capture("again") is None  # the run's budget is spent
        assert ap.maybe_capture("signal", force=True) == str(tmp_path)  # a human asked
        ap.wait(30)
        ap.reset()
        assert ap.maybe_capture("next run") == str(tmp_path)
        ap.wait(30)
    finally:
        profiling.set_auto_profiler(prev)
    files = _traces(tmp_path)
    assert ap.captures == len(files) == 3
    trace = json.loads((tmp_path / files[0]).read_text())
    assert "traceEvents" in trace
    assert ap.last_trace_file == str(tmp_path / files[-1])
    assert not torch.autograd.profiler._is_profiler_enabled


def test_the_anomaly_rules_trigger_one_capture_per_run(tmp_path):
    ap = profiling.AutoProfiler(str(tmp_path), seconds=0.05)
    prev = profiling.set_auto_profiler(ap)
    det = ttel.AnomalyDetector(dump=False, registry=ttel.MetricsRegistry())
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            det.observe(retraces=1, retraced="train_loop.window", step=4)
            ap.wait(30)
            det.observe(retraces=1, retraced="train_loop.window", step=8)
            det.observe(grad_norm=float("nan"), step=12)  # not a profile trigger
        ap.wait(30)
    finally:
        profiling.set_auto_profiler(prev)
    assert ap.captures == 1 and ap.last_reason == "anomaly:steady_state_retrace"
    assert len(_traces(tmp_path)) == 1


def test_profile_trace_refuses_a_capture_and_stops_on_error(tmp_path, monkeypatch):
    with pytest.raises(ZeroDivisionError):
        with profiling.profile_trace(str(tmp_path / "a")):
            torch.ones(3).sum()
            1 / 0
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(_traces(tmp_path / "a")) == 1
    with pytest.warns(DeprecationWarning, match="host_only"):
        with profiling.profile_trace(str(tmp_path / "b"), host_only=True):
            pass
    assert len(_traces(tmp_path / "b")) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        with profiling.profile_trace(str(tmp_path / "c")):
            pass
    assert not torch.autograd.profiler._is_profiler_enabled


def test_configure_auto_profiler_forms_match(tmp_path, monkeypatch):
    from fluxmpi_tpu.utils import profiling as jprof

    for prof in (profiling, jprof):
        prev = prof.set_auto_profiler(None)
        try:
            _auto_profiler_forms(prof, tmp_path, monkeypatch)
        finally:
            prof.set_auto_profiler(prev)


def _auto_profiler_forms(prof, tmp_path, monkeypatch):
    """The configure forms of one package's auto-profiler, none armed."""
    assert prof.configure_auto_profiler() is None
    monkeypatch.setenv("FLUXMPI_TPU_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("FLUXMPI_TPU_PROFILE_SECONDS", "0.5")
    monkeypatch.setenv("FLUXMPI_TPU_PROFILE_LIMIT", "2")
    ap = prof.configure_auto_profiler()
    assert (ap.logdir, ap.seconds, ap.limit) == (str(tmp_path), 0.5, 2)
    assert prof.configure_auto_profiler(str(tmp_path)) is ap  # idempotent
    with pytest.raises(ValueError, match="profile spec"):
        prof.configure_auto_profiler(3)
    assert prof.configure_auto_profiler(False) is None
    assert prof.get_auto_profiler() is None
    for var in ("DIR", "SECONDS", "LIMIT"):
        monkeypatch.delenv(f"FLUXMPI_TPU_PROFILE_{var}")
