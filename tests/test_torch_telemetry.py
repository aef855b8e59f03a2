"""The port's telemetry planes (``fluxmpi_tpu_torch.telemetry``) against the
JAX package's, on the CPU.

- The schema: the port's copy equals ``fluxmpi_tpu/telemetry/schema.py``,
  every table and every validator.
- Registry, sinks, goodput (with a fake clock), the memory plane and the
  monitor: the JAX unit tests' scenarios, run through both packages where
  the API is the same; snapshots are equal once time fields are dropped.
- The instrumented layers of the port: the eager collectives (``comm.*``
  by op and path, the fully-off path reads no clock), the loader
  (``data.*``), the fault sites (``fault.injected``), the checkpoints
  (``checkpoint.*`` and the goodput checkpoint buckets),
  ``make_train_step(metrics=)`` and ``train_loop(metrics=)``.
- End to end: the tiny LM (2 layers, d 32, vocab 97, weights converted
  with ``load_flax_params``), f32, ``attention="flash"`` (the port's
  plain kernels; JAX's kernels in interpret mode), 8 updates,
  ``flush_every=4``, under ``init(telemetry=, trace=, goodput=True,
  memory=True)`` with a ``TrainingMonitor`` in each package, pipelined
  and fused: the same (name, labels) set, equal ``train.steps``,
  ``train.examples``, ``train.window.*`` and ``comm.calls``, loss and
  gradient norm within 1e-5 relative at every flush, the same span
  names, goodput buckets that sum to the wall time within 1%.
- Every file the port writes (JSONL, trace export, flight dump, watchdog
  dump, OOM bundle) passes ``scripts/check_metrics_schema.py`` as it
  stands, and ``scripts/goodput_report.py`` reads the port's stream.
- FLOPs per update of the tiny LM equal the JAX count (``jaxpr_dot_flops``
  of the step plus ``pallas_kernel_cost``) on the naive and the flash
  path. The one term that differs by construction is named:
  ``jaxpr_dot_flops`` also walks each ``pallas_call``'s body once (one
  block's products), which the port does not count.
- Off path: the planes off, the hot loop touches no tracker; the trained
  parameters are bit-identical with every plane on and off.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

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
from fluxmpi_tpu.utils import flops as jflops
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.models import MLP, TransformerLM, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.utils import CheckpointManager
from fluxmpi_tpu_torch.utils import flops as tflops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)
PACKAGES = {"jax": jtel, "port": ttel}


@pytest.fixture(scope="module")
def port_world():
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


@pytest.fixture(params=sorted(PACKAGES))
def tel(request):
    return PACKAGES[request.param]


@pytest.fixture()
def fresh_registry():
    """A fresh default registry in both packages, restored after."""
    regs = {name: mod.MetricsRegistry() for name, mod in PACKAGES.items()}
    prev = {name: PACKAGES[name].set_registry(reg) for name, reg in regs.items()}
    yield regs
    for name, reg in prev.items():
        PACKAGES[name].set_registry(reg)


def _run_checker(*paths):
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
         *map(str, paths)], capture_output=True, text=True, timeout=120)


def _timeless(snapshot):
    """Metric objects without their timing statistics, sorted."""
    out = []
    for m in snapshot:
        m = {k: v for k, v in m.items()
             if k not in ("sum", "min", "max", "mean", "last", "buckets")}
        out.append(json.dumps(m, sort_keys=True))
    return sorted(out)


# ---------------------------------------------------------------------------
# The schema: the port's own copy, equal to the JAX package's.
# ---------------------------------------------------------------------------

_JSCHEMA = importlib.import_module("fluxmpi_tpu.telemetry.schema")
_TSCHEMA = importlib.import_module("fluxmpi_tpu_torch.telemetry.schema")
_TABLES = sorted(n for n in vars(_JSCHEMA) if n.isupper() and not n.startswith("_"))
_FUNCS = sorted(n for n, v in vars(_JSCHEMA).items()
                if inspect.isfunction(v) and v.__module__ == _JSCHEMA.__name__)


def test_schema_copy_covers_every_table_and_validator():
    assert {"SCHEMA", "TRACE_SCHEMA", "KNOWN_METRIC_NAMES",
            "HISTOGRAM_BUCKET_EDGES", "PREEMPTION_EVENT"} <= set(_TABLES)
    assert {"validate_record", "validate_trace_file", "validate_watchdog_dump",
            "validate_flight_dump", "_validate_oom_section"} <= set(_FUNCS)
    assert set(_TABLES) == {n for n in vars(_TSCHEMA)
                            if n.isupper() and not n.startswith("_")}


@pytest.mark.parametrize("name", _TABLES)
def test_schema_table_equals_the_jax_copy(name):
    assert getattr(_TSCHEMA, name) == getattr(_JSCHEMA, name)


@pytest.mark.parametrize("name", _FUNCS)
def test_schema_validator_equals_the_jax_copy(name):
    assert inspect.getsource(getattr(_TSCHEMA, name)) == inspect.getsource(
        getattr(_JSCHEMA, name))


# ---------------------------------------------------------------------------
# Registry and sinks, through both packages.
# ---------------------------------------------------------------------------


def _registry_scenario(tel):
    reg = tel.MetricsRegistry()
    c = reg.counter("comm.calls", op="allreduce", path="device")
    c.inc()
    c.inc(2)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("train.loss")
    g.set(3.5)
    g.inc()
    g.dec(0.5)
    h = reg.histogram("train.step_seconds")
    for v in (0.002, 0.03, 0.7, 20.0):
        h.observe(v)
    reg.histogram("comm.block_seconds", op="barrier", path="host")
    assert reg.counter("comm.calls", op="allreduce", path="device") is c
    assert reg.counter("comm.calls", op="bcast", path="device") is not c
    with pytest.raises(ValueError):
        reg.gauge("comm.calls", op="x")
    with pytest.raises(ValueError):
        reg.counter("")
    return reg


def test_registry_semantics(tel):
    reg = _registry_scenario(tel)
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in reg.snapshot()}
    assert snap[("comm.calls", (("op", "allreduce"), ("path", "device")))]["value"] == 3
    assert snap[("train.loss", ())]["value"] == 4.0
    hist = snap[("train.step_seconds", ())]
    assert (hist["count"], hist["min"], hist["max"], hist["last"]) == (4, 0.002, 20.0, 20.0)
    counts = hist["buckets"]["counts"]  # cumulative, schema-declared edges
    assert counts == sorted(counts) and counts[-1] <= 4 and counts[0] == 0
    assert snap[("comm.block_seconds", (("op", "barrier"), ("path", "host")))]["count"] == 0
    for m in reg.snapshot():
        assert tel.validate_metric(m) == []
    reg.reset()
    assert reg.snapshot() == [] and reg.version == 1


def test_registry_snapshots_equal_across_packages():
    j, t = _registry_scenario(jtel), _registry_scenario(ttel)
    assert json.dumps(j.snapshot(), sort_keys=True) == json.dumps(t.snapshot(),
                                                                  sort_keys=True)
    rj, rt = j.flush(), t.flush()
    assert ttel.validate_record(rt) == []
    for rec in (rj, rt):
        rec.pop("time_unix")
    assert rj == rt


def test_jsonl_sink_writes_one_synced_line_per_flush(tel, tmp_path, monkeypatch):
    path = tmp_path / "m.jsonl"
    synced = []
    if tel is ttel:
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd), real(fd)))
    sink = tel.JSONLSink(str(path))
    assert not path.exists()  # opened lazily
    reg = tel.MetricsRegistry([sink])
    reg.counter("train.steps").inc(4)
    reg.flush()
    reg.flush(extra=1)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 2 and lines[1]["extra"] == 1
    assert all(tel.validate_record(x) == [] for x in lines)
    if tel is ttel:
        assert len(synced) == 2  # through to the disk per flush
    reg.close(flush=False)
    assert reg.sinks == () and len(path.read_text().splitlines()) == 2


def test_memory_null_console_sinks_and_close(tel, capsys):
    mem, null = tel.MemorySink(), tel.NullSink()
    reg = tel.MetricsRegistry([mem, null, tel.ConsoleSink()])
    reg.gauge("train.loss").set(1.25)
    reg.histogram("train.step_seconds").observe(0.5)
    reg.flush()
    assert len(mem.records) == 1
    assert "train.loss=1.25" in capsys.readouterr().out
    reg.close()
    assert len(mem.records) == 2 and reg.sinks == ()


def test_configure_forms_and_idempotence(tel, tmp_path, fresh_registry, monkeypatch):
    reg = tel.configure(str(tmp_path / "a.jsonl"))
    tel.configure(str(tmp_path / "a.jsonl"))
    tel.configure("console")
    tel.configure(True)
    assert [type(s).__name__ for s in reg.sinks] == ["JSONLSink", "ConsoleSink"]
    monkeypatch.setenv("FLUXMPI_TPU_TELEMETRY", str(tmp_path / "b.jsonl"))
    tel.configure()
    assert len(reg.sinks) == 3
    other = tel.MetricsRegistry()
    assert tel.configure(other) is other and tel.get_registry() is other
    with pytest.raises(ValueError):
        tel.configure(3.5)
    reg.close(flush=False)


# ---------------------------------------------------------------------------
# The instrumented collectives, loader, fault sites and checkpoints.
# ---------------------------------------------------------------------------


def _comm_rows(reg, name="comm.calls"):
    return {(m["labels"]["op"], m["labels"]["path"]): m.get("value", m.get("count"))
            for m in reg.snapshot() if m["name"] == name}


def test_every_eager_collective_records_calls_bytes_and_time(port_world, fresh_registry):
    reg = fresh_registry["port"]
    x = {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.float64)}
    tfm.allreduce(x)
    tfm.bcast(x)
    tfm.reduce(x, op="max")
    tfm.barrier()
    tfm.host_allreduce(np.ones(4, np.float32))
    tfm.host_allgather(np.ones(4, np.float32))
    tfm.host_bcast(np.ones(4, np.float32))
    _, req = tfm.iallreduce(x)
    assert ("allreduce", "device") in _comm_rows(reg)  # begun, not recorded
    assert _comm_rows(reg)[("allreduce", "device")] == 1
    req.wait()
    _, req = tfm.ibcast(torch.ones(5))
    req.wait()
    req.wait()  # a second wait records nothing
    assert _comm_rows(reg) == {
        ("allreduce", "device"): 2, ("bcast", "device"): 2, ("reduce", "device"): 1,
        ("barrier", "host"): 1, ("host_allreduce", "host"): 1,
        ("host_allgather", "host"): 1, ("host_bcast", "host"): 1}
    nbytes = _comm_rows(reg, "comm.bytes")
    assert nbytes[("allreduce", "device")] == 2 * (3 * 4 + 2 * 8)
    assert nbytes[("bcast", "device")] == 28 + 20 and nbytes[("barrier", "host")] == 0
    assert _comm_rows(reg, "comm.block_seconds")[("host_bcast", "host")] == 1
    assert all(ttel.validate_metric(m) == [] for m in reg.snapshot())


def test_collective_handles_follow_registry_swap_and_reset(port_world):
    fresh = ttel.MetricsRegistry()
    prev = ttel.set_registry(fresh)
    try:
        tfm.allreduce(torch.ones(2))
        assert fresh.counter("comm.calls", op="allreduce", path="device").value == 1
        fresh.reset()
        tfm.allreduce(torch.ones(2))
        assert fresh.counter("comm.calls", op="allreduce", path="device").value == 1
    finally:
        ttel.set_registry(prev)
    before = prev.counter("comm.calls", op="allreduce", path="device").value
    tfm.allreduce(torch.ones(2))
    assert prev.counter("comm.calls", op="allreduce", path="device").value == before + 1


def test_collective_fully_off_does_no_instrumentation_work(port_world, monkeypatch):
    """With the registry, the flight recorder and the tracer off, a
    collective reads no clock, looks up no instrument and appends no
    flight entry; the train step's own all-reduce never records."""
    from fluxmpi_tpu_torch import comm

    reg, rec = ttel.get_registry(), ttel.get_flight_recorder()
    assert not ttel.trace_enabled()

    def boom(*a, **k):
        raise AssertionError("instrumentation touched on the fully-off path")

    seq0 = rec.sequence
    monkeypatch.setattr(reg, "enabled", False)
    monkeypatch.setattr(rec, "enabled", False)
    monkeypatch.setattr(comm.time, "perf_counter", boom)
    monkeypatch.setattr(type(reg), "_get", boom)
    out = tfm.allreduce({"a": torch.ones(4)})
    tfm.barrier()
    tfm.host_allgather(np.ones(2))
    _, req = tfm.iallreduce(torch.ones(3))
    req.wait()
    assert torch.equal(out["a"], torch.ones(4)) and rec.sequence == seq0
    monkeypatch.undo()
    # The step's gradient all-reduce is not an eager collective.
    seq1 = rec.sequence
    model = MLP(features=(4, 1), device="cpu")
    opt = optim.sgd(0.1)
    step = make_train_step(lambda p, s, b: (model(b).pow(2).mean(), s), opt)
    step(TrainState.create(model, opt), torch.ones(2, 1))
    assert rec.sequence == seq1


def test_flight_recorder_disabled_records_nothing(port_world, fresh_registry):
    rec = ttel.get_flight_recorder()
    rec.enabled = False
    try:
        seq0 = rec.sequence
        tfm.allreduce(torch.ones(2))
        assert rec.sequence == seq0
        assert _comm_rows(fresh_registry["port"])[("allreduce", "device")] == 1
    finally:
        rec.enabled = True
    tfm.allreduce(torch.ones(2))
    assert rec.sequence == seq0 + 1


def _loader(n=64, gbs=8, **kw):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    return tfm.DistributedDataLoader(tfm.ArrayDataset((x, x[:, :1])), gbs,
                                     device="cpu", **kw)


@pytest.mark.parametrize("device_gather", [True, False])
def test_loader_records_fetch_latency_depth_and_ticks(port_world, fresh_registry,
                                                      device_gather):
    reg = fresh_registry["port"]
    p0 = ttel.watchdog.progress_value()
    assert len(list(_loader(device_gather=device_gather, prefetch=2))) == 8
    hist = reg.histogram("data.batch_fetch_seconds")
    assert hist.count == 8 and hist.min >= 0
    assert reg.gauge("data.prefetch_depth").value == 0  # the drained queue
    assert ttel.watchdog.progress_value() >= p0 + 8


def test_loader_skips_fetch_timing_when_telemetry_off(port_world, monkeypatch):
    from fluxmpi_tpu_torch import data

    reg = ttel.get_registry()
    hist = reg.histogram("data.batch_fetch_seconds")
    n0, p0 = hist.count, ttel.watchdog.progress_value()

    def boom(*a, **k):
        raise AssertionError("clock read on the fully-off data path")

    monkeypatch.setattr(reg, "enabled", False)
    monkeypatch.setattr(data.time, "perf_counter", boom)
    assert len(list(_loader())) == 8
    monkeypatch.undo()
    assert hist.count == n0 and ttel.watchdog.progress_value() >= p0 + 8
    list(_loader())
    assert hist.count == n0 + 8


def test_fault_injections_are_counted_by_site(port_world, fresh_registry):
    ttel.tracing.configure(True)
    try:
        with faults.scope("data.fetch@step=3:delay=0.01"):
            list(_loader())
        with faults.scope("comm.barrier"):
            with pytest.raises(tfm.FaultInjectedError):
                tfm.barrier()
        events = ttel.get_tracer().export()["traceEvents"]
    finally:
        ttel.tracing.reset()
    reg = fresh_registry["port"]
    assert reg.counter("fault.injected", site="data.fetch").value == 1
    assert reg.counter("fault.injected", site="comm.barrier").value == 1
    sites = [e["args"]["site"] for e in events if e["name"] == "fault.injected"]
    assert sites == ["data.fetch", "comm.barrier"]


def test_checkpoint_counters_and_goodput_buckets(port_world, fresh_registry, tmp_path,
                                                 monkeypatch):
    from fluxmpi_tpu_torch.utils import checkpoint as tckpt

    monkeypatch.setattr(tckpt, "_retry_sleep", lambda s: None)
    tracker = ttel.GoodputTracker()
    prev = ttel.goodput.set_goodput_tracker(tracker)
    try:
        state = {"w": torch.arange(4.0)}
        with faults.scope("ckpt.write:times=2"):
            tckpt.save_checkpoint(str(tmp_path / "a"), state)
        tckpt.restore_checkpoint(str(tmp_path / "a"), state)
        mgr = CheckpointManager(str(tmp_path / "m"), async_save=True)
        for s in (1, 2, 3):
            mgr.save(s, state)
        mgr.wait_until_finished()
        mgr.close()
    finally:
        ttel.goodput.set_goodput_tracker(prev)
    reg = fresh_registry["port"]
    assert reg.counter("checkpoint.retries").value == 2
    assert reg.counter("checkpoint.async_saves").value == 3
    rep = tracker.report()
    assert rep["buckets"]["checkpoint_save"] > 0
    assert rep["buckets"]["checkpoint_restore"] > 0
    assert rep["background"]["checkpoint_async_write"] > 0
    assert all(ttel.validate_metric(m) == [] for m in reg.snapshot())


# ---------------------------------------------------------------------------
# make_train_step(metrics=)
# ---------------------------------------------------------------------------


def _mlp_step(**kw):
    torch.manual_seed(0)
    model = MLP(features=(8, 1), device="cpu")
    opt = optim.adam(1e-2)
    x = torch.linspace(-1, 1, 16).reshape(16, 1)

    def loss_fn(p, ms, b):
        bx, by = b
        return ((torch.func.functional_call(model, p, (bx,)) - by) ** 2).mean(), ms

    return model, opt, make_train_step(loss_fn, opt, **kw), (x, x ** 2)


def test_train_step_metrics_registry_hook_and_monitor(port_world, fresh_registry):
    reg = fresh_registry["port"]
    model, opt, step, batch = _mlp_step(metrics=True)
    state = TrainState.create(model, opt)
    ttel.tracing.configure(True)
    p0 = ttel.watchdog.progress_value()
    try:
        for _ in range(3):
            state, loss = step(state, batch)
        names = {e["name"] for e in ttel.get_tracer().export()["traceEvents"]}
    finally:
        ttel.tracing.reset()
    assert "train.step" in names and ttel.watchdog.progress_value() == p0 + 3
    assert loss.ndim == 0 and reg.counter("train.steps").value == 3
    assert reg.counter("train.examples").value == 48
    assert reg.histogram("train.step_seconds").count == 3
    assert reg.gauge("train.loss").value == pytest.approx(float(loss))
    # The grad norm is optax.global_norm of the gradients the update used.
    records = []
    model, opt, step, batch = _mlp_step(metrics=records.append)
    state = TrainState.create(model, opt)
    grads = torch.autograd.grad(((model(batch[0]) - batch[1]) ** 2).mean(),
                                list(model.parameters()))
    want = float(optax.global_norm([g.numpy() for g in grads]))
    step(state, batch)
    assert records[0]["grad_norm"] == pytest.approx(want, rel=1e-6)
    assert set(records[0]) == {"step_seconds", "loss", "grad_norm", "examples",
                               "examples_per_sec", "steps"}
    mon = ttel.TrainingMonitor(registry=reg, interval=2)
    model, opt, step, batch = _mlp_step(metrics=mon, scan_steps=2)
    state = TrainState.create(model, opt)
    stacked = tuple(torch.stack([t, t]) for t in batch)
    for _ in range(2):
        state, losses = step(state, stacked)
    assert losses.shape == (2,) and reg.counter("monitor.heartbeat").value == 1
    with pytest.raises(ValueError, match="metrics must be"):
        make_train_step(lambda p, s, b: (None, s), opt, metrics=42)


def test_instrumented_step_is_bit_identical_to_the_plain_one(port_world):
    results = []
    for metrics in (None, True):
        model, opt, step, batch = _mlp_step(metrics=metrics)
        state = TrainState.create(model, opt)
        for _ in range(3):
            state, _ = step(state, batch)
        results.append({k: v.clone() for k, v in state.params.items()})
    for k in results[0]:
        assert torch.equal(results[0][k], results[1][k]), k


# ---------------------------------------------------------------------------
# End to end against the JAX package.
# ---------------------------------------------------------------------------


def _corpus(n=64, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 97, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % 97)
    return np.concatenate(seqs, axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def lm_params():
    jlm = JaxLM(**CFG, attention="flash")
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False)
    return jlm, jax.tree_util.tree_map(np.asarray, params)


def _jax_run(lm_params, out, fuse):
    jlm, params = lm_params
    corpus = _corpus()
    prev = jtel.set_registry(jtel.MetricsRegistry())
    jfm.init(telemetry=str(out / "jax.jsonl"), trace=str(out / "jax_trace.json"),
             goodput=True, memory=True)
    try:
        loader = jfm.DistributedDataLoader(
            jfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            shuffle=True)

        def loss_fn(p, ms, b):
            x, y = b
            return jlm.apply(p, x, train=False, targets=y, loss_chunk=64).mean(), ms

        opt = optax.adamw(1e-3)
        step = jax_make_train_step(loss_fn, opt, metrics=jtel.TrainingMonitor(interval=1))
        _, summary = jax_train_loop(step, replicate(JaxTrainState.create(params, opt)),
                                    loader, steps=8, flush_every=4, fuse=fuse)
        jfm.allreduce(np.ones((jfm.total_workers(), 2), np.float32))
        jfm.barrier()
        jfm.host_allgather(np.ones(2))
    finally:
        jtel.shutdown()
        jtel.set_registry(prev)
    return summary


def _port_lm(params):
    tlm = TransformerLM(**CFG, attention="flash", device="cpu")
    load_flax_params(tlm, params)

    def loss_fn(p, ms, b):
        x, y = b
        return tlm(x, targets=y, loss_chunk=64).mean(), ms

    return tlm, loss_fn


def _port_run(lm_params, out, fuse, *, planes=True, metrics=True):
    _, params = lm_params
    corpus = _corpus()
    prev = ttel.set_registry(ttel.MetricsRegistry())
    if planes:
        tfm.init(telemetry=str(out / "port.jsonl"), trace=str(out / "port_trace.json"),
                 goodput=True, memory=True)
    try:
        loader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            shuffle=True, device="cpu")
        tlm, loss_fn = _port_lm(params)
        opt = optim.adamw(1e-3)
        spec = ttel.TrainingMonitor(interval=1) if metrics else None
        step = make_train_step(loss_fn, opt, metrics=spec)
        state, summary = train_loop(step, TrainState.create(tlm, opt), loader, steps=8,
                                    flush_every=4, fuse=fuse)
        if planes:
            tfm.allreduce(torch.ones(2))
            tfm.barrier()
            tfm.host_allgather(np.ones(2))
    finally:
        ttel.shutdown()
        ttel.set_registry(prev)
    return state, summary


def _keys(records):
    return {(m["name"], tuple(sorted(m["labels"].items())))
            for r in records for m in r["metrics"]}


def _value(record, name, **labels):
    for m in record["metrics"]:
        if m["name"] == name and m["labels"] == labels:
            return m.get("value", m.get("count"))
    return None


@pytest.mark.parametrize("fuse", [False, "window"])
def test_end_to_end_stream_matches_the_jax_package(world, port_world, lm_params,
                                                   tmp_path, fuse):
    jsum = _jax_run(lm_params, tmp_path, fuse)
    _, tsum = _port_run(lm_params, tmp_path, fuse)
    for key in ("updates", "dispatches", "fused_window", "examples"):
        assert tsum[key] == jsum[key], key
    load = lambda p: [json.loads(x) for x in (tmp_path / p).read_text().splitlines()]
    J, T = load("jax.jsonl"), load("port.jsonl")
    assert len(J) == len(T) == 3  # two flushes and the shutdown line
    assert _keys(J) == _keys(T)
    for a, b in zip(J, T):
        for name in ("train.steps", "train.examples", "train.window.size",
                     "train.window.dispatches", "goodput.updates"):
            assert _value(a, name) == _value(b, name), name
        for name in ("train.loss", "train.grad_norm"):
            np.testing.assert_allclose(_value(b, name), _value(a, name), rtol=1e-5,
                                       err_msg=name)
        for op, path in (("allreduce", "device"), ("barrier", "host"),
                         ("host_allgather", "host")):
            assert _value(a, "comm.calls", op=op, path=path) == _value(
                b, "comm.calls", op=op, path=path)
    assert _value(T[-1], "comm.calls", op="barrier", path="host") == 1
    assert _value(T[-1], "train.steps") == 8
    spans = [{e["name"] for e in json.loads((tmp_path / f).read_text())["traceEvents"]
              if e["ph"] != "M"} for f in ("jax_trace.json", "port_trace.json")]
    assert spans[0] == spans[1] and "comm.barrier" in spans[1]
    rep = tsum["goodput"]
    assert set(rep["buckets"]) == set(jsum["goodput"]["buckets"])
    assert sum(rep["buckets"].values()) == pytest.approx(rep["wall_seconds"], rel=0.01)
    assert rep["updates"] == 8 and rep["flops_per_update"] > 0
    assert rep["mfu"] is None  # the CPU has no peak in the table
    out = _run_checker(tmp_path / "port.jsonl", tmp_path / "port_trace.json")
    assert out.returncode == 0, out.stdout + out.stderr
    report = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "goodput_report.py"),
         str(tmp_path / "port.jsonl"), "--json"],
        capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    assert json.loads(report.stdout)["hosts"]


def test_training_is_bit_identical_with_every_plane_on_and_off(port_world, lm_params,
                                                               tmp_path):
    on, _ = _port_run(lm_params, tmp_path, "window")
    off, summary = _port_run(lm_params, tmp_path, "window", planes=False,
                             metrics=False)
    assert "goodput" not in summary
    for name in on.params:
        assert torch.equal(on.params[name], off.params[name]), name
        assert torch.equal(on.opt_state["mu"][name], off.opt_state["mu"][name]), name


def test_goodput_books_a_window_programs_build_once_and_keeps_its_flops(
        port_world, lm_params):
    """The fused path: a window program's eager first call is compile work
    and its FLOPs are counted there; a later run reusing the cached
    program books its windows as steps and still reports the FLOPs."""
    _, params = lm_params
    corpus = _corpus()
    loader = tfm.DistributedDataLoader(
        tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), 8, device="cpu")
    tlm, loss_fn = _port_lm(params)
    opt = optim.adamw(1e-3)
    step = make_train_step(loss_fn, opt)
    state = TrainState.create(tlm, opt)
    tracker = ttel.GoodputTracker()
    prev = ttel.goodput.set_goodput_tracker(tracker)
    try:
        reports = []
        for _ in range(2):
            state, summary = train_loop(step, state, loader, steps=8, flush_every=4,
                                        fuse="window")
            reports.append(summary["goodput"])
    finally:
        ttel.goodput.set_goodput_tracker(prev)
    (program,) = step.__fluxmpi_window_cache__.values()
    assert program.flops > 0
    assert reports[0]["flops_per_update"] == reports[1]["flops_per_update"] == \
        program.flops / 4
    assert reports[0]["buckets"]["compile"] > 0
    assert "compile" not in reports[1]["buckets"] and reports[1]["updates"] == 8


def test_train_loop_fully_off_plane_costs_nothing(port_world, lm_params):
    """With goodput off (the default), the hot loop performs no tracker
    clock reads, segments, bucket adds, update counts or records."""
    tracker = ttel.get_goodput_tracker()
    assert not tracker.enabled

    def boom(*a, **k):
        raise AssertionError("goodput plane touched on the off path")

    saved = {k: getattr(tracker, k) for k in ("_clock", "segment", "add",
                                              "note_updates", "record")}
    for k in saved:
        setattr(tracker, k, boom)
    try:
        for fuse in (False, "window"):
            _, params = lm_params
            corpus = _corpus()
            loader = tfm.DistributedDataLoader(
                tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), 8, device="cpu")
            tlm, loss_fn = _port_lm(params)
            opt = optim.adamw(1e-3)
            _, summary = train_loop(make_train_step(loss_fn, opt),
                                    TrainState.create(tlm, opt), loader, steps=4,
                                    flush_every=2, fuse=fuse)
            assert summary["updates"] == 4 and "goodput" not in summary
    finally:
        for k, v in saved.items():
            setattr(tracker, k, v)


# ---------------------------------------------------------------------------
# FLOPs and MFU
# ---------------------------------------------------------------------------


def _pallas_bodies(closed):
    """``jaxpr_dot_flops`` of each pallas_call body, once per call: the
    term the JAX count adds by walking the kernel bodies as sub-jaxprs."""
    total = 0.0

    def find(jx):
        nonlocal total
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                total += jflops.jaxpr_dot_flops(eqn.params["jaxpr"])
        for _, sub in jflops._iter_subjaxprs(jx):
            find(sub)

    find(closed.jaxpr)
    return total


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_flops_per_update_match_the_jax_count(world, port_world, attention):
    jlm = JaxLM(**CFG, attention=attention)
    params = jax.tree_util.tree_map(np.asarray, jlm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False))
    corpus = _corpus(n=8)
    x, y = corpus[:, :-1], corpus[:, 1:]

    def jloss(p, ms, b):
        return jlm.apply(p, b[0], train=False, targets=b[1], loss_chunk=64).mean(), ms

    jopt = optax.adamw(1e-3)
    closed = jax.make_jaxpr(jax_make_train_step(jloss, jopt))(
        replicate(JaxTrainState.create(params, jopt)), (jnp.asarray(x), jnp.asarray(y)))
    kernels = jflops.pallas_kernel_cost(closed)
    jax_total = jflops.jaxpr_dot_flops(closed.jaxpr) + (kernels["flops"] if kernels else 0)
    bodies = _pallas_bodies(closed)
    tlm = TransformerLM(**CFG, attention=attention, device="cpu")
    load_flax_params(tlm, params)
    opt = optim.adamw(1e-3)
    step = make_train_step(lambda p, ms, b: (tlm(b[0], targets=b[1], loss_chunk=64)
                                             .mean(), ms), opt)
    with tflops.count_flops() as count:
        step(TrainState.create(tlm, opt), (torch.from_numpy(x), torch.from_numpy(y)))
    if attention == "naive":
        assert kernels is None and bodies == 0
        assert count.kernels == {}
    else:
        assert kernels["calls"] == 3 * CFG["num_layers"]
        assert sum(count.kernels.values()) == kernels["flops"]
        assert 0 < bodies < 0.01 * jax_total
    assert count.total == pytest.approx(jax_total - bodies, rel=1e-9)


def test_peak_table_mfu_and_kernel_flops_outside_a_count():
    assert tflops.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert tflops.chip_peak_flops("cpu") is None
    assert tflops.mfu(7e12, 10.0, 1, "NVIDIA H100 80GB HBM3") == round(
        7e13 / 989.4e12, 4)
    assert tflops.mfu(1e12, 1.0, 1, peak=2e12) == jflops.mfu(1e12, 1.0, 1, peak=2e12)
    assert tflops.mfu(None, 1.0, 1, peak=1.0) is None
    assert tflops.mfu(1.0, 1.0, 1, "cpu") is None
    with tflops.kernel_flops("flash_fwd", 1e9):  # no count open: nothing
        pass
    q = torch.zeros(2, 16, 4, 8)
    assert tflops.attention_flops(q, q) == {
        "flash_fwd": 4.0 * 2 * 4 * 16 * 16 * 8, "flash_bwd_dq": 6.0 * 2 * 4 * 16 * 16 * 8,
        "flash_bwd_dkv": 8.0 * 2 * 4 * 16 * 16 * 8}


# ---------------------------------------------------------------------------
# Goodput, through both packages (fake clock).
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _goodput_scenario(tel):
    clock = _Clock()
    tr = tel.GoodputTracker(clock=clock, peak_flops_per_chip=1e12, n_chips=1)
    tr.start_run()
    with tr.segment("compile"):
        clock.t += 2.0
    with tr.segment("step"):
        clock.t += 5.0
        with tr.segment("data_stall"):  # nested: the outer segment wins
            clock.t += 1.0
    tr.add("data_stall", 0.5)
    clock.t += 2.0
    tr.note_updates(10)
    tr.set_flops_per_update(1e11)
    reg = tel.MetricsRegistry()
    tr.record(reg)
    return tr, reg


def test_goodput_buckets_nesting_and_mfu(tel):
    tr, reg = _goodput_scenario(tel)
    rep = tr.report()
    assert rep["buckets"] == {"compile": 2.0, "step": 6.0, "data_stall": 0.5,
                              "host_idle": 1.5}
    assert rep["wall_seconds"] == 10.0 and rep["goodput_fraction"] == 0.6
    assert rep["mfu"] == 0.1 and rep["mfu_productive"] == round(1e12 / 6 / 1e12, 4)
    assert all(tel.validate_metric(m) == [] for m in reg.snapshot())
    assert tel.goodput.MEASURED_BUCKETS == jtel.goodput.MEASURED_BUCKETS
    assert tel.goodput.IDLE_BUCKET == "host_idle"


def test_goodput_records_equal_across_packages():
    (_, j), (_, t) = _goodput_scenario(jtel), _goodput_scenario(ttel)
    assert _timeless(j.snapshot()) == _timeless(t.snapshot())


def test_goodput_ignores_other_threads_and_disabled_reads_no_clock(tel):
    clock = _Clock()
    tr = tel.GoodputTracker(clock=clock)
    tr.start_run()

    def other():
        with tr.segment("checkpoint_save"):
            clock.t += 3.0
        tr.note_background("checkpoint_async_write", 3.0)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert tr.bucket_seconds("checkpoint_save") == 0.0
    assert tr.report()["background"] == {"checkpoint_async_write": 3.0}

    def boom():
        raise AssertionError("clock read while disabled")

    off = tel.GoodputTracker(clock=boom, enabled=False)
    with off.segment("step"):
        pass
    off.add("step", 1.0)
    assert off.report()["buckets"] == {"host_idle": 0.0}


def test_goodput_configure_env_and_shutdown(tel, monkeypatch):
    tracker = tel.get_goodput_tracker()
    assert not tracker.enabled
    try:
        monkeypatch.setenv("FLUXMPI_TPU_GOODPUT", "1")
        assert tel.goodput.configure().enabled
        tel.goodput.configure(False)
        assert not tracker.enabled
        custom = tel.GoodputTracker(enabled=False)
        assert tel.goodput.configure(custom) is custom and custom.enabled
        with pytest.raises(ValueError):
            tel.goodput.configure("maybe")
    finally:
        tel.goodput.set_goodput_tracker(tracker)
        tel.goodput.shutdown()
    assert not tracker.enabled and tracker.wall_seconds() == 0.0


def test_goodput_mfu_reads_the_card_name(monkeypatch):
    tr = ttel.GoodputTracker(clock=_Clock(), n_chips=1)
    tr.start_run()
    tr._clock.t += 10.0
    tr.note_updates(100)
    tr.set_flops_per_update(7e12)
    assert tr.report()["mfu"] is None  # no card here
    monkeypatch.setattr(tfm.runtime, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tr.report()["mfu"] == round(7e12 * 10 / 989.4e12, 4)


# ---------------------------------------------------------------------------
# The memory plane and the monitor.
# ---------------------------------------------------------------------------


def test_device_memory_stats_read_the_caching_allocator(monkeypatch):
    assert ttel.memory.device_memory_stats(torch.device("cpu")) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: {"allocated_bytes.all.current": 300, "other": 1})
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 900)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 1000)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (5000, 8000))
    stats = ttel.memory.device_memory_stats(torch.device("cuda", 0))
    assert stats == {"bytes_in_use": 300.0, "peak_bytes_in_use": 900.0,
                     "bytes_limit": 6000.0}
    assert set(stats) == set(jtel.memory.STATS_KEYS)


def test_record_hbm_gauges_and_watermark(monkeypatch):
    mem = ttel.memory
    peaks = iter([5.0, 9.0, 7.0])
    monkeypatch.setattr(mem, "_local_devices", lambda: [torch.device("cuda", 0)])
    monkeypatch.setattr(mem, "device_memory_stats", lambda d: {
        "bytes_in_use": 1.0, "peak_bytes_in_use": next(peaks), "bytes_limit": 10.0})
    mem.shutdown()
    reg = ttel.MetricsRegistry()
    snaps = [mem.record_hbm(reg) for _ in range(3)]
    assert [s["watermark_bytes"] for s in snaps] == [5.0, 9.0, 9.0]
    assert snaps[-1]["devices"] == {"0": {"bytes_in_use": 1.0, "peak_bytes_in_use": 7.0,
                                          "bytes_limit": 10.0}}
    assert reg.gauge("memory.peak_bytes_in_use", device="0").value == 7.0
    assert reg.gauge("memory.peak_watermark_bytes").value == 9.0
    assert all(ttel.validate_metric(m) == [] for m in reg.snapshot())
    assert mem.peak_watermark_bytes() == 9.0
    mem.shutdown()
    assert mem.peak_watermark_bytes() == 0.0


def test_census_lists_live_cuda_tensors_largest_first(monkeypatch):
    import gc

    objs = [torch.zeros(4), torch.zeros(3, 5), torch.zeros(7)]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(gc, "get_objects", lambda: objs + ["not a tensor"])
    out = ttel.memory.census(top_n=2)
    assert (out["count"], out["total_bytes"], out["top_n"]) == (3, 4 * 26, 2)
    assert [a["shape"] for a in out["arrays"]] == [[3, 5], [7]]
    assert out["arrays"][0] == {"nbytes": 60, "shape": [3, 5], "dtype": "float32",
                                "sharding": "cpu"}


def test_is_oom_error_and_configure_forms(monkeypatch):
    mem = ttel.memory
    assert mem.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert mem.is_oom_error(RuntimeError("NCCL: out of memory"))
    assert not mem.is_oom_error(ValueError("shape mismatch"))
    try:
        monkeypatch.setenv("FLUXMPI_TPU_MEMORY", "1")
        assert mem.configure() is True and mem.enabled()
        assert mem.configure(False) is False
        with pytest.raises(ValueError):
            mem.configure("sometimes")
    finally:
        mem.shutdown()


def test_monitor_collects_flags_stragglers_and_folds_planes(port_world):
    reg = ttel.MetricsRegistry([ttel.MemorySink()])
    clock = _Clock()
    mon = ttel.TrainingMonitor(registry=reg, interval=2, straggler_threshold=1.5,
                               clock=clock)
    assert mon.observe_step(0.1) is None
    summary = mon.observe_step(0.3)
    assert summary["step_seconds_local_mean"] == pytest.approx(0.2)
    assert summary["straggler"] is False and mon.progress == 1
    ttel.memory.configure(True)
    tracker = ttel.GoodputTracker(clock=_Clock())
    prev = ttel.goodput.set_goodput_tracker(tracker)
    try:
        tracker.start_run()
        clock.t += 5.0
        summary = mon.collect()
    finally:
        ttel.goodput.set_goodput_tracker(prev)
        ttel.memory.shutdown()
    names = {m["name"] for m in summary["record"]["metrics"]}
    assert {"monitor.heartbeat", "monitor.heartbeat_age_seconds",
            "host.memory.peak_rss_bytes", "memory.peak_watermark_bytes"} <= names
    assert reg.gauge("monitor.heartbeat_age_seconds").value == 5.0
    assert len(reg.sinks[0].records) == 2


# ---------------------------------------------------------------------------
# init's planes, and what is still refused.
# ---------------------------------------------------------------------------


def test_init_wires_the_planes_and_shutdown_tears_them_down(tmp_path, monkeypatch):
    from fluxmpi_tpu_torch.telemetry import goodput, memory, tracing, watchdog

    was_up = tfm.is_initialized()
    monkeypatch.setenv("FLUXMPI_TPU_WATCHDOG_DIR", str(tmp_path))
    monkeypatch.setenv("FLUXMPI_TPU_GOODPUT", "1")
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        tfm.init(device="cpu", telemetry=str(tmp_path / "m.jsonl"),
                 trace=str(tmp_path / "t.{process}.json"), watchdog=60, memory=True)
        assert goodput.get_goodput_tracker().enabled and memory.enabled()
        assert tracing.trace_enabled() and watchdog.get_watchdog().armed
        assert watchdog.get_watchdog().dump_dir == str(tmp_path)
        tfm.barrier()
        tfm.init(device="cpu", telemetry=str(tmp_path / "m.jsonl"))  # idempotent
        assert len(ttel.get_registry().sinks) == 1
        ttel.shutdown()
        assert watchdog.get_watchdog() is None and not tracing.trace_enabled()
        assert not goodput.get_goodput_tracker().enabled and not memory.enabled()
        assert ttel.get_registry().sinks == ()
        assert _run_checker(tmp_path / "m.jsonl", tmp_path / "t.0.json").returncode == 0
    finally:
        ttel.shutdown()
        ttel.set_registry(prev)
        if not was_up:
            tfm.shutdown()


@pytest.mark.parametrize("plane", ["anomaly", "model_stats", "compileplane", "profile",
                                   "export", "fleet", "serving", "request_log"])
def test_planes_not_ported_yet_still_raise(plane):
    was_up = tfm.is_initialized()
    with pytest.raises(NotImplementedError, match=plane) as info:
        tfm.init(device="cpu", **{plane: True})
    assert "telemetry/" not in str(info.value)
    assert tfm.is_initialized() == was_up
