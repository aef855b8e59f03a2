"""The port's trace plane (spans, the collective flight recorder, the hang
watchdog, the OOM bundle) against the JAX package's, on the CPU.

- Tracer, flight recorder, ``diff_dumps`` and the watchdog (with a fake
  clock): the scenarios of ``tests/test_tracing.py``, run through both
  packages; the records are equal once time fields are dropped.
- The port's instrumented layers on the timeline: ``train.step`` spans
  and watchdog ticks from an instrumented step, ``data.fetch`` events
  keyed by batch position, the ``train.preemption`` instant, every
  eager collective in the flight ring; ``step_timer`` and ``block_on``.
- Files: the trace export, a flight dump, a watchdog dump and an OOM
  bundle (``train_loop`` hit by a ``torch.cuda.OutOfMemoryError`` stand-in)
  pass ``scripts/check_metrics_schema.py`` as it stands;
  ``scripts/merge_traces.py`` merges the port's per-rank exports.
- A real stall: a ``data.fetch`` delay longer than the watchdog's
  deadline; the watchdog thread writes a dump that names the stalled
  stack while the training thread sleeps.
- Two and four gloo ranks (``FileStore``, one thread each): ``comm.*``
  per op and path in per-process JSONL files, the ``TrainingMonitor``'s
  straggler flag with one rank slowed by a ``data.fetch`` delay fault,
  and ``diff_dumps`` (the port's and the JAX package's) naming the
  collective one rank skipped.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.models import MLP
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.utils.profiling import block_on, step_timer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jtel, "port": ttel}
JOIN_TIMEOUT = 240


@pytest.fixture(scope="module")
def port_world():
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


@pytest.fixture(params=sorted(PACKAGES))
def tel(request):
    return PACKAGES[request.param]


def _run_checker(*paths):
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
         *map(str, paths)], capture_output=True, text=True, timeout=120)


def _drop_time(record):
    """A trace-plane record without its clock readings, host ids and the
    thread names they carry."""
    if isinstance(record, dict):
        return {k: _drop_time(v) for k, v in record.items()
                if k not in ("time_unix", "ts", "dur", "duration", "pid", "tid",
                             "thread_id", "args")}
    if isinstance(record, list):
        return [_drop_time(v) for v in record]
    return record


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


def test_span_nesting_and_export_round_trip(tel, tmp_path):
    tr = tel.Tracer(capacity=128, enabled=True)
    with tr.span("train.step", step=1):
        with tr.span("data.wait"):
            pass
        tr.instant("grad.ready", norm=1.5)
    record = tr.export(str(tmp_path / "trace.json"))
    assert tel.validate_trace_export(record) == []
    loaded = json.loads((tmp_path / "trace.json").read_text())
    assert loaded["schema"] == "fluxmpi_tpu.trace/v1" and loaded["kind"] == "trace"
    by_name = {e["name"]: e for e in loaded["traceEvents"] if e["ph"] != "M"}
    assert set(by_name) == {"train.step", "data.wait", "grad.ready"}
    parent, child = by_name["train.step"], by_name["data.wait"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 2.0
    assert parent["args"] == {"step": 1} and by_name["grad.ready"]["ph"] == "i"


def test_trace_exports_equal_across_packages():
    records = []
    for tel in (jtel, ttel):
        tr = tel.Tracer(capacity=8, enabled=True)
        with tr.span("train.step"):
            tr.instant("x", i=1)
        tr.add_complete_event("comm.allreduce", 1.0, 1.25, path="device", nbytes=64)
        tr.name_track(7, "request 7")
        tr.instant("tick", track=7)
        records.append(_drop_time(tr.export()))
    assert records[0] == records[1]


def test_tracer_ring_bounded_and_disabled_noop(tel):
    tr = tel.Tracer(capacity=8, enabled=True)
    for i in range(50):
        tr.instant("tick", i=i)
    ticks = [e for e in tr.export()["traceEvents"] if e["name"] == "tick"]
    assert [e["args"]["i"] for e in ticks] == list(range(42, 50))
    off = tel.Tracer(capacity=8, enabled=False)
    assert off.span("a") is off.span("b")
    with off.span("a"):
        off.instant("x")
        off.add_complete_event("y", 0.0, 1.0)
    assert len(off) == 0 and off.open_spans() == []


def test_open_spans_visible_while_active(tel):
    tr = tel.Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner"):
            stacks = tr.open_spans()
    assert stacks == [{"thread_id": threading.get_ident(), "spans": ["outer", "inner"]}]
    assert tr.open_spans() == []


def test_tracing_configure_specs_and_shutdown_export(tel, tmp_path, monkeypatch):
    tracing = tel.tracing
    try:
        assert tracing.configure(True).enabled
        tracing.configure(False)
        assert not tracing.trace_enabled()
        monkeypatch.setenv("FLUXMPI_TPU_TRACE", str(tmp_path / "t.{process}.json"))
        tracing.configure()
        tracing.instant("marker")
        assert tracing.shutdown() == str(tmp_path / "t.0.json")
        with pytest.raises(ValueError, match="not formattable"):
            tracing.configure(str(tmp_path / "{bad}.json"))
        custom = tel.Tracer()
        assert tracing.configure(custom) is custom and custom.enabled
    finally:
        tracing.set_tracer(tel.tracing.Tracer())
        tracing.reset()
    assert _run_checker(tmp_path / "t.0.json").returncode == 0


# ---------------------------------------------------------------------------
# Flight recorder and cross-rank diffs
# ---------------------------------------------------------------------------


def test_flight_ring_wraparound_hang_and_abort(tel):
    fr = tel.FlightRecorder(capacity=8)
    for _ in range(20):
        fr.complete(fr.begin("allreduce", "device", 128))
    fr.abort(fr.begin("reduce", "device", 8))
    fr.begin("bcast", "device", 256)  # never completes: the hang
    dump = fr.dump()
    assert tel.validate_flight_dump(dump) == []
    assert [e["seq"] for e in dump["entries"]] == list(range(15, 23))
    assert dump["entries"][-2]["aborted"] is True
    tail = dump["entries"][-1]
    assert (tail["op"], tail["completed"], tail["duration"]) == ("bcast", False, None)
    assert fr.completed_count == 20 and dump["sequence"] == 22


def test_flight_dumps_equal_across_packages():
    dumps = []
    for tel in (jtel, ttel):
        fr = tel.FlightRecorder(capacity=4)
        for op in ("allreduce", "bcast", "barrier"):
            fr.complete(fr.begin(op, "device", 64))
        fr.begin("host_allgather", "host", 16)
        dumps.append(_drop_time(fr.dump()))
    assert dumps[0] == dumps[1]


def _two_hosts(tel, ops0, ops1, hang=None):
    h0, h1 = tel.FlightRecorder(capacity=16), tel.FlightRecorder(capacity=16)
    for op in ops0:
        h0.complete(h0.begin(op, "device", 64))
    for op in ops1:
        h1.complete(h1.begin(op, "device", 64))
    if hang:
        h1.begin(hang, "device", 64)
    d0, d1 = h0.dump(), h1.dump()
    d1["process"] = 1
    return d0, d1


def test_diff_dumps_desync_divergence_and_healthy(tel):
    diff = tel.diff_flight_dumps(_two_hosts(tel, ["allreduce"] * 10, ["allreduce"] * 8,
                                            hang="allreduce"))
    assert (diff["max_sequence"], diff["min_sequence"], diff["laggards"]) == (10, 9, [1])
    assert diff["hosts"]["1"]["in_flight"]["seq"] == 9
    assert diff["first_mismatch"] is None and not diff["synchronized"]
    diff = tel.diff_flight_dumps(_two_hosts(tel, ["allreduce", "bcast", "allreduce"],
                                            ["allreduce", "bcast", "reduce"]))
    assert diff["first_mismatch"]["seq"] == 3
    assert diff["first_mismatch"]["entries"]["1"]["op"] == "reduce"
    assert tel.diff_flight_dumps(_two_hosts(tel, ["barrier"] * 3,
                                            ["barrier"] * 3))["synchronized"]
    d0, d1 = _two_hosts(tel, ["barrier"], ["barrier"])
    d1["process"] = 0
    with pytest.raises(ValueError, match="share process index"):
        tel.diff_flight_dumps([d0, d1])


def test_comm_collectives_feed_the_flight_recorder(port_world):
    fr = ttel.get_flight_recorder()
    seq0, done0 = fr.sequence, fr.completed_count
    tfm.allreduce(torch.ones(2))
    tfm.bcast(torch.ones(2))
    tfm.host_allgather(np.float32(1.0))
    _, req = tfm.ibcast(torch.ones(3))
    assert fr.entries()[-1].op == "bcast" and not fr.entries()[-1].completed
    req.wait()
    assert fr.sequence == seq0 + 4 and fr.completed_count == done0 + 4
    assert [e.op for e in fr.entries()[-4:]] == ["allreduce", "bcast",
                                                 "host_allgather", "bcast"]
    assert fr.entries()[-2].path == "host" and fr.entries()[-1].completed
    with faults.scope("comm.allreduce"):
        with pytest.raises(tfm.FaultInjectedError):
            tfm.allreduce(torch.ones(2))
    assert fr.sequence == seq0 + 4  # the fault fires before the launch
    with pytest.raises(tfm.CollectiveError):
        tfm.allreduce({"bad": object()})
    tail = fr.dump()["entries"][-1]
    assert tail["completed"] and tail.get("aborted")  # raised: not a hang


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


def _fake_watchdog(tel, tmp_path):
    clock, progress = {"t": 0.0}, {"n": 0}
    wd = tel.Watchdog(deadline=30.0, dump_dir=str(tmp_path),
                      sources=[lambda: progress["n"]], clock=lambda: clock["t"])
    return wd, clock, progress


def test_watchdog_dumps_once_per_stall_plateau(tel, tmp_path):
    reg = tel.MetricsRegistry([tel.MemorySink()])
    reg.counter("train.steps").inc(7)
    tr = tel.Tracer(enabled=True)
    fr = tel.FlightRecorder(capacity=8)
    fr.complete(fr.begin("allreduce", "device", 4096))
    fr.begin("bcast", "device", 128)
    wd, clock, progress = _fake_watchdog(tel, tmp_path)
    wd._registry, wd._tracer, wd._recorder = reg, tr, fr
    with tr.span("train.step"):
        assert wd.check() is None
        clock["t"], progress["n"] = 10.0, 1
        assert wd.check() is None
        clock["t"] = 35.0
        assert wd.check() is None
        clock["t"] = 41.0
        path = wd.check()
        assert path is not None and wd.check() is None
    dump = json.loads(Path(path).read_text())
    assert tel.validate_watchdog_dump(dump) == []
    assert dump["reason"] == "stall" and dump["open_spans"][0]["spans"] == ["train.step"]
    assert dump["flight_recorder"]["entries"][-1]["op"] == "bcast"
    assert any(fr["function"] == "test_watchdog_dumps_once_per_stall_plateau"
               for t in dump["threads"] for fr in t["stack"])
    progress["n"] = 2
    clock["t"] = 50.0
    assert wd.check() is None
    clock["t"] = 81.0
    assert wd.check() is not None  # a new plateau dumps again
    assert _run_checker(path).returncode == 0


def test_watchdog_signal_arm_and_configure(tel, tmp_path, monkeypatch):
    wd = tel.Watchdog(deadline=3600.0, poll_interval=0.05, dump_dir=str(tmp_path))
    tel.arm_watchdog(wd)
    try:
        assert tel.get_watchdog() is wd and wd.armed
        os.kill(os.getpid(), __import__("signal").SIGUSR1)
        for _ in range(100):
            if wd.last_dump_path:
                break
            time.sleep(0.05)
        assert json.loads(Path(wd.last_dump_path).read_text())["reason"] == "signal"
    finally:
        tel.disarm_watchdog()
    assert tel.get_watchdog() is None and not wd.armed
    watchdog = tel.watchdog
    monkeypatch.setenv("FLUXMPI_TPU_WATCHDOG_DIR", str(tmp_path))
    try:
        armed = watchdog.configure(120)
        assert armed.deadline == 120.0 and armed.dump_dir == str(tmp_path)
        assert watchdog.configure("120") is armed  # idempotent replay
        assert watchdog.configure(True).deadline == 300.0
        assert watchdog.configure("0") is None and tel.get_watchdog() is None
        with pytest.raises(ValueError):
            watchdog.configure("soon")
    finally:
        tel.disarm_watchdog()
    n0 = watchdog.progress_value()
    tel.notify_progress(3)
    assert watchdog.progress_value() == n0 + 3


def test_watchdog_dumps_equal_across_packages(tmp_path):
    records = []
    for tel in (jtel, ttel):
        fr = tel.FlightRecorder(capacity=4)
        fr.begin("barrier", "host", 0)
        wd = tel.Watchdog(deadline=5.0, registry=tel.MetricsRegistry(),
                          tracer=tel.Tracer(enabled=True), recorder=fr)
        rec = wd.build_dump("manual")
        rec.pop("threads")
        records.append(_drop_time(rec))
    assert records[0] == records[1]


def test_watchdog_fires_while_the_training_thread_sleeps_in_a_fetch(port_world, tmp_path):
    """A real stall: every batch after the second is delayed past the
    deadline; the watchdog thread writes its dump during the sleep, and
    the dump names the stalled stack."""
    torch.manual_seed(0)
    model = MLP(features=(4, 1), device="cpu")
    opt = optim.sgd(0.1)
    x = np.linspace(-1, 1, 32, dtype=np.float32)[:, None]
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, x ** 2)), 8, device="cpu",
                                       device_gather=False)
    step = make_train_step(lambda p, s, b: (((model(b[0]) - b[1]) ** 2).mean(), s), opt)
    wd = ttel.arm_watchdog(deadline=0.3, poll_interval=0.05, dump_dir=str(tmp_path))
    try:
        with faults.scope("data.fetch@step=3:delay=1.5"):
            train_loop(step, TrainState.create(model, opt), loader, epochs=1,
                       fuse=False)
    finally:
        ttel.disarm_watchdog()
    assert wd.last_dump_path is not None
    dump = json.loads(Path(wd.last_dump_path).read_text())
    assert dump["reason"] == "stall"
    main = [t for t in dump["threads"] if t["thread_id"] == threading.get_ident()][0]
    funcs = [f["function"] for f in main["stack"]]
    assert "check" in funcs and "__iter__" in funcs and "train_loop" in funcs
    assert _run_checker(wd.last_dump_path).returncode == 0


# ---------------------------------------------------------------------------
# The instrumented layers on the timeline; files through the checker.
# ---------------------------------------------------------------------------


def test_loader_step_and_preemption_land_on_the_timeline(port_world, tmp_path):
    torch.manual_seed(0)
    model = MLP(features=(4, 1), device="cpu")
    opt = optim.sgd(0.1)
    x = np.linspace(-1, 1, 32, dtype=np.float32)[:, None]
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, x ** 2)), 8, device="cpu")
    loss_fn = lambda p, s, b: (((model(b[0]) - b[1]) ** 2).mean(), s)  # noqa: E731
    ttel.tracing.configure(True)
    try:
        step = make_train_step(loss_fn, opt, metrics=True)
        state = TrainState.create(model, opt)
        state, _ = step(state, next(iter(loader)))
        loader.load_state_dict({"epoch": 0, "cursor": 1})
        tfm.request_preemption()
        try:
            train_loop(step, state, loader, epochs=1, fuse=False, flush_every=1)
        finally:
            tfm.clear_preemption()
        record = ttel.get_tracer().export(str(tmp_path / "t.json"))
    finally:
        ttel.tracing.reset()
    events = [e for e in record["traceEvents"] if e["ph"] != "M"]
    names = [e["name"] for e in events]
    assert names.count("train.step") == 1  # the loop drives the core
    fetches = [e["args"]["batch"] for e in events if e["name"] == "data.fetch"]
    # The first pass fetched three batches ahead of its one yield; the
    # resumed pass starts at its cursor: events keyed by position.
    assert fetches == [0, 1, 2, 1, 2, 3]
    pre = [e for e in events if e["name"] == "train.preemption"]
    assert len(pre) == 1 and pre[0]["args"]["step"] == 1
    assert _run_checker(tmp_path / "t.json").returncode == 0


def test_flight_dump_and_oom_bundle_pass_the_checker(port_world, tmp_path, monkeypatch):
    tfm.allreduce(torch.ones(2))
    (tmp_path / "flight.json").write_text(json.dumps(ttel.get_flight_recorder().dump()))
    monkeypatch.setenv("FLUXMPI_TPU_OOM_DIR", str(tmp_path))
    torch.manual_seed(0)
    model = MLP(features=(4, 1), device="cpu")
    opt = optim.sgd(0.1)
    x = np.linspace(-1, 1, 16, dtype=np.float32)[:, None]
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, x ** 2)), 8, device="cpu")
    calls = []

    def loss_fn(p, s, b):
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return ((model(b[0]) - b[1]) ** 2).mean(), s

    with pytest.warns(UserWarning, match="OOM forensics bundle written"):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            train_loop(make_train_step(loss_fn, opt), TrainState.create(model, opt),
                       loader, epochs=1, fuse=False)
    bundle = json.loads((tmp_path / "fluxmpi_oom.0.json").read_text())
    assert bundle["reason"] == "oom" and bundle["oom"]["error_type"] == "OutOfMemoryError"
    assert bundle["oom"]["census"]["count"] == 0  # no CUDA tensors on the CPU
    out = _run_checker(tmp_path / "flight.json", tmp_path / "fluxmpi_oom.0.json")
    assert out.returncode == 0, out.stdout + out.stderr
    # Any other error writes no bundle.
    os.remove(tmp_path / "fluxmpi_oom.0.json")
    with pytest.raises(ZeroDivisionError):
        train_loop(make_train_step(lambda p, s, b: (1 / 0, s), opt),
                   TrainState.create(model, opt), loader, epochs=1, fuse=False)
    assert not (tmp_path / "fluxmpi_oom.0.json").exists()


def test_step_timer_and_block_on(port_world, monkeypatch):
    import fluxmpi_tpu_torch.utils.profiling as prof

    reg = ttel.MetricsRegistry()
    holder = {}
    with step_timer(holder, metric="train.step_seconds", registry=reg) as t:
        out = t.watch(torch.ones(3) * 2)
        time.sleep(0.01)
    assert holder["seconds"] >= 0.01 and reg.histogram("train.step_seconds").count == 1
    assert block_on({"a": out}) == {"a": out}
    # Outputs on the card: the clock stops after the card has finished.
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(prof, "_cuda_devices", lambda tree: {torch.device("cuda", 0)})
    with step_timer({}) as t:
        t.watch(out)
    assert synced == [torch.device("cuda", 0)]


def test_merge_traces_merges_the_ports_per_rank_exports(tmp_path):
    paths = []
    for rank in range(2):
        tr = ttel.Tracer(enabled=True)
        with tr.span("train.step"):
            pass
        rec = tr.export()
        rec["process"] = rank
        path = tmp_path / f"trace.{rank}.json"
        path.write_text(json.dumps(rec))
        paths.append(path)
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "merge_traces.py"),
                          *map(str, paths), "-o", str(tmp_path / "merged.json")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    merged = json.loads((tmp_path / "merged.json").read_text())
    assert sum(e["name"] == "train.step" for e in merged["traceEvents"]) == 2
    assert _run_checker(tmp_path / "merged.json").returncode == 0


# ---------------------------------------------------------------------------
# Two and four gloo ranks.
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, optim, telemetry
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    fm.init(device="cpu", telemetry=f"{out}/metrics.{rank}.jsonl")
    x = {"a": torch.ones(3) * rank}
    fm.allreduce(x)
    fm.bcast(x, root=world - 1)
    fm.reduce(x, root=0)
    fm.barrier()
    fm.host_allgather(np.ones(2))

    # A straggler: rank 1's every batch is delayed; no collective inside
    # the step, so the other ranks' update times stay short.
    faults.install("data.fetch:p=1:delay=0.15:proc=1")
    torch.manual_seed(0)
    model = MLP(features=(4, 1), device="cpu")
    opt = optim.sgd(0.1)
    xs = np.linspace(-1, 1, 64, dtype=np.float32)[:, None]
    loader = fm.DistributedDataLoader(fm.ArrayDataset((xs, xs ** 2)), 8 * world,
                                      device="cpu", device_gather=False)
    step = make_train_step(lambda p, s, b: (((model(b[0]) - b[1]) ** 2).mean(), s),
                           opt, grad_reduce=None, state_reduce="local")
    mon = telemetry.TrainingMonitor(interval=1, straggler_threshold=1.2)
    train_loop(step, TrainState.create(model, opt), loader, steps=4, flush_every=2,
               metrics=mon, fuse=False)
    faults.clear()

    # A rank that skips a collective: the others start an all-reduce that
    # rank 1 has not joined, every rank dumps its flight ring, then rank 1
    # joins late so that the pending collectives complete.
    fm.barrier()
    req = None
    if rank != 1:
        _, req = fm.iallreduce(torch.ones(4))
    with open(f"{out}/flight.{rank}.json", "w") as f:
        json.dump(telemetry.get_flight_recorder().dump(), f)
    if rank == 1:
        import time
        time.sleep(0.2)
        fm.allreduce(torch.ones(4))
    else:
        req.wait()
    fm.shutdown()
    dist.destroy_process_group()
''')


def _run_ranks(tmp, world):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), str(tmp / "store"),
             str(tmp)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + JOIN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(world))
    assert not hung, f"a rank hung past {JOIN_TIMEOUT}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_streams_stragglers_and_skipped_collective(tmp_path, world):
    _run_ranks(tmp_path, world)
    for rank in range(world):
        path = tmp_path / f"metrics.{rank}.jsonl"
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert {x["process"] for x in lines} == {rank}
        assert _run_checker(path).returncode == 0
        calls = {(m["labels"]["op"], m["labels"]["path"]): m["value"]
                 for m in lines[-1]["metrics"] if m["name"] == "comm.calls"}
        # The explicit collectives, the monitor's gathers (2 flushes) and
        # the loader's shard agreement (its own allreduce of the length).
        assert calls[("bcast", "device")] == 1 and calls[("reduce", "device")] == 1
        assert calls[("barrier", "host")] >= 2
        assert calls[("host_allgather", "host")] == 1 + 2
        # Collects at both flushes flag the same straggler on every rank.
        flags = [m["value"] for x in lines for m in x["metrics"]
                 if m["name"] == "monitor.straggler"]
        maxes = [m["value"] for x in lines for m in x["metrics"]
                 if m["name"] == "monitor.step_seconds_max"]
        assert flags and all(f == 1.0 for f in flags), flags
        assert min(maxes) >= 0.15
    dumps = [json.loads((tmp_path / f"flight.{r}.json").read_text()) for r in range(world)]
    assert _run_checker(*[tmp_path / f"flight.{r}.json" for r in range(world)]
                        ).returncode == 0
    for tel in (ttel, jtel):
        diff = tel.diff_flight_dumps(dumps)
        assert diff["laggards"] == [1] and not diff["synchronized"]
        stuck = [diff["hosts"][str(r)]["in_flight"] for r in range(world) if r != 1]
        assert all(e["op"] == "allreduce" and e["seq"] == diff["max_sequence"]
                   for e in stuck)
        assert diff["hosts"]["1"]["in_flight"] is None
