"""The port's live export plane (``fluxmpi_tpu_torch.telemetry.export``) and
fleet collector (``fluxmpi_tpu_torch.telemetry.fleet``) against the JAX
package's, on the CPU. Every server binds 127.0.0.1 on port 0 and every
test stops what it started.

- ``render_prometheus`` of the same registry snapshot (counters, gauges,
  histograms with schema buckets, escaped labels, non-finite values) gives
  the same text in both packages; the name mangling round-trips every name
  of ``schema.KNOWN_METRIC_NAMES``.
- The three endpoints over real HTTP: every ``/metrics`` series demangles
  into ``KNOWN_METRIC_NAMES``, ``/status`` validates against the JAX
  package's schema, ``/healthz`` goes 200 → 503 → 200 under a fake clock;
  the configure forms and ``FLUXMPI_TPU_EXPORT_PORT``/``_ADDR`` match.
- ``train_loop`` posts its board (the tiny LM with the model stats on):
  ``/status`` carries the run's outcome, the MODEL and FLEET boards, and
  ``scripts/fluxmpi_top.py`` renders it; the serving board reads through
  ``scripts/fluxmpi_top.py`` (the port's counterpart of the JAX package's
  ``test_status_board_and_fluxmpi_top_serving_view``).
- The fleet collector: two port exporters whose FLEET boards make the
  second host a straggler by data stall are scraped by the port's and by
  the JAX package's ``FleetCollector``: the same straggler, cause, skew and
  streak; a dead host is a stale row, never an exception; three intervals
  of the same blame fire ``persistent_straggler`` naming the host; the
  snapshot bank goes through ``scripts/fleet_report.py``; the monitor's
  fleet riders give the JAX package's gauges at one process.
"""

import json
import socket
import subprocess
import sys
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu.telemetry.schema import (KNOWN_METRIC_NAMES, validate_fleet_snapshot,
                                          validate_status_record)
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.telemetry import export, fleet

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOP = ROOT / "scripts" / "fluxmpi_top.py"


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _series_names(text):
    out = []
    for line in text.splitlines():
        if line and not line.startswith("#"):
            out.append(line.split("{")[0].split(" ")[0])
    return out


def _scenario(tel):
    reg = tel.MetricsRegistry()
    reg.counter("comm.calls", op="allreduce", path="device").inc(3)
    reg.counter("comm.calls", op="bcast", path="host").inc()
    reg.gauge("train.loss", shard='a"b\\c\nd').set(1.5)
    reg.gauge("train.grad_norm").set(float("inf"))
    reg.gauge("model.layer_grad_norm", layer="params/encoder").set(float("nan"))
    for v in (0.25, 0.75, 3.0):
        reg.histogram("train.step_seconds").observe(v)
    reg.histogram("serving.ttft_seconds").observe(0.01)
    reg.histogram("data.batch_fetch_seconds")
    return reg.snapshot()


def test_render_prometheus_equals_the_jax_text():
    snap = _scenario(ttel)
    text = export.render_prometheus(snap)
    assert text == jtel.export.render_prometheus(snap)
    assert 'fluxmpi_train_step__seconds_bucket{le="+Inf"} 3' in text
    assert "fluxmpi_train_grad__norm +Inf" in text
    dup = [{"name": "goodput.fraction", "type": "gauge", "labels": {}, "value": v}
           for v in (0.1, 0.9)]
    assert export.render_prometheus(dup) == jtel.export.render_prometheus(dup)


def test_name_mangling_round_trips_every_known_name():
    for name in sorted(KNOWN_METRIC_NAMES):
        series = export.mangle_name(name)
        assert series == jtel.export.mangle_name(name)
        assert export.demangle_name(series) == name
        for suffix in export.HISTOGRAM_SUFFIXES:
            assert export.exposed_base_name(series + suffix) == \
                jtel.export.exposed_base_name(series + suffix)
    with pytest.raises(ValueError, match="prefix"):
        export.demangle_name("node_cpu_seconds")


def test_endpoints_over_http_and_healthz_under_a_fake_clock():
    reg = ttel.MetricsRegistry()
    reg.counter("train.steps").inc(7)
    reg.histogram("train.step_seconds").observe(0.01)
    fake = {"now": 0.0, "progress": 0}
    exp = export.Exporter(0, "127.0.0.1", registry=reg, deadline=10.0,
                          clock=lambda: fake["now"], sources=[lambda: fake["progress"]])
    exp.start()
    try:
        code, body = _get(exp.port, "/metrics")
        assert code == 200
        names = {export.exposed_base_name(s) for s in _series_names(body.decode())}
        assert names and names <= KNOWN_METRIC_NAMES
        code, body = _get(exp.port, "/status")
        status = json.loads(body)
        assert code == 200 and validate_status_record(status) == []
        assert status["process"] == 0 and status["process_count"] == 1
        codes = []
        for advance, progress in ((0, 0), (100, 0), (0, 1), (10.5, 0), (0, 1)):
            fake["now"] += advance
            fake["progress"] += progress
            codes.append(_get(exp.port, "/healthz")[0])
        assert codes == [200, 200, 200, 503, 200]
        assert _get(exp.port, "/nope")[0] == 404
        requests = {m["labels"]["endpoint"]: m["value"] for m in reg.snapshot()
                    if m["name"] == "export.requests"}
        assert requests == {"metrics": 1, "status": 1, "healthz": 5}
    finally:
        exp.stop()
    assert not exp.running


@pytest.fixture()
def no_planes():
    """No exporter or fleet plane installed (both packages) around a test;
    what an earlier test of this process left comes back after."""
    prev = [(mod.set_exporter(None), fl.set_fleet_collector(None), fl._enabled)
            for mod, fl in ((export, fleet), (jtel.export, jtel.fleet))]
    for fl in (fleet, jtel.fleet):
        fl._enabled = False
    yield
    for (exp, col, on), mod, fl in zip(prev, (export, jtel.export), (fleet, jtel.fleet)):
        mod.set_exporter(exp)
        fl.set_fleet_collector(col)
        fl._enabled = on


def test_configure_forms_and_env_match(monkeypatch, no_planes):
    for mod in (export, jtel.export):
        assert mod.configure() is None
        monkeypatch.setenv("FLUXMPI_TPU_EXPORT_ADDR", "127.0.0.1")
        monkeypatch.setenv("FLUXMPI_TPU_EXPORT_PORT", "many")
        with pytest.warns(UserWarning, match="ignoring FLUXMPI_TPU_EXPORT_PORT"):
            assert mod.configure() is None
        monkeypatch.delenv("FLUXMPI_TPU_EXPORT_PORT")
        exp = mod.configure(mod.Exporter(0, "127.0.0.1"))
        assert exp.running and mod.configure(exp) is exp
        assert mod.configure(exp.port) is exp  # an init() replay keeps it
        with socket.socket() as busy:
            busy.bind(("127.0.0.1", 0))
            busy.listen()
            with pytest.warns(UserWarning, match="cannot bind"):
                assert mod.configure(busy.getsockname()[1]) is None
        assert not exp.running and mod.get_exporter() is None
        with pytest.raises(ValueError, match="export spec"):
            mod.configure(-3)
        mod.shutdown()
        assert mod.get_exporter() is None
        monkeypatch.delenv("FLUXMPI_TPU_EXPORT_ADDR")


# ---------------------------------------------------------------------------
# The boards train_loop and the serving engine post
# ---------------------------------------------------------------------------


def _corpus(n=32, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 97, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % 97)
    return np.concatenate(seqs, axis=1).astype(np.int32)


def _top(port):
    return subprocess.run([sys.executable, str(TOP), f"http://127.0.0.1:{port}", "--once"],
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("fuse", [False, "window"])
def test_train_loop_posts_its_boards_and_fluxmpi_top_reads_them(fuse):
    corpus = _corpus()
    tfm.init(device="cpu", export=export.Exporter(0, "127.0.0.1", deadline=3600.0),
             model_stats=3, fleet=fleet.FleetCollector(["127.0.0.1:9"], interval=60.0),
             goodput=True)
    try:
        exp = export.get_exporter()
        loader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            device="cpu")
        lm = TransformerLM(vocab_size=97, max_len=32, num_layers=2, d_model=32,
                           num_heads=4, d_ff=64, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        opt = optim.adamw(1e-3)
        step = make_train_step(lambda p, ms, b: (lm(b[0], targets=b[1]).mean(), ms), opt,
                               metrics=True)
        _, summary = train_loop(step, TrainState.create(lm, opt), loader, steps=4,
                                flush_every=2, fuse=fuse)
        code, body = _get(exp.port, "/status")
        status = json.loads(body)
        assert code == 200 and validate_status_record(status) == []
        train = status["train"]
        assert train["phase"] == "finished" and train["anomaly"] is None
        assert train["updates"] == summary["updates"] == 4
        assert train["loss"] == pytest.approx(summary["loss"])
        assert train["fused_window"] == summary["fused_window"]
        assert status["model"]["step"] == 4 and status["model"]["nonfinite_layer"] is None
        assert [t["layer"] for t in status["model"]["top"]][0].startswith("params/")
        assert status["fleet"]["updates"] == 4 and "step_seconds" in status["fleet"]
        assert status["goodput"]["updates"] == 4
        code, body = _get(exp.port, "/metrics")
        names = {export.exposed_base_name(s) for s in _series_names(body.decode())}
        assert "model.layer_grad_norm" in names and names <= KNOWN_METRIC_NAMES
        top = _top(exp.port)
        assert top.returncode == 0, top.stderr
        assert "finished" in top.stdout and "MODEL" in top.stdout
    finally:
        tfm.shutdown()
    assert export.get_exporter() is None and not fleet.enabled()


def test_status_board_and_fluxmpi_top_serving_view():
    """Counterpart of the JAX package's
    ``test_status_board_and_fluxmpi_top_serving_view``."""
    from fluxmpi_tpu_torch.serving import InferenceEngine, observe

    exp = export.Exporter(0, "127.0.0.1", deadline=3600.0)
    export.configure(exp)
    observe.configure(True)
    try:
        lm = TransformerLM(vocab_size=31, max_len=32, num_layers=1, d_model=16,
                           num_heads=2, d_ff=32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        eng = InferenceEngine(lm, slots=2, block_size=8)
        rng = np.random.default_rng(8)
        for _ in range(3):
            eng.submit(rng.integers(1, 31, 5).tolist(), 6)
        summary = eng.run()
        code, body = _get(exp.port, "/status")
        status = json.loads(body)
        assert validate_status_record(status) == []
        srv = status["serving"]
        assert srv["phase"] == "finished"
        assert srv["completed"] == summary["completed"] == 3
        assert srv["tokens"] == summary["tokens"]
        assert srv["kv_blocks_in_use"] == 0
        assert srv["requests_logged"] == 3
        assert srv["burn_rate"] == 0.0
        assert srv["ttft_p50"] is not None and srv["ttft_p99"] is not None
        top = _top(exp.port)
        assert top.returncode == 0, top.stderr
        assert "SERVING" in top.stdout and "finished" in top.stdout
        assert "burn" in top.stdout
        eng.close()
    finally:
        observe.shutdown()
        export.shutdown()


# ---------------------------------------------------------------------------
# The fleet collector
# ---------------------------------------------------------------------------


def _hosts(n=2):
    """``n`` port exporters on port 0, each process index 0 (one host per
    exporter), their FLEET boards empty."""
    return [export.Exporter(0, "127.0.0.1", deadline=3600.0).start() for _ in range(n)]


def _post(exp, *, updates, wall, stall, comm=0.0, seq=10.0):
    exp.note_status(updates=updates)
    exp.note_fleet(updates=updates, wall_seconds=wall, step_seconds=wall - stall - comm,
                   data_stall_seconds=stall, host_idle_seconds=0.0,
                   comm_block_seconds=comm, flight_seq=seq)


@pytest.mark.parametrize("cause", ["data_stall", "comm_wait", "compute"])
def test_both_collectors_name_the_same_straggler_and_cause(cause, tmp_path):
    hosts = _hosts()
    dead = "127.0.0.1:9"  # nothing listens: a stale row
    targets = [f"127.0.0.1:{h.port}" for h in hosts] + [dead]
    verdicts = {}
    try:
        collectors = {
            "port": fleet.FleetCollector(targets, interval=60.0, timeout=2.0,
                                         log=str(tmp_path / "fleet.jsonl"),
                                         registry=ttel.MetricsRegistry(),
                                         detector=ttel.AnomalyDetector(dump=False)),
            "jax": jtel.fleet.FleetCollector(targets, interval=60.0, timeout=2.0,
                                             registry=jtel.MetricsRegistry(),
                                             detector=jtel.AnomalyDetector(dump=False))}
        slow = {"data_stall": dict(stall=12.0), "comm_wait": dict(stall=0.0, comm=12.0),
                "compute": dict(stall=0.0)}[cause]
        seq = 0.0
        for interval in range(3):
            seq += 5
            _post(hosts[0], updates=10 * (interval + 1), wall=10.0 * (interval + 1),
                  stall=0.0, seq=seq)
            _post(hosts[1], updates=10 * (interval + 1), wall=20.0 * (interval + 1),
                  **{k: v * (interval + 1) for k, v in slow.items()}, seq=seq)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                snaps = {n: c.collect_once() for n, c in collectors.items()}
            for snap in snaps.values():
                assert validate_fleet_snapshot(snap) == []
            verdicts[interval] = {n: s["attribution"] for n, s in snaps.items()}
        for interval, v in verdicts.items():
            assert v["port"] == v["jax"]
            assert v["port"]["straggler"] == targets[1] and v["port"]["cause"] == cause
            assert v["port"]["streak"] == interval + 1
        snap = snaps["port"]
        row = snap["hosts"][dead]
        assert row["alive"] is False and row["stale_seconds"] is None and row["error"]
        assert snap["hosts"][targets[0]]["alive"] is True
        for name, c in collectors.items():
            (ev,) = [e for e in c._detector.triggered if e["rule"] == "persistent_straggler"]
            assert ev["host"] == targets[1] and ev["value"] == 3.0
        report = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "fleet_report.py"),
             str(tmp_path / "fleet.jsonl"), "--json"],
            capture_output=True, text=True, timeout=60)
        assert report.returncode == 0, report.stderr
        rep = json.loads(report.stdout)
        assert rep["snapshots"] == 3 and rep["stragglers"] == {cause: 3}
        check = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
             str(tmp_path / "fleet.jsonl")], capture_output=True, text=True, timeout=60)
        assert check.returncode == 0, check.stdout + check.stderr
    finally:
        for h in hosts:
            h.stop()


def test_fleet_configure_forms_and_monitor_riders_match(monkeypatch, no_planes):
    for mod, tel in ((fleet, ttel), (jtel.fleet, jtel)):
        assert mod.configure() is None and not mod.enabled()
        monkeypatch.setenv("FLUXMPI_TPU_FLEET_HOSTS", "127.0.0.1:9")
        monkeypatch.setenv("FLUXMPI_TPU_FLEET_INTERVAL", "nope")
        with pytest.warns(UserWarning, match="FLUXMPI_TPU_FLEET_INTERVAL"):
            col = mod.configure(True)
        assert mod.enabled() and col.targets == ("127.0.0.1:9",) and col.interval == 5.0
        assert mod.configure("1") is col and col.running
        with pytest.raises(ValueError, match="fleet spec"):
            mod.configure(3)
        mod.shutdown()
        assert not mod.enabled() and mod.get_fleet_collector() is None
        monkeypatch.delenv("FLUXMPI_TPU_FLEET_HOSTS")
        monkeypatch.delenv("FLUXMPI_TPU_FLEET_INTERVAL")
    gauges = {}
    for name, tel in (("port", ttel), ("jax", jtel)):
        tel.fleet._enabled = True
        try:
            mon = tel.TrainingMonitor(registry=tel.MetricsRegistry(), interval=1,
                                      cross_host=False)
            mon.registry.histogram("comm.block_seconds", op="allreduce").observe(0.5)
            for s in (0.1, 0.3):
                mon.observe_step(s)
            gauges[name] = {m["name"]: m["value"] for m in mon.registry.snapshot()
                            if m["name"].startswith("fleet.")}
        finally:
            tel.fleet._enabled = False
    assert gauges["port"] == gauges["jax"] == {
        "fleet.step_time_skew": 1.0, "fleet.collective_skew_seconds": 0.0,
        "fleet.flight_seq_lag": 0.0}
