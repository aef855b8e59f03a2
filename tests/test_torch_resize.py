"""The live-resize plane in the port (``fluxmpi_tpu_torch.fleet.resize``,
``init(resize=)``, ``train_loop``'s drain and reshard phases) against the
JAX package (``tests/test_zero_downtime.py``'s resize cases).

Checked, in one process: the plane's ``configure`` forms (the environment
variable, a bank path, ``False``), ``init(resize=)`` and the shutdown
no-leak contract; the ``fluxmpi_tpu.resize/v1`` record's validation, the
same verdicts from both packages' validators; the in-process round trip
(request, drain at a flush boundary, timed save and handoff stamp, the
resumed run's reshard, one banked record), pipelined and over fused
windows: it drains at the JAX package's update count, its final state is
bit for bit the port's uninterrupted run's and within 1e-5 of the JAX
package's in f32; a SIGTERM-style preemption with a target requested is a
resize; the ``resize.drain`` and ``resize.reshard`` fault sites fire; the
CHECKPOINT and RESIZE boards reach an installed exporter."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu import faults as jfaults
from fluxmpi_tpu.data import ArrayDataset as JArrayDataset
from fluxmpi_tpu.data import DistributedDataLoader as JLoader
from fluxmpi_tpu.fleet import resize as jresize
from fluxmpi_tpu.models import MLP as JMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate as jreplicate
from fluxmpi_tpu.telemetry import schema as jschema
from fluxmpi_tpu.utils import CheckpointManager as JManager

import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import faults, optim, runtime
from fluxmpi_tpu_torch.errors import FaultInjectedError
from fluxmpi_tpu_torch.fleet import resize
from fluxmpi_tpu_torch.fleet.resize import ResizeCoordinator, read_handoff
from fluxmpi_tpu_torch.models import MLP, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.telemetry import schema
from fluxmpi_tpu_torch.utils import CheckpointManager

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    jfaults.clear()
    runtime.clear_preemption()
    yield
    faults.clear()
    jfaults.clear()
    runtime.clear_preemption()
    resize.shutdown()
    jresize.shutdown()


def test_configure_forms_init_and_shutdown_no_leak(tmp_path, monkeypatch):
    assert not resize.enabled()
    monkeypatch.setenv("FLUXMPI_TPU_RESIZE", "1")
    assert resize.configure() is not None and resize.enabled()
    resize.configure(False)
    assert not resize.enabled()
    bank = str(tmp_path / "resize.jsonl")
    rc = resize.configure(bank)
    assert rc.enabled and rc.log_path == bank
    with pytest.raises(ValueError, match="resize target"):
        resize.request_resize(0)
    resize.request_resize(4, reason="test")
    assert rc.requested_target() == 4
    resize.shutdown()
    assert rc.requested_target() == 0 and not resize.enabled()
    monkeypatch.delenv("FLUXMPI_TPU_RESIZE")
    mine = ResizeCoordinator(enabled=False)
    try:
        tfm.init(device="cpu", resize=mine)
        assert resize.get_resize_coordinator() is mine and mine.enabled
        resize.request_resize(2)
    finally:
        prev = resize.set_resize_coordinator(resize.ResizeCoordinator(enabled=False))
        tfm.shutdown()
    assert prev is mine and not resize.enabled()
    # shutdown disarms the default coordinator and drops its request.
    tfm.init(device="cpu", resize=bank)
    resize.request_resize(3)
    tfm.shutdown()
    assert not resize.enabled() and resize.get_resize_coordinator().requested_target() == 0


def _record(**over):
    rec = {"schema": schema.RESIZE_SCHEMA, "time_unix": 1.0, "step": 4,
           "from_processes": 4, "to_processes": 2, "reason": "api",
           "phases": {"drain": 0.1, "save": 0.5, "reshard": 0.2, "restart": 0.2},
           "badput_seconds": 1.0}
    rec.update(over)
    return rec


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"phases": {"drain": 0.1}, "badput_seconds": 0.1}, False),
    ({"badput_seconds": 2.0}, False),
    ({"to_processes": 0}, False),
    ({"schema": "other"}, False),
])
def test_record_validation_matches_jax(over, ok):
    rec = _record(**over)
    port, ref = schema.validate_resize_record(rec), jschema.validate_resize_record(rec)
    assert (port == []) == ok == (ref == [])
    assert port == ref


def test_fault_sites_fire(tmp_path):
    rc = ResizeCoordinator()
    with faults.scope("resize.drain@step=1"):
        with pytest.raises(FaultInjectedError, match="resize.drain"):
            rc.begin(2, from_processes=1)
    rc = ResizeCoordinator()
    rc.begin(1, from_processes=1)
    rc.note_drained()
    rc.write_handoff(str(tmp_path), step=3, from_processes=1, to_processes=1)
    assert read_handoff(str(tmp_path))["step"] == 3
    with faults.scope("resize.reshard@step=1"):
        with pytest.raises(FaultInjectedError, match="resize.reshard"):
            ResizeCoordinator().maybe_begin_reshard(str(tmp_path))


# ---------------------------------------------------------------------------
# The in-process round trip, against the JAX package's
# ---------------------------------------------------------------------------


def _data(n=128):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    return x, x ** 2


def _jax_pieces(world):
    model = JMLP(features=(16, 1))
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((2, 1))))
    opt = optax.adam(1e-3)

    def loss_fn(p, ms, b):
        return jnp.mean((model.apply(p, b[0]) - b[1]) ** 2), ms

    def loader():
        return JLoader(JArrayDataset(_data()), 32, mesh=world, shuffle=True, seed=7,
                       device_gather=False, prefetch=0)

    step = jax_make_train_step(loss_fn, opt, mesh=world)
    return step, lambda: jreplicate(JaxTrainState.create(params, opt), world), loader, params


def _port_pieces(params, fuse):
    model = load_flax_params(MLP(features=(16, 1), device="cpu"), params)

    def loss_fn(p, ms, b):
        return ((torch.func.functional_call(model, p, (b[0],)) - b[1]) ** 2).mean(), ms

    opt = optim.adam(1e-3)

    def fresh():
        return TrainState.create({k: v.detach().clone().requires_grad_()
                                  for k, v in model.named_parameters()}, opt)

    def loader():
        return tfm.DistributedDataLoader(tfm.ArrayDataset(_data()), 32, shuffle=True,
                                         seed=7, prefetch=0, device="cpu",
                                         device_gather=fuse is not False)

    # One process, no world: nothing to reduce.
    return make_train_step(loss_fn, opt, grad_reduce=None), fresh, loader


@pytest.fixture(scope="module")
def jax_round_trip(world, tmp_path_factory):
    """The JAX package's round trip: the update it drained at, its final
    parameters."""
    tmp = tmp_path_factory.mktemp("jax_resize")
    jresize.configure(str(tmp / "bank.jsonl"))
    step, fresh, loader, params = _jax_pieces(world)
    mgr = JManager(str(tmp / "ck"), async_save=True)
    jresize.request_resize(1, reason="test-shrink")
    _, first = jax_train_loop(step, fresh(), loader(), steps=8, checkpoint=mgr,
                              save_every=100, flush_every=2)
    mgr.close()
    mgr2 = JManager(str(tmp / "ck"), async_save=True)
    state, _ = jax_train_loop(step, fresh(), loader(), steps=8, checkpoint=mgr2,
                              save_every=100, flush_every=2, resume=True)
    mgr2.close()
    jresize.shutdown()
    return first["updates"], jax.device_get(state.params), params


@pytest.mark.parametrize("fuse", [False, "auto"])
def test_in_process_round_trip_equals_jax(jax_round_trip, tmp_path, fuse):
    drained_at, jax_params, params = jax_round_trip
    bank = str(tmp_path / "resize_bank.jsonl")
    resize.configure(bank)
    step, fresh, loader = _port_pieces(params, fuse)
    ref_state, ref = train_loop(step, fresh(), loader(), steps=8, flush_every=2, fuse=fuse)
    ckpt_dir = str(tmp_path / "ck")
    mgr = CheckpointManager(ckpt_dir, async_save=True)
    resize.request_resize(1, reason="test-shrink")
    _, summary = train_loop(step, fresh(), loader(), steps=8, checkpoint=mgr,
                            save_every=100, flush_every=2, fuse=fuse)
    mgr.close()
    assert (summary["fused_window"] is not None) == (fuse == "auto")
    assert summary["resized_to"] == 1
    assert summary["updates"] == drained_at == 2  # the first flush boundary
    stamp = read_handoff(ckpt_dir)
    assert stamp["handoff"] is True and stamp["step"] == summary["updates"]
    mgr2 = CheckpointManager(ckpt_dir, async_save=True)
    state, summary2 = train_loop(step, fresh(), loader(), steps=8, checkpoint=mgr2,
                                 save_every=100, flush_every=2, resume=True, fuse=fuse)
    mgr2.close()
    assert summary2["resumed_from"] == drained_at and summary2["updates"] == 8
    assert summary2["resized_to"] is None and read_handoff(ckpt_dir) is None
    with open(bank) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert len(records) == 1
    rec = records[0]
    assert schema.validate_resize_record(rec) == [] == jschema.validate_resize_record(rec)
    assert rec["from_processes"] == rec["to_processes"] == 1
    assert rec["reason"] == "test-shrink" and rec["badput_seconds"] > 0
    assert set(rec["phases"]) == set(schema.RESIZE_PHASES)
    checker = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                              bank], capture_output=True, text=True)
    assert checker.returncode == 0, checker.stderr
    for k, v in state.params.items():
        assert torch.equal(v, ref_state.params[k]), k
        layer, leaf = k.split(".")
        np.testing.assert_allclose(v.detach().numpy(), jax_params["params"][layer][leaf],
                                   rtol=0, atol=1e-5, err_msg=k)


def test_preemption_with_a_target_requested_is_a_resize(tmp_path):
    resize.configure(True)
    x, y = _data()
    model = MLP(features=(16, 1), device="cpu")
    calls = [0]

    def loss_fn(p, ms, b):
        calls[0] += 1
        if calls[0] == 3:
            resize.request_resize(2, reason="sigterm")
            runtime.request_preemption()
        return ((torch.func.functional_call(model, p, (b[0],)) - b[1]) ** 2).mean(), ms

    opt = optim.adam(1e-3)
    state = TrainState.create({k: v.detach().clone().requires_grad_()
                               for k, v in model.named_parameters()}, opt)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 32, device="cpu",
                                       device_gather=False, prefetch=0)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    _, summary = train_loop(make_train_step(loss_fn, opt, grad_reduce=None), state, loader,
                            steps=8, flush_every=4, checkpoint=mgr)
    # The preemption is seen at the dispatch, the target at its flush.
    assert summary["preempted"] and summary["resized_to"] is None
    assert summary["updates"] == 3 and mgr.all_steps() == [3]
    assert read_handoff(mgr.directory) is None
    runtime.clear_preemption()
    resize.request_resize(2, reason="sigterm")
    runtime.request_preemption()
    _, summary = train_loop(make_train_step(loss_fn, opt, grad_reduce=None), state, loader,
                            steps=8, flush_every=1, checkpoint=mgr, resume=True)
    assert summary["preempted"] and summary["resized_to"] == 2
    stamp = read_handoff(mgr.directory)
    assert stamp["step"] == summary["updates"] == 4 and stamp["to_processes"] == 2
    assert mgr.all_steps()[-1] == 4


def test_checkpoint_and_resize_boards_reach_the_exporter(tmp_path):
    """The manager posts the CHECKPOINT board (last committed step and
    tier, the in-flight save) and the coordinator the RESIZE board, with
    the JAX package's field names, while an exporter is installed (not
    started: nothing binds a port)."""
    from fluxmpi_tpu_torch.telemetry import export
    from fluxmpi_tpu_torch.telemetry.export import Exporter

    prev = export.set_exporter(Exporter(0, "127.0.0.1"))
    try:
        resize.configure(True)
        step, fresh, loader = _port_pieces(jax.device_get(JMLP(features=(16, 1)).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 1)))), False)
        mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
        resize.request_resize(1)
        train_loop(step, fresh(), loader(), steps=8, flush_every=2, checkpoint=mgr)
        status = export.get_exporter().build_status()
        assert status["checkpoint"]["last_committed_step"] == 2
        assert status["checkpoint"]["tier"] == "durable"
        assert status["checkpoint"]["inflight_step"] is None
        assert status["resize"]["phase"] == "handoff" and status["resize"]["step"] == 2
        assert set(status["resize"]["phase_seconds"]) == {"drain", "save"}
        train_loop(step, fresh(), loader(), steps=8, flush_every=2, checkpoint=mgr,
                   resume=True)
        status = export.get_exporter().build_status()
        assert status["resize"]["phase"] == "completed"
        assert set(status["resize"]["phase_seconds"]) == set(schema.RESIZE_PHASES)
        assert status["checkpoint"]["last_committed_step"] == 2
    finally:
        export.set_exporter(prev)
