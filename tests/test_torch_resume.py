"""Kill-and-resume on the port's training loop, against the JAX package's.

The scenario of ``tests/test_resume.py`` on the port: the quick-start MLP
(features 16, 1) from converted JAX weights, adam(1e-3), 128 samples,
global batch 32, ``shuffle=True``, ``seed=7``, ``prefetch=0`` (so hit N of
``data.fetch`` is batch N), ``save_every=2``. A run killed by an injected
fetch fault and resumed by a fresh step, loader and manager ends
bit-identical (parameters and every optimizer moment) to the
uninterrupted port run, and reports the same ``resumed_from``,
``updates``, ``epochs`` and ``examples`` as the JAX loop in the same
scenario. Its final parameters track the JAX run within the f32
tolerance of ``tests/test_torch_train.py`` (atol 2e-5: the same
arithmetic, sums in other orders). Also: an empty directory starts fresh,
a budget already met returns at once, a preemption drains, banks an
emergency checkpoint, and resumes to the uninterrupted run's bits (at a
ragged scan boundary too, counting the epoch once), and
the fault schedule grammar and site registry equal the JAX package's."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu import faults as jfaults
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu.utils import CheckpointManager as JaxCheckpointManager
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.models import MLP, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.utils import CheckpointManager

torch.set_num_threads(1)

ATOL = 2e-5
STEPS = 10


@pytest.fixture(scope="module")
def port_world():
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


@pytest.fixture(autouse=True)
def _clean_flags():
    faults.clear()
    jfaults.clear()
    tfm.clear_preemption()
    yield
    faults.clear()
    jfaults.clear()
    tfm.clear_preemption()


def _data(n=128):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    return x, x ** 2


@pytest.fixture(scope="module")
def jax_params():
    params = JaxMLP(features=(16, 1)).init(jax.random.PRNGKey(0),
                                           jnp.zeros((2, 1)))
    return jax.tree_util.tree_map(np.asarray, params)


class _Run:
    """A fresh 'process' of the port: model, step, state and loader."""

    def __init__(self, params, scan_steps=1, on_call=None, n=128):
        self.model = MLP(features=(16, 1), device="cpu")
        load_flax_params(self.model, params)
        self.calls = 0

        def loss_fn(p, ms, batch):
            self.calls += 1
            if on_call is not None:
                on_call(self.calls)
            x, y = batch
            return ((self.model(x) - y) ** 2).mean(), ms

        opt = optim.adam(1e-3)
        self.step = make_train_step(loss_fn, opt, scan_steps=scan_steps)
        self.state = TrainState.create(self.model, opt)
        x, y = _data(n)
        self.loader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((x, y)), 32, shuffle=True, seed=7, prefetch=0,
            device="cpu")

    def loop(self, **kw):
        kw.setdefault("steps", None if "epochs" in kw else STEPS)
        return train_loop(self.step, self.state, self.loader, **kw)


def _assert_same_bits(a: TrainState, b: TrainState):
    assert a.step == b.step
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
    assert a.opt_state["count"] == b.opt_state["count"]
    for moment in ("mu", "nu"):
        for name in a.params:
            assert torch.equal(a.opt_state[moment][name],
                               b.opt_state[moment][name]), (moment, name)


def _jax_scenario(world, params, tmp, crash_hit, scan_steps):
    """The JAX loop's crash-and-resume summaries, and its final params."""
    opt = optax.adam(1e-3)
    from fluxmpi_tpu.models import MLP as JM

    model = JM(features=(16, 1))

    def loss_fn(p, ms, b):
        bx, by = b
        return jnp.mean((model.apply(p, bx) - by) ** 2), ms

    x, y = _data()

    def loader():
        return jfm.DistributedDataLoader(
            jfm.ArrayDataset((x, y)), 32, mesh=world, shuffle=True, seed=7,
            device_gather=False, prefetch=0)

    def fresh():
        return replicate(JaxTrainState.create(params, opt), world)

    mgr = JaxCheckpointManager(str(tmp / "jax"), async_save=False)
    with jfaults.scope(f"data.fetch@step={crash_hit}"):
        with pytest.raises(jfm.FaultInjectedError):
            jax_train_loop(jax_make_train_step(loss_fn, opt, mesh=world,
                                               scan_steps=scan_steps),
                           fresh(), loader(), steps=STEPS, checkpoint=mgr,
                           save_every=2)
    mgr2 = JaxCheckpointManager(str(tmp / "jax"), async_save=False)
    state, summary = jax_train_loop(
        jax_make_train_step(loss_fn, opt, mesh=world, scan_steps=scan_steps),
        fresh(), loader(), steps=STEPS, checkpoint=mgr2, save_every=2,
        resume=True)
    return summary, jax.device_get(state.params)


@pytest.mark.parametrize("crash_hit,scan_steps", [(3, 1), (7, 1), (6, 2)])
def test_kill_and_resume_is_bit_identical_and_matches_jax(
        world, port_world, jax_params, tmp_path, crash_hit, scan_steps):
    ref = _Run(jax_params, scan_steps)
    ref_state, ref_summary = ref.loop()
    assert ref_summary["updates"] == STEPS

    crashed = _Run(jax_params, scan_steps)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with faults.scope(f"data.fetch@step={crash_hit}"):
        with pytest.raises(tfm.FaultInjectedError):
            crashed.loop(checkpoint=mgr, save_every=2)
    banked = mgr.latest_step()
    assert banked is not None

    resumed = _Run(jax_params, scan_steps)
    mgr2 = CheckpointManager(str(tmp_path / "run"), async_save=False)
    state, summary = resumed.loop(checkpoint=mgr2, save_every=2, resume=True)
    assert summary["resumed_from"] == banked
    for key in ("updates", "epochs", "examples"):
        assert summary[key] == ref_summary[key], key
    _assert_same_bits(state, ref_state)
    # The model's own parameters are the state's: resumed in place.
    assert state.params["dense_0.kernel"] is resumed.model.dense_0.kernel

    jsummary, jparams = _jax_scenario(world, jax_params, tmp_path, crash_hit,
                                      scan_steps)
    for key in ("resumed_from", "updates", "epochs", "examples"):
        assert summary[key] == jsummary[key], key
    got = to_flax_params(resumed.model)
    for name, want in jax.tree_util.tree_flatten_with_path(jparams["params"])[0]:
        path = "/".join(str(p.key) for p in name)
        np.testing.assert_allclose(got[path], np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=path)


def test_resume_on_empty_directory_starts_fresh_and_past_budget_returns(
        port_world, jax_params, tmp_path):
    ref_state, _ = _Run(jax_params).loop()
    run = _Run(jax_params)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    state, summary = run.loop(checkpoint=mgr, save_every=2, resume=True)
    assert summary["resumed_from"] is None and summary["updates"] == STEPS
    assert mgr.all_steps()[-1] == STEPS and len(mgr.all_steps()) == 3
    _assert_same_bits(state, ref_state)

    again = _Run(jax_params)
    state, summary = again.loop(checkpoint=CheckpointManager(
        str(tmp_path / "run"), async_save=False), resume=True)
    assert summary["resumed_from"] == STEPS
    assert summary["updates"] == STEPS and summary["dispatches"] == 0
    assert again.calls == 0
    _assert_same_bits(state, ref_state)


def test_preemption_drains_banks_and_resumes_to_the_same_bits(
        port_world, jax_params, tmp_path):
    ref_state, ref_summary = _Run(jax_params).loop()

    def preempt_at_third(call):
        if call == 3:
            tfm.request_preemption()  # "SIGTERM" lands mid-run

    run = _Run(jax_params, on_call=preempt_at_third)
    mgr = CheckpointManager(str(tmp_path / "run"))
    _, s1 = run.loop(checkpoint=mgr)
    assert s1["preempted"] is True and s1["updates"] == 3
    assert mgr.latest_step() == 3  # the emergency checkpoint, committed

    tfm.clear_preemption()
    resumed = _Run(jax_params)
    state, s2 = resumed.loop(checkpoint=CheckpointManager(str(tmp_path / "run")),
                             resume=True)
    assert s2["resumed_from"] == 3 and s2["preempted"] is False
    for key in ("updates", "epochs", "examples"):
        assert s2[key] == ref_summary[key], key
    _assert_same_bits(state, ref_state)


def test_preemption_at_ragged_scan_boundary_counts_epoch_once(
        port_world, jax_params, tmp_path):
    """Preempted after the last scan group of a ragged epoch (5 batches,
    k=2: 2 dispatches and a tail that never dispatches), the emergency
    save banks the next epoch's start, so the resume neither replays the
    tail nor counts the pass twice."""
    ref_state, s_ref = _Run(jax_params, scan_steps=2, n=160).loop(epochs=3)
    assert s_ref["updates"] == 12 and s_ref["epochs"] == 3

    def preempt_at_fourth(call):
        if call == 4:
            tfm.request_preemption()

    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    _, s1 = _Run(jax_params, scan_steps=2, on_call=preempt_at_fourth,
                 n=160).loop(epochs=3, checkpoint=mgr)
    assert s1["preempted"] and s1["updates"] == 4 and s1["epochs"] == 1
    tfm.clear_preemption()
    state, s2 = _Run(jax_params, scan_steps=2, n=160).loop(
        epochs=3, checkpoint=mgr, resume=True)
    assert s2["resumed_from"] == 4
    assert (s2["updates"], s2["epochs"], s2["examples"]) == \
        (s_ref["updates"], s_ref["epochs"], s_ref["examples"])
    _assert_same_bits(state, ref_state)


def test_preemption_handler_sets_the_flag_on_sigterm():
    import os
    import signal

    assert not tfm.preemption_handlers_installed()
    tfm.install_preemption_handlers()
    try:
        assert tfm.preemption_handlers_installed()
        os.kill(os.getpid(), signal.SIGTERM)
        assert tfm.preemption_requested()
    finally:
        tfm.uninstall_preemption_handlers()
    assert not tfm.preemption_handlers_installed()
    assert not tfm.preemption_requested()
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_preemption_handler_sets_the_flag_on_sigint():
    """Ctrl-C drains and banks as SIGTERM does: the default signals are the
    JAX package's (SIGTERM, SIGINT)."""
    import inspect
    import os
    import signal

    from fluxmpi_tpu import runtime as jruntime

    default = inspect.signature(tfm.install_preemption_handlers).parameters["signals"].default
    assert default == inspect.signature(
        jruntime.install_preemption_handlers).parameters["signals"].default
    before = signal.getsignal(signal.SIGINT)
    tfm.install_preemption_handlers()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert tfm.preemption_requested()
    finally:
        tfm.uninstall_preemption_handlers()
    assert not tfm.preemption_requested()
    assert signal.getsignal(signal.SIGINT) is before


def test_train_loop_checkpoint_arguments_are_checked(port_world, jax_params):
    run = _Run(jax_params)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        run.loop(save_every=2)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        run.loop(resume=True)
    with pytest.raises(ValueError, match="save_every must be >= 1"):
        run.loop(save_every=0, checkpoint=object())


def test_data_fetch_hit_n_is_batch_n(jax_params):
    x, y = _data()
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 32,
                                       prefetch=0, device="cpu")
    seen = []
    with faults.scope("data.fetch@step=3"):
        with pytest.raises(tfm.FaultInjectedError, match="hit 3"):
            for batch in loader:
                seen.append(batch)
    assert len(seen) == 2 and loader.state_dict()["cursor"] == 2


@pytest.mark.parametrize("entry", [
    "data.fetch@step=5", "ckpt.write:p=0.25:seed=3", "data.fetch@step=5:times=2:proc=1",
    "data.fetch@step=30:delay=0.5", "comm.allreduce",
])
def test_fault_grammar_matches_jax(entry):
    assert str(faults.parse_spec(entry)) == str(jfaults.parse_spec(entry))
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES


def test_fault_schedules_validate_count_and_configure(monkeypatch):
    with pytest.raises(ValueError, match="nearest registered site: 'data.fetch'"):
        faults.install("data.fetchh@step=1")
    assert not faults.ARMED
    for bad in ("data.fetch@step=0", "data.fetch:bogus=1", "data.fetch:step"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
    faults.install("ckpt.read@step=2:times=2")
    faults.check("ckpt.read")
    for hit in (2, 3):
        with pytest.raises(tfm.FaultInjectedError, match=f"hit {hit}"):
            faults.check("ckpt.read")
    faults.check("ckpt.read")  # times=2 spent
    assert faults.injected_count() == 2
    with faults.scope("data.fetch@step=1"):
        assert [str(s) for s in faults.active()] == ["data.fetch:step=1:times=1"]
    assert [s.site for s in faults.active()] == ["ckpt.read"]  # restored
    faults.clear()
    monkeypatch.setenv("FLUXMPI_TPU_FAULTS", "data.fetch@step=4")
    assert [s.step for s in faults.configure()] == [4] and faults.ARMED
    with pytest.warns(UserWarning, match="unknown fault site"):
        faults.configure("my.site@step=1")
    assert faults.register_site("my.site") in faults.registered_sites()
    assert faults.configure("0") == [] and not faults.ARMED
