"""One-program flush windows in the port (``train_loop(fuse="window")``,
engaged by ``fuse="auto"``) over the device-gather loader, on the CPU,
where a window runs eagerly (on the card it is one CUDA-graph replay:
``tests/test_torch_cuda.py``).

The scenarios of ``tests/test_fused.py`` on the port, with the quick-start
MLP (features 16, 16, 1), adam(1e-3), 256 samples, global batch 64
(4 batches per epoch), ``shuffle=True``, ``seed=11``: fused, pipelined and
``scan_steps=2`` runs end bit-identical; ``fuse="auto"`` engages and
falls back exactly where the JAX package's does; a forced ``"window"``
raises with its reasons; a steps budget rounds up to whole windows; a
pipelined run killed mid-window resumes fused with one short realignment
window to the uninterrupted run's bits; fused saves resume fused; a
preemption drains at a window boundary; ``device_epoch()`` follows the
iteration order; the staging budget's environment variable is hardened.

Against the JAX package: the same numpy data and converted weights
through JAX's ``train_loop(fuse="window")`` and the port's give the same
``updates``, ``epochs``, ``examples``, ``dispatches`` and
``fused_window``, the same epoch permutations, and per-window losses and
final parameters within the f32 tolerance of ``tests/test_torch_train.py``
(2e-5 absolute: the same arithmetic, sums in other orders).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu_torch import data as tdata
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.models import MLP, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.parallel.train import make_window_program
from fluxmpi_tpu_torch.utils import CheckpointManager

torch.set_num_threads(1)

ATOL = 2e-5
FEATURES = (16, 16, 1)


@pytest.fixture(scope="module")
def port_world():
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


@pytest.fixture(autouse=True)
def _clean_flags():
    faults.clear()
    tfm.clear_preemption()
    yield
    faults.clear()
    tfm.clear_preemption()


@pytest.fixture(scope="module")
def jax_params():
    params = JaxMLP(features=FEATURES).init(jax.random.PRNGKey(0), jnp.zeros((2, 1)))
    return jax.tree_util.tree_map(np.asarray, params)


def _data(n=256):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    return x, x ** 2


class _Run:
    """A fresh 'process' of the port: model, step, state and loader."""

    def __init__(self, params, scan_steps=1, n=256, **loader):
        self.model = MLP(features=FEATURES, device="cpu")
        load_flax_params(self.model, params)
        self.opt = optim.adam(1e-3)

        def loss_fn(p, ms, batch):
            x, y = batch
            return ((self.model(x) - y) ** 2).mean(), ms

        self.step = make_train_step(loss_fn, self.opt, scan_steps=scan_steps)
        self.state = TrainState.create(self.model, self.opt)
        loader.setdefault("shuffle", True)
        loader.setdefault("seed", 11)
        self.loader = tfm.DistributedDataLoader(tfm.ArrayDataset(_data(n)), 64,
                                                device="cpu", **loader)

    def loop(self, **kw):
        return train_loop(self.step, self.state, self.loader, **kw)


def _same_bits(a: TrainState, b: TrainState):
    assert a.step == b.step
    assert torch.equal(a.opt_state["count"], b.opt_state["count"])
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        for m in ("mu", "nu"):
            assert torch.equal(a.opt_state[m][name], b.opt_state[m][name]), (m, name)


def _flushes(summary):
    return [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
            for f in summary["flushes"]]


# ---------------------------------------------------------------------------
# Equivalence: the fused window does not change the math.
# ---------------------------------------------------------------------------


def test_fused_bit_identical_to_pipelined_and_scan(port_world, jax_params):
    s_pipe, sum_pipe = _Run(jax_params).loop(epochs=2, fuse=False, flush_every=4)
    s_scan, sum_scan = _Run(jax_params, scan_steps=2).loop(epochs=2, fuse=False)
    s_fused, sum_fused = _Run(jax_params).loop(epochs=2, fuse="window")
    _same_bits(s_pipe, s_fused)
    _same_bits(s_scan, s_fused)
    for key in ("updates", "epochs", "examples", "loss"):
        assert sum_fused[key] == sum_pipe[key], key
        if key != "loss":  # a scan step's flush loss means its last group
            assert sum_fused[key] == sum_scan[key], key
    # flush_every=50 clamps to the 4-batch epoch: one window per pass; the
    # pipelined run flushed at the same updates, with the same f32 sums.
    assert _flushes(sum_fused) == _flushes(sum_pipe)
    assert (sum_fused["fused_window"], sum_fused["dispatches"]) == (4, 2)
    assert (sum_pipe["fused_window"], sum_pipe["dispatches"]) == (None, 8)


def test_fused_scan_steps_step_is_subsumed(port_world, jax_params):
    s_pipe, _ = _Run(jax_params, scan_steps=2).loop(epochs=2, fuse=False)
    s_fused, summary = _Run(jax_params, scan_steps=2).loop(epochs=2, fuse="window",
                                                           flush_every=2)
    _same_bits(s_pipe, s_fused)
    assert (summary["fused_window"], summary["dispatches"]) == (2, 4)


def test_fused_window_on_the_cpu_runs_host_state_every_update(port_world, jax_params):
    """A loss_fn with host-side state (a Python counter scaling the loss):
    on the CPU a fused window runs eagerly, so the state advances at every
    update and the run equals the pipelined one bit for bit. (On the card
    a replay runs no Python: tests/test_torch_cuda.py pins that.)"""
    runs = {}
    for fuse in (False, "window"):
        run = _Run(jax_params)
        calls = [0]

        def loss_fn(p, ms, batch, run=run, calls=calls):
            calls[0] += 1
            x, y = batch
            return ((run.model(x) - y) ** 2).mean() * (1.0 + 0.5 * calls[0]), ms

        run.step = make_train_step(loss_fn, run.opt)
        state, summary = run.loop(epochs=3, flush_every=4, fuse=fuse)
        runs[fuse] = (state, summary, calls[0])
    (s_pipe, sum_pipe, n_pipe), (s_fused, sum_fused, n_fused) = runs.values()
    assert sum_fused["dispatches"] == 3 and sum_pipe["dispatches"] == 12
    assert n_fused == n_pipe == 12
    _same_bits(s_pipe, s_fused)
    assert _flushes(sum_fused) == _flushes(sum_pipe)


# ---------------------------------------------------------------------------
# Resolution: auto-enable, clamping, forced failures.
# ---------------------------------------------------------------------------


def test_fuse_auto_engages_and_falls_back_where_jax_does(port_world, jax_params,
                                                         monkeypatch):
    s = _Run(jax_params).loop(epochs=1)[1]
    assert (s["fused_window"], s["dispatches"]) == (4, 1)
    # The host path (device_gather=False): auto keeps the pipelined path.
    s = _Run(jax_params, device_gather=False).loop(epochs=1)[1]
    assert (s["fused_window"], s["dispatches"]) == (None, 4)
    # flush_every that does not divide the 4-batch epoch.
    assert _Run(jax_params).loop(epochs=1, flush_every=3)[1]["fused_window"] is None
    # A misaligned steps budget keeps its exact meaning.
    s = _Run(jax_params).loop(steps=10)[1]
    assert (s["updates"], s["fused_window"]) == (10, None)
    s = _Run(jax_params).loop(steps=8)[1]
    assert (s["updates"], s["fused_window"]) == (8, 4)
    # A scan step on an epoch its stacking would truncate (5 batches, k=2).
    s = _Run(jax_params, scan_steps=2, n=320).loop(epochs=1)[1]
    assert (s["fused_window"], s["updates"]) == (None, 4)
    s = _Run(jax_params, scan_steps=2, n=320).loop(epochs=1, fuse="window", flush_every=5)[1]
    assert (s["fused_window"], s["updates"]) == (5, 5)
    # Window-aligned but not scan-aligned steps: the scan rounds up to 8.
    s = _Run(jax_params, scan_steps=4).loop(steps=6, flush_every=2)[1]
    assert (s["fused_window"], s["updates"]) == (None, 8)
    s = _Run(jax_params, scan_steps=4).loop(steps=8, flush_every=2)[1]
    assert (s["fused_window"], s["updates"]) == (2, 8)
    # Over the staging budget: the host path, so no fused window.
    monkeypatch.setenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES", "16")
    s = _Run(jax_params).loop(epochs=1)[1]
    assert (s["fused_window"], s["updates"]) == (None, 4)
    monkeypatch.delenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES")
    # Several workers: each stages its own shard, and the budget counts
    # what this worker stages. Of 255 rows over 2 workers worker 0 holds
    # 128 (1024 bytes) and worker 1 127 (1016): under a budget of 1020
    # worker 0 declines, so auto falls back and a forced window raises.
    monkeypatch.setattr(tdata, "_world", lambda: (0, 2))
    monkeypatch.setenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES", "1020")
    cont = tfm.DistributedDataContainer(tfm.ArrayDataset(_data(255)), rank=0, world=2)
    run = _Run(jax_params)
    run.loader = tfm.DistributedDataLoader(cont, 128, device="cpu")
    assert not run.loader.fusible()
    assert "1024 bytes" in run.loader.fusible_declined()
    with pytest.raises(ValueError, match="device-gather"):
        run.loop(epochs=1, fuse="window")
    cont = tfm.DistributedDataContainer(tfm.ArrayDataset(_data(255)), rank=1, world=2)
    assert tfm.DistributedDataLoader(cont, 128, device="cpu").fusible()


def test_fuse_window_forced_raises_naming_the_reason(port_world, jax_params):
    run = _Run(jax_params)
    with pytest.raises(ValueError, match="not a DistributedDataLoader"):
        train_loop(run.step, run.state, iter(list(run.loader)), steps=2, fuse="window")
    host = _Run(jax_params, device_gather=False)
    with pytest.raises(ValueError, match="device-gather"):
        host.loop(epochs=1, fuse="window")
    with pytest.raises(ValueError, match="divide"):
        run.loop(epochs=1, fuse="window", flush_every=3)
    with pytest.raises(ValueError, match="fuse must be"):
        run.loop(epochs=1, fuse="sideways")
    with pytest.raises(ValueError, match="metadata"):
        train_loop(lambda s, b: (s, torch.zeros(())), run.state, run.loader,
                   epochs=1, fuse="window")
    # A plain function step under "auto" takes the pipelined path.
    _, s = train_loop(lambda s, b: (s, torch.zeros(())), run.state, run.loader, epochs=1)
    assert (s["fused_window"], s["dispatches"]) == (None, 4)


def test_make_window_program_validates(port_world, jax_params):
    run = _Run(jax_params)
    with pytest.raises(ValueError, match="width"):
        make_window_program(run.step, width=0, lbs=8)
    with pytest.raises(ValueError, match="make_train_step"):
        make_window_program(lambda s, b: (s, 0.0), width=2, lbs=8)


# ---------------------------------------------------------------------------
# Window-boundary flushes, budgets and the program cache.
# ---------------------------------------------------------------------------


def test_fused_flushes_at_window_granularity_and_rounds_steps_up(port_world,
                                                                 jax_params):
    _, s = _Run(jax_params).loop(epochs=3, flush_every=2)
    assert (s["updates"], s["fused_window"], s["dispatches"]) == (12, 2, 6)
    assert [f["updates"] for f in s["flushes"]] == [2, 4, 6, 8, 10, 12]
    for f in s["flushes"]:
        assert f["loss_max"] >= f["loss"] and f["loss_max"] >= f["loss_mean"] > 0
    assert s["loss"] == s["flushes"][-1]["loss"]
    # Whole windows only: 5 updates round up to 2 windows of 4.
    _, s = _Run(jax_params).loop(steps=5, fuse="window", flush_every=4)
    assert (s["updates"], s["dispatches"]) == (8, 2)


def test_fused_window_program_cache_survives_runs_and_keys_on_shapes(port_world,
                                                                      jax_params):
    run = _Run(jax_params)
    _, s1 = run.loop(epochs=1)
    cache = run.step.__fluxmpi_window_cache__
    (key,) = cache
    assert key[:2] == (4, 64) and s1["window_cache"] == {"hits": 0, "misses": 1}
    first = cache[key]
    run.loader = tfm.DistributedDataLoader(tfm.ArrayDataset(_data()), 64, shuffle=True,
                                           seed=11, device="cpu")
    _, s2 = run.loop(epochs=1)
    assert cache[key] is first and len(cache) == 1
    assert s2["window_cache"] == {"hits": 1, "misses": 0}
    # Another dataset size: another program, not run 1's.
    run.loader = tfm.DistributedDataLoader(tfm.ArrayDataset(_data(512)), 64, device="cpu")
    _, s3 = run.loop(epochs=1, fuse="window", flush_every=4)
    assert (s3["updates"], s3["fused_window"], len(cache)) == (8, 4, 2)


# ---------------------------------------------------------------------------
# Fault tolerance: resume (mid-window included) and preemption.
# ---------------------------------------------------------------------------


def test_fused_kill_and_resume_bit_identical(port_world, jax_params, tmp_path):
    """A pipelined run killed mid-epoch (its cursor lands inside a window)
    resumes fused: one short window realigns the grid, and the final state
    equals the uninterrupted run's bit for bit."""
    ref_state, ref_sum = _Run(jax_params).loop(steps=8, fuse=False)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with faults.scope("data.fetch@step=6"):
        with pytest.raises(tfm.FaultInjectedError):
            _Run(jax_params, prefetch=0).loop(steps=8, fuse=False, checkpoint=mgr,
                                              save_every=3)
    assert mgr.latest_step() == 3  # mid-epoch, not on the 4-batch window
    state, s = _Run(jax_params).loop(
        steps=8, fuse="window", flush_every=4,
        checkpoint=CheckpointManager(str(tmp_path / "run"), async_save=False),
        resume=True)
    assert (s["resumed_from"], s["updates"], s["fused_window"]) == (3, 8, 4)
    # Cursor 3: a 1-update window, then epoch 1 as one full window.
    assert s["dispatches"] == 2
    assert [f["updates"] for f in s["flushes"]] == [4, 8]
    _same_bits(state, ref_state)
    assert s["loss"] == ref_sum["loss"]


def test_fused_save_and_resume_fused_both_sides(port_world, jax_params, tmp_path):
    ref_state, _ = _Run(jax_params).loop(epochs=3, fuse="window", flush_every=2)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    _Run(jax_params).loop(steps=6, fuse="window", flush_every=2, checkpoint=mgr,
                          save_every=2)
    assert mgr.all_steps() == [2, 4, 6]
    state, s = _Run(jax_params).loop(epochs=3, fuse="window", flush_every=2,
                                     checkpoint=mgr, resume=True)
    assert (s["resumed_from"], s["updates"], s["epochs"], s["dispatches"]) == (6, 12, 3, 3)
    _same_bits(state, ref_state)


def test_fused_preemption_drains_at_window_boundary(port_world, jax_params, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    tfm.request_preemption()
    _, s = _Run(jax_params).loop(epochs=2, fuse="window", flush_every=2, checkpoint=mgr)
    # Honoured at the first window boundary: one window ran and was banked.
    assert (s["preempted"], s["updates"], mgr.latest_step()) == (True, 2, 2)
    tfm.clear_preemption()
    state, s2 = _Run(jax_params).loop(epochs=2, fuse="window", flush_every=2,
                                      checkpoint=mgr, resume=True)
    assert s2["updates"] == 8
    ref_state, _ = _Run(jax_params).loop(epochs=2, fuse="window", flush_every=2)
    _same_bits(state, ref_state)


# ---------------------------------------------------------------------------
# Loader surface: device_epoch and the budget's environment variable.
# ---------------------------------------------------------------------------


def test_device_epoch_matches_iteration_order(port_world, jax_params):
    a, b = _Run(jax_params).loader, _Run(jax_params).loader
    for _ in range(2):
        it_batches = [x.numpy() for x, _ in a]
        staged, perm, start = b.device_epoch()
        assert start == 0 and perm.dtype == torch.int32
        for i, ref in enumerate(it_batches):
            np.testing.assert_array_equal(staged[0][perm[i * 64:(i + 1) * 64].long()].numpy(),
                                          ref)
        b.note_consumed(len(it_batches))
        assert a.state_dict() == b.state_dict()
    host = _Run(jax_params, device_gather=False).loader
    assert not host.fusible()
    with pytest.raises(ValueError, match="device-gather"):
        host.device_epoch()
    # The host path yields the same batches as the device-gather path.
    np.testing.assert_array_equal(
        np.concatenate([x.numpy() for x, _ in host]),
        np.concatenate([x.numpy() for x, _ in _Run(jax_params).loader]))


def test_device_gather_budget_env_hardening(port_world, jax_params, monkeypatch):
    loader = _Run(jax_params).loader
    backing = loader._array_backing()
    monkeypatch.setenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES", "256MiB")
    with pytest.warns(UserWarning, match="not an integer"):
        assert loader._use_device_gather(backing) is True  # the default budget
    monkeypatch.setenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES", "16")
    assert loader._use_device_gather(backing) is False
    assert tdata._device_gather_budget() == 16


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


def test_fused_counters_batch_order_and_losses_match_jax(world, port_world, jax_params):
    x, y = _data()
    model = JaxMLP(features=FEATURES)

    def loss_fn(p, ms, b):
        bx, by = b
        return jnp.mean((model.apply(p, bx) - by) ** 2), ms

    opt = optax.adam(1e-3)
    jloader = jfm.DistributedDataLoader(jfm.ArrayDataset((x, y)), 64, mesh=world,
                                        shuffle=True, seed=11)
    records = []
    jstate, jsum = jax_train_loop(
        jax_make_train_step(loss_fn, opt, mesh=world),
        replicate(JaxTrainState.create(jax_params, opt), world), jloader,
        epochs=3, flush_every=2, fuse="window", metrics=records.append)
    run = _Run(jax_params)
    state, tsum = run.loop(epochs=3, flush_every=2, fuse="window")
    for key in ("updates", "epochs", "examples", "dispatches", "fused_window"):
        assert tsum[key] == jsum[key], key
    assert (tsum["updates"], tsum["dispatches"]) == (12, 6)
    # The batch order: each epoch's permutation, as the fused pass takes it.
    jl = jfm.DistributedDataLoader(jfm.ArrayDataset((x, y)), 64, mesh=world,
                                   shuffle=True, seed=11)
    tl = _Run(jax_params).loader
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(jax.device_get(jl.device_epoch()[1])),
                                      tl.device_epoch()[1].numpy())
    # Per-window losses and the final parameters, within f32 tolerance.
    assert len(records) == len(tsum["flushes"]) == 6
    for r, f in zip(records, tsum["flushes"]):
        np.testing.assert_allclose(f["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(f["loss_mean"], r["loss_window_mean"], rtol=1e-5)
        np.testing.assert_allclose(f["loss_max"], r["loss_window_max"], rtol=1e-5)
    got = to_flax_params(run.model)
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jstate.params)["params"])[0]:
        name = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(got[name], np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=name)
