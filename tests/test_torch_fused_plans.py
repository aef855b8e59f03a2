"""One-program flush windows across workers under a dp x fsdp x tp plan
(``train_loop(fuse="auto")`` in a world of several workers whose plan
shards parameters), in 2- and 4-rank gloo worlds of
``tests/_torch_fused_plans_worker.py``, on the CPU, where a window runs
eagerly (on the cards each window is one CUDA graph per card, the fsdp
gathers, the bucketed gradient sums and the tensor-parallel all-reduces
inside: ``tests/test_torch_cuda.py``).

Model: the dense ``TransformerLM`` of ``tests/_torch_layout_worker.py``
(vocabulary 32, 2 layers of width 16, 4 heads so that tp=4 divides them,
``fsdp_min_size=64``), adamw(1e-3), 3 epochs of 4 global batches of 8 in
windows of 2. Plans: ``fsdp=2`` on 2 ranks; ``dp=2 x fsdp=2``,
``dp=2 x tp=2``, ``fsdp=2 x tp=2`` and ``tp=4`` on 4.

- Per plan, on every rank, fused against ``fuse=False`` bit for bit:
  every block, adamw moment and count, the flushes, ``updates``,
  ``dispatches == updates / width`` and ``fused_window == width``; the
  step's ``across_workers`` is None.
- Per plan, the fused run against the JAX package's
  ``train_loop(fuse="window")`` under the same ``ParallelConfig`` on as
  many CPU devices: per-window losses (last, mean, max) and every block,
  whose shape must equal JAX's addressable shard, within 2e-5 (f32, the
  tolerance of ``tests/test_torch_parallel_layouts.py``: an attention key
  bias, whose gradient is rounding noise that Adam normalizes, 6 x lr);
  the loader's rows against JAX's addressable shards; ``device_epoch()``
  against ``iter()`` at every cursor.
- Every process group a window uses exists once its eager first window
  ran: a 1-update window's second call, run under a pretended capture,
  asks for none (the tp blocks settled in the first update change the
  reduce buckets' groups), and a new subgroup asked for then raises,
  naming its axes.
- The model stats on the fsdp x tp plan, fused equal to pipelined at every
  flush.
- A fused fsdp=2 run killed inside a window, and a pipelined one killed
  mid-window, resume fused from their sharded checkpoints
  (``shard_<rank>.pt``) to the uninterrupted run's bits.
- A capture that fails on worker 1 alone raises on every worker, naming
  worker 1, within the world's own join limit; ep, sp and pp fuse across
  workers.
- ``shutdown()`` releases every captured graph before the process groups.
"""

from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.parallel import ParallelConfig as JaxParallelConfig
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop

from _torch_worlds import join_world, start_world

WORKER = Path(__file__).resolve().parent / "_torch_fused_plans_worker.py"
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=4, d_ff=32)
LR = 1e-3
ATOL = 2e-5
AGREE_TIMEOUT = 120
PLANS = {"fsdp": (2, dict(fsdp=2, fsdp_min_size=64)),
         "dp_fsdp": (4, dict(dp=2, fsdp=2, fsdp_min_size=64)),
         "dp_tp": (4, dict(dp=2, tp=2)),
         "fsdp_tp": (4, dict(fsdp=2, tp=2, fsdp_min_size=64)),
         "tp": (4, dict(tp=4))}


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    """The addressable shard of ``arr`` on device ``device_id``."""
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    params = JaxLM(**LM).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                              train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), params)
    rng = np.random.default_rng(0)
    d = dict(tokens=rng.integers(0, 32, (32, 8)).astype(np.int32),
             targets=rng.integers(0, 32, (32, 8)).astype(np.int32))
    path = tmp_path_factory.mktemp("fused_plans") / "data.npz"
    np.savez(path, **d, **{f"lmparams/{k}": v for k, v in _flat(params).items()})
    return dict(d, params=params, path=path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """The ``plans`` worlds at 2 and 4 ranks, started together: each rank's
    results."""
    started = {n: start_world("plans", tmp_path_factory.mktemp(f"plans{n}"), n,
                              data["path"], worker=WORKER) for n in (2, 4)}
    return {n: join_world(*w) for n, w in started.items()}


_JAX: dict = {}


def _jax_fused(data, case):
    """JAX's ``train_loop(fuse="window")`` under the plan of ``case``, once
    per module: ``(state, summary, flush records, loader rows)``."""
    if case not in _JAX:
        n, kw = PLANS[case]
        plan = JaxParallelConfig(**kw).resolve(jax.devices()[:n])
        model = JaxLM(**LM)

        def loss_fn(p, ms, batch):
            return jnp.mean(model.apply(p, batch["x"], train=False,
                                        targets=batch["y"])), ms

        opt = optax.adamw(LR)
        state, _ = plan.shard_state(JaxTrainState.create({"params": data["params"]}, opt))

        def loader():
            return jfm.DistributedDataLoader(
                jfm.ArrayDataset({"x": data["tokens"], "y": data["targets"]}), 8,
                mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True, seed=11)

        records = []
        state, summary = jax_train_loop(
            jax_make_train_step(loss_fn, opt, parallel=plan), state, loader(), epochs=3,
            flush_every=2, fuse="window", metrics=records.append)
        rows = [b["x"] for b in loader()]
        _JAX[case] = (state, summary, records, rows)
    return _JAX[case]


def _ranks(worlds, case):
    return worlds[PLANS[case][0]]


@pytest.mark.parametrize("case", sorted(PLANS))
def test_fused_plan_bit_identical_to_pipelined(worlds, case):
    """Under the plan ``fuse="auto"`` engages a 2-update window on every
    rank (4 batches an epoch, 3 epochs: 6 dispatches against 12) and ends
    on the pipelined run's bits."""
    for res in _ranks(worlds, case):
        assert str(res[f"{case}/across"]) == "None"
        assert int(res[f"{case}/same"]) == int(res[f"{case}/leaves"]) > 100, case
        np.testing.assert_array_equal(res[f"{case}/flushes_fused"],
                                      res[f"{case}/flushes_pipelined"], err_msg=case)
        for key in ("updates", "examples", "epochs"):
            assert res[f"{case}/{key}_fused"] == res[f"{case}/{key}_pipelined"], key
        assert int(res[f"{case}/fused_window"]) == 2
        assert int(res[f"{case}/fused_window_pipelined"]) == 0
        assert int(res[f"{case}/updates_fused"]) == 12
        assert int(res[f"{case}/dispatches_fused"]) == 12 // 2
        assert int(res[f"{case}/dispatches_pipelined"]) == 12


@pytest.mark.parametrize("case", sorted(PLANS))
def test_fused_plan_matches_jax_fused_window(world, worlds, data, case):
    """The port's fused run on every rank against JAX's
    ``train_loop(fuse="window")`` under the same plan: counters,
    per-window losses, every block (shape and values) on its mesh
    coordinate, and the loader's rows."""
    jstate, jsum, records, rows = _jax_fused(data, case)
    want = _flat(jstate.params["params"])
    for r, res in enumerate(_ranks(worlds, case)):
        for key in ("updates", "epochs", "dispatches", "fused_window"):
            assert int(res[f"{case}/{key}_fused" if key != "fused_window"
                           else f"{case}/fused_window"]) == jsum[key], key
        flushes = res[f"{case}/flushes_fused"]
        assert len(flushes) == len(records) == 6
        for f, rec in zip(flushes, records):
            np.testing.assert_allclose(f[1], rec["loss"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[2], rec["loss_window_mean"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[3], rec["loss_window_max"], atol=ATOL, rtol=0)
        for name, arr in want.items():
            got = res[f"{case}/param/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            atol = 6 * LR if name.endswith("attn/key/bias") else ATOL
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=f"{r} {name}")
        for b, batch in enumerate(rows):
            np.testing.assert_array_equal(res[f"{case}/rows"][b], _shard(batch, r))


@pytest.mark.parametrize("case", sorted(PLANS))
def test_device_epoch_follows_iteration_under_the_plan(worlds, case):
    """Workers sharing a data block (tp peers; under fsdp the dp x fsdp
    product cuts the rows) read the same rows in a window as ``iter()``
    yields them, from every cursor."""
    ranks = _ranks(worlds, case)
    for res in ranks:
        assert int(res[f"{case}/cursor_batches"]) == 4
        assert int(res[f"{case}/cursor_agree"]) == 4
    if case == "tp":  # one data block: every rank reads the same rows
        for res in ranks[1:]:
            np.testing.assert_array_equal(res["tp/rows"], ranks[0]["tp/rows"])


@pytest.mark.parametrize("case", sorted(PLANS))
def test_window_groups_exist_before_the_capture(worlds, case):
    """After a program's eager first window, a window run under a
    pretended capture asks for no new process group; a new subgroup asked
    for then raises, naming its axes."""
    for res in _ranks(worlds, case):
        assert str(res[f"{case}/pretend_capture"]) == "", res[f"{case}/pretend_capture"]
        err = str(res[f"{case}/new_group"])
        if case in ("fsdp", "tp"):  # no axis narrower than the world
            assert err == "no subgroup"
        else:
            assert "first requested while a CUDA graph was being captured" in err, err
            assert "mesh axes ('" in err


def test_model_stats_fused_equal_pipelined(worlds):
    """fsdp=2 x tp=2 with the model stats built in (depth 2): every flush's
    per-layer stats, computed by the window's last update inside the
    window, equal the pipelined flush's."""
    for res in worlds[4]:
        fused, pipe = res["fsdp_tp/stats_auto"], res["fsdp_tp/stats_pipelined"]
        assert len(fused) == len(pipe) == 6
        assert list(fused) == list(pipe)
        assert all("params/encoder" in s for s in fused)


def test_fused_fsdp_resume_from_sharded_checkpoints(worlds):
    for r, res in enumerate(worlds[2]):
        # Killed on the fifth update, inside the third window: the second
        # window's boundary (update 4) is banked, one shard file a worker.
        assert bool(res["kill_fused/raised"]) and int(res["kill_fused/banked"]) == 4
        assert set(res["kill_fused/shard_files"]) == {"shard_0.pt", "shard_1.pt"}
        assert (int(res["kill_fused/resumed_from"]), int(res["kill_fused/updates"]),
                int(res["kill_fused/fused_window"]), int(res["kill_fused/dispatches"])) == (
            4, 8, 2, 2)
        assert list(res["kill_fused/flush_updates"]) == [6, 8]
        assert int(res["kill_fused/same"]) == int(res["kill_fused/leaves"])
        # Banked at update 3: one 1-update realignment window, then whole ones.
        assert bool(res["kill_pipelined/raised"])
        assert int(res["kill_pipelined/banked"]) == 3
        assert (int(res["kill_pipelined/resumed_from"]),
                int(res["kill_pipelined/dispatches"])) == (3, 3)
        assert list(res["kill_pipelined/flush_updates"]) == [4, 6, 8]
        assert int(res["kill_pipelined/same"]) == int(res["kill_pipelined/leaves"])


def test_failed_capture_raises_on_every_worker(tmp_path, data):
    """Under its own join limit: a worker left replaying a graph whose
    collectives a failed peer never issues would fail the test instead of
    hanging it."""
    ranks = join_world(*start_world("agree", tmp_path, 2, data["path"], worker=WORKER),
                       timeout=AGREE_TIMEOUT)
    for res in ranks:
        err = str(res["capture/error"])
        assert "failed on worker 1 (" in err and "none replays" in err, err
        assert "stream is capturing" in err, err
        assert bool(res["capture/graph"])  # no worker keeps its graph
        # ep, sp and pp fuse across workers now: every plan axis does.
        assert str(res["ep/across"]) == str(res["sp/across"]) == "None"
        assert str(res["pp/across"]) == "None"


def test_shutdown_releases_captured_graphs_before_the_groups():
    """``shutdown()`` drops every CUDA graph of collectives captured since
    ``init`` before it destroys the process groups (a communicator torn
    down under a live graph that captured it hung a four-card world at
    exit); a released window program captures anew on its next call."""
    import fluxmpi_tpu_torch as tfm
    from fluxmpi_tpu_torch import runtime
    from fluxmpi_tpu_torch.parallel.train import WindowProgram

    order = []
    program = WindowProgram(lambda *a, **k: None, 2, 4, ("loss",), lambda *a: None)
    program.graph, program._bound = object(), (1,)
    release = program.release_graph
    program.release_graph = lambda: (order.append("released"), release())
    tfm.init(device="cpu")
    destroy = runtime.dist.destroy_process_group
    try:
        runtime.dist.destroy_process_group = lambda *a: (order.append("destroyed"),
                                                          destroy(*a))
        runtime.note_captured_graph(program)
        tfm.shutdown()
    finally:
        runtime.dist.destroy_process_group = destroy
    assert order[0] == "released" and program.graph is None and program._bound == ()
    assert not list(runtime._captured_graphs)
