"""One-program flush windows across workers (``train_loop(fuse="auto")`` in
a world of several data-parallel workers) in 2- and 4-rank gloo worlds of
``tests/_torch_fused_world_worker.py``, on the CPU, where a window runs
eagerly (on the cards each window is one CUDA graph per card:
``tests/test_torch_cuda.py``).

- ``device_epoch()`` against ``iter()`` at every cursor, resumed ones
  included, in the three views below.
- Fused against pipelined, bit for bit on every rank, in the loader's
  three views (a container's shard, the mesh view, ``elastic_order``) for
  the quick-start MLP and a Conv+BN CNN (``axis_name=None``: BatchNorm's
  statistics over the batch axes inside the window): parameters, adam
  moments and count, the statistics, the flushes, ``updates``,
  ``examples``, ``epochs``, and ``dispatches == updates / width``.
- The mesh view against JAX's ``train_loop(fuse="window")`` over as many
  CPU devices: the same counters (a worker counts its own rows of the
  examples), the same sample order (each epoch's
  permutation, the ranks' slices put together), and per-window losses and
  final parameters within 2e-5 (f32: the same arithmetic, sums in other
  orders).
- A pipelined run killed inside a window resumes fused (one short
  realignment window) to the uninterrupted run's bits; a preemption
  requested on worker 0 alone drains every worker at one window boundary
  (async saves), and the resume ends on the uninterrupted fused run's
  bits.
- Agreement, in a world with its own time limit, so a hang fails it: a
  shard over the staging budget on one worker alone and a
  ``style="shard_map"`` step leave every worker pipelined, and
  ``fuse="window"`` raises the reason on every worker; a dp x pp plan
  fuses on every worker, and so does a step under host-staged collectives
  (bit for bit with ``fuse=False``, the flushes' agreement through the
  host), as JAX's ``train_loop(fuse="window")`` fuses over two CPU devices
  with ``disable_device_collectives`` set.
"""

from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import fluxmpi_tpu as jfm
from fluxmpi_tpu import config as jconfig
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate

from _torch_worlds import join_world, start_world

WORKER = Path(__file__).resolve().parent / "_torch_fused_world_worker.py"
FEATURES = (16, 16, 1)
ATOL = 2e-5
AGREE_TIMEOUT = 120


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(256, 1)).astype(np.float32)
    params = JaxMLP(features=FEATURES).init(jax.random.PRNGKey(0), jnp.zeros((2, 1)))
    params = jax.tree_util.tree_map(np.asarray, params)
    cx = rng.normal(size=(64, 8, 8, 1)).astype(np.float32)
    cy = rng.integers(0, 4, size=(64,)).astype(np.int32)
    path = tmp_path_factory.mktemp("fused_world") / "data.npz"
    np.savez(path, x=x, y=x ** 2, cnn_x=cx, cnn_y=cy,
             **{f"mlp/{k}": v for k, v in _flat(params["params"]).items()})
    return {"path": path, "x": x, "y": x ** 2, "params": params}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """The ``views`` worlds at 2 and 4 ranks and the ``resume`` world at
    2, started together: each rank's results."""
    started = {}
    for name, group, n in (("views2", "views", 2), ("views4", "views", 4),
                           ("resume2", "resume", 2)):
        tmp = tmp_path_factory.mktemp(name)
        started[name] = start_world(group, tmp, n, data["path"], worker=WORKER)
    return {name: join_world(*w) for name, w in started.items()}


def _check_bits(res, case):
    assert int(res[f"{case}/same"]) == int(res[f"{case}/leaves"]), case
    np.testing.assert_array_equal(res[f"{case}/flushes_fused"],
                                  res[f"{case}/flushes_pipelined"], err_msg=case)
    for key in ("updates", "examples", "epochs"):
        assert res[f"{case}/{key}_fused"] == res[f"{case}/{key}_pipelined"], (case, key)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("view", ["shard", "mesh", "elastic"])
def test_fused_across_workers_bit_identical_to_pipelined(worlds, n, model, view):
    """``fuse="auto"`` engages a 2-update window on every rank (4 batches
    an epoch, 2 epochs: 4 dispatches against 8) and ends on the pipelined
    run's bits."""
    case = f"{model}_{view}"
    for res in worlds[f"views{n}"]:
        _check_bits(res, case)
        assert int(res[f"{case}/fused_window"]) == 2, case
        assert int(res[f"{case}/fused_window_pipelined"]) == 0, case
        assert int(res[f"{case}/updates_fused"]) == 8
        assert int(res[f"{case}/dispatches_fused"]) == 8 // 2
        assert int(res[f"{case}/dispatches_pipelined"]) == 8


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("view", ["shard", "mesh", "elastic"])
def test_device_epoch_follows_iteration_at_every_cursor(worlds, n, view):
    """The permutation ``device_epoch()`` hands the window lists, from any
    resume cursor on, this worker's batches as ``iter()`` yields them."""
    for res in worlds[f"views{n}"]:
        assert int(res[f"cursor_{view}/batches"]) == 4
        assert int(res[f"cursor_{view}/agree"]) == 4


def _jax_fused(data, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    model = JaxMLP(features=FEATURES)

    def loss_fn(p, ms, b):
        bx, by = b
        return jnp.mean((model.apply(p, bx) - by) ** 2), ms

    opt = optax.adam(1e-3)
    loader = jfm.DistributedDataLoader(jfm.ArrayDataset((data["x"], data["y"])), 64,
                                       mesh=mesh, shuffle=True, seed=11)
    records = []
    state, summary = jax_train_loop(
        jax_make_train_step(loss_fn, opt, mesh=mesh),
        replicate(JaxTrainState.create(data["params"], opt), mesh), loader,
        epochs=3, flush_every=2, fuse="window", metrics=records.append)
    perms = jfm.DistributedDataLoader(jfm.ArrayDataset((data["x"], data["y"])), 64,
                                      mesh=mesh, shuffle=True, seed=11)
    order = [np.asarray(jax.device_get(perms.device_epoch()[1])) for _ in range(3)]
    return state, summary, records, order


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_view_fused_matches_jax_fused_window(world, worlds, data, n):
    """The port's fused mesh-view run on every rank against JAX's
    ``train_loop(fuse="window")`` on ``n`` CPU devices."""
    jstate, jsum, records, order = _jax_fused(data, n)
    ranks = worlds[f"views{n}"]
    # The sample order: rank r's permutation holds its slice of every
    # global batch; put together they are JAX's global permutation.
    lbs = 64 // n
    perms = np.stack([r["jax_mesh/perms"] for r in ranks])  # [n, epochs, rows]
    for e in range(3):
        nb = perms.shape[2] // lbs
        glued = perms[:, e].reshape(n, nb, lbs).transpose(1, 0, 2).reshape(-1)
        np.testing.assert_array_equal(glued, order[e][:glued.size])
    want = _flat(jax.device_get(jstate.params)["params"])
    for res in ranks:
        for key in ("updates", "epochs", "dispatches", "fused_window"):
            assert int(res[f"jax_mesh/{key}"]) == jsum[key], key
        # Each worker counts its own rows; JAX's one process the global batch.
        assert int(res["jax_mesh/examples"]) * n == jsum["examples"]
        flushes = res["jax_mesh/flushes"]
        assert len(flushes) == len(records) == 6
        for f, r in zip(flushes, records):
            np.testing.assert_allclose(f[1], r["loss"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[2], r["loss_window_mean"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[3], r["loss_window_max"], atol=ATOL, rtol=0)
        for name, w in want.items():
            np.testing.assert_allclose(res[f"jax_mesh/param/{name.replace('/', '.')}"], w,
                                       atol=ATOL, rtol=0, err_msg=name)


def test_jax_fuses_across_devices_under_host_staging(world, data, monkeypatch):
    """The JAX package reads ``disable_device_collectives`` in its eager
    collectives only: its ``train_loop(fuse="window")`` fuses over two CPU
    devices with the flag set, to the bits it reaches without it (the
    port follows, ROADMAP C.33)."""
    want, wsum, wrec, _ = _jax_fused(data, 2)
    monkeypatch.setattr(jconfig, "DEVICE_COLLECTIVES_DISABLED", True)
    got, gsum, grec, _ = _jax_fused(data, 2)
    for key in ("fused_window", "dispatches", "updates"):
        assert gsum[key] == wsum[key], key
    assert gsum["fused_window"] == 2
    assert [r["loss"] for r in grec] == [r["loss"] for r in wrec]
    for name, w in _flat(jax.device_get(want.params)["params"]).items():
        np.testing.assert_array_equal(
            _flat(jax.device_get(got.params)["params"])[name], w, err_msg=name)


def test_fused_resume_and_preemption_across_workers(worlds):
    for res in worlds["resume2"]:
        assert bool(res["kill/raised"]) and int(res["kill/banked"]) == 3
        assert (int(res["kill/resumed_from"]), int(res["kill/updates"]),
                int(res["kill/fused_window"])) == (3, 8, 4)
        # Cursor 3: a 1-update realignment window, then one full window.
        assert int(res["kill/dispatches"]) == 2
        assert list(res["kill/flush_updates"]) == [4, 8]
        assert int(res["kill/same"]) == int(res["kill/leaves"])
        # Worker 0's request stops both at the first window boundary.
        assert bool(res["preempt/preempted"])
        assert (int(res["preempt/updates"]), int(res["preempt/fused_window"]),
                int(res["preempt/banked"])) == (2, 2, 2)
        assert (int(res["preempt/resumed_updates"]),
                int(res["preempt/resumed_fused_window"])) == (8, 2)
        assert int(res["preempt/same"]) == int(res["preempt/leaves"])


def test_declines_are_agreed_on_every_worker(tmp_path, data):
    """Under its own join limit: a rank left waiting in a collective its
    peer never issues would fail the test instead of hanging it."""
    ranks = join_world(*start_world("agree", tmp_path, 2, data["path"], worker=WORKER),
                       timeout=AGREE_TIMEOUT)
    # Worker 0's shard (128 rows) is over the budget, worker 1's (127) not.
    assert [bool(r["budget/fusible"]) for r in ranks] == [False, True]
    reasons = {"budget": ("on worker 0", "over FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES"),
               "shard_map": ("on worker 0", 'style="shard_map"')}
    for res in ranks:
        for case, words in reasons.items():
            assert int(res[f"{case}/fused_window"]) == 0, case
            err = str(res[f"{case}/error"])
            assert err.startswith('fuse="window" unavailable'), (case, err)
            assert all(w in err for w in words), (case, err)
        assert int(res["budget/dispatches"]) == 3
        # The dp x pp plan fuses on every worker (every plan axis does):
        # 4 batches in 2 windows, and fuse="window" raises nothing.
        assert (int(res["plan/fused_window"]), int(res["plan/dispatches"])) == (2, 2)
        assert str(res["plan/error"]) == ""
        # Host staging stages the eager collectives only (ROADMAP C.33): the
        # MLP fuses on every worker, bit for bit with fuse=False, and the
        # flushes agree over the host (one all-reduce each, and the loop's
        # first).
        assert (int(res["staged/fused_window"]), int(res["staged/dispatches"])) == (2, 2)
        assert str(res["staged/error"]) == ""
        assert int(res["staged/run_fused_window"]) == 2
        assert int(res["staged/same"]) == int(res["staged/leaves"])
        assert bool(res["staged/flushes_equal"])
        assert str(res["staged/paths"]) == "host"
        assert int(res["staged/allreduce_calls"]) >= 2 * int(res["staged/flushes"])
