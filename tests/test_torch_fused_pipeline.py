"""One-program flush windows across workers under the ``pp`` plan axis
(``train_loop(fuse="auto")`` in a world of several workers whose plan runs
a pipeline: its ticks, their point-to-point exchanges and their backward,
the pp axis's shard and unshard gathers, the stage leaves' gathers over tp
or ep and the stage blocks' gradient sums inside the update), in 2- and
4-rank gloo worlds of ``tests/_torch_fused_pipeline_worker.py``, on the
CPU, where a window runs eagerly (on the cards each window is one CUDA
graph per card with the whole schedule inside: ``tests/test_torch_cuda.py``).

The loss is ``tests/_torch_compose.py``'s pipeline loss, ``mean((pipe(x) @
head - y) ** 2)`` with ``pipe = make_pipeline_fn(gelu(x @ w + b), ...)``
over 4 microbatches, sgd(0.1), 2 epochs of 4 global batches of 8 in
windows of 2. Plans: on 2 ranks ``pp=2`` (GPipe), ``pp=2`` with
``interleave=2`` and ``pp=2`` with ``remat_stages=True``; on 4 ranks
``dp=2 x pp=2``, ``pp=2 x tp=2`` and ``pp=2 x ep=2`` (each stage leaf's
last dim laid over tp or ep as well, so the step gathers the stage leaves
over that axis), ``pp=2 x sp=2`` (the loss gets whole sequences) and
``pp=4``.

- Per plan, on every rank, fused against ``fuse=False`` bit for bit:
  every block, the flushes, ``updates``, ``dispatches == updates /
  width`` and ``fused_window == width``; the step's ``across_workers`` is
  None; the pipeline makes ``2 x (pipeline_tick_count - 1)`` exchanges an
  update on both paths (bubble ticks exchange too; as many in the
  backward as in the forward).
- Per plan, the fused run against the JAX package's
  ``train_loop(fuse="window")`` under the same ``ParallelConfig`` on as
  many CPU devices (JAX's fused path takes every one of these plans):
  per-window losses (last, mean, max) and every block, whose shape must
  equal JAX's addressable shard, within 2e-5 (the tolerance
  ``tests/test_torch_sequence_step.py`` holds these plans to); the
  loader's rows against JAX's addressable shards, and ``device_epoch()``
  against ``iter()`` at every cursor in the loader's three views (the
  dataset, a ``DistributedDataContainer``, ``elastic_order=True``), the
  pp workers of one dp replica reading the same rows.
- Every subgroup a window uses is warmed once its eager first window ran:
  a 1-update window's second call, run under a pretended capture, asks
  for none that nobody warmed (the pp axis's and, under ``dp=2 x pp=2``,
  ``pp=2 x tp=2`` and ``pp=2 x ep=2``, the other axis's among those warmed
  on 4 ranks); a made but unwarmed pp subgroup asked for then raises.
- A fused ``dp=2 x pp=2`` run killed inside a window resumes fused from
  its sharded checkpoint (``shard_<rank>.pt``) to the uninterrupted run's
  bits.
"""

import json
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import _torch_compose as compose
from _torch_worlds import join_world, start_world

WORKER = Path(__file__).resolve().parent / "_torch_fused_pipeline_worker.py"
LR = 0.1
ATOL = 2e-5
ROWS, MICROBATCHES = 32, 4
CASES = {
    2: {"pp": dict(plan=dict(pp=2), w="pp"),
        "pp_interleave": dict(plan=dict(pp=2), w="pp2", interleave=2),
        "pp_remat": dict(plan=dict(pp=2), w="pp", remat=True)},
    4: {"pp_dp": dict(plan=dict(dp=2, pp=2), w="pp"),
        "pp_tp": dict(plan=dict(pp=2, tp=2), w="pp", stage_axis="tp"),
        "pp_ep": dict(plan=dict(pp=2, ep=2), w="pp", stage_axis="ep"),
        "pp_sp": dict(plan=dict(pp=2, sp=2), w="pp"),
        "pp4": dict(plan=dict(pp=4), w="pp4")},
}
ALL = [(n, c) for n in (2, 4) for c in CASES[n]]
# The subgroups each 4-rank case's update runs a collective over (by the
# mesh axes they span; the plan's mesh keeps a dp axis of size 1).
WARMED = {"pp_dp": {"pp", "dp"}, "pp_tp": {"pp", "tp"}, "pp_ep": {"pp", "ep"},
          "pp_sp": {"pp", "dp,sp"}}
VIEWS = ("array", "container", "elastic")


def _ids(pairs):
    return [f"{n}-{c}" for n, c in pairs]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    """The addressable shard of ``arr`` on device ``device_id``."""
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.parallel.pipeline import stack_stage_params

    rng = np.random.default_rng(0)
    d = compose.pp_data(rng)
    d["pp_x"], d["pp_y"] = d["pp_x"][:ROWS], d["pp_y"][:ROWS]
    st = stack_stage_params([{"w": (0.5 * rng.normal(size=(8, 8))).astype(np.float32),
                              "b": rng.normal(size=(8,)).astype(np.float32)}
                             for _ in range(4)])
    d["pp4_w"], d["pp4_b"] = np.asarray(st["w"]), np.asarray(st["b"])
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"fused_pipeline{n}") / "data.npz"
        np.savez(path, **d, cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    return dict(d, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """The ``plans`` worlds at 2 and 4 ranks, started together, JAX's
    references computed while they run: each rank's results."""
    started = {n: start_world("plans", tmp_path_factory.mktemp(f"pipe{n}"), n,
                              data["paths"][n], worker=WORKER) for n in (2, 4)}
    try:
        for n, case in ALL:
            _jax_fused(data, n, case)
    finally:
        joined = {n: join_world(*w) for n, w in started.items()}
    return joined


_JAX: dict = {}


def _jax_fused(data, n, case):
    """JAX's ``train_loop(fuse="window")`` under the case's plan on ``n``
    of its CPU devices: ``(state, summary, flush records, loader rows)``."""
    import fluxmpi_tpu as jfm
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step, train_loop
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn

    if (n, case) in _JAX:
        return _JAX[(n, case)]
    spec = CASES[n][case]
    extra = spec.get("stage_axis")

    def rule(path, shape):
        if "stages" not in path:
            return jax.sharding.PartitionSpec()
        tail = [None] * (len(shape) - 1)
        if extra is not None:
            tail[-1] = extra
        return jax.sharding.PartitionSpec("pp", *tail)

    plan = ParallelConfig(**spec["plan"], rules=rule).resolve(jax.devices()[:n])
    pipe = make_pipeline_fn(compose._stage_fn, plan.mesh, n_microbatches=MICROBATCHES,
                            axis_name="pp", interleave=spec.get("interleave", 1),
                            remat_stages=spec.get("remat", False))
    w = spec["w"]
    params = {"stages": {"w": data[f"{w}_w"], "b": data[f"{w}_b"]}, "head": data["pp_head"]}

    def loss_fn(p, ms, batch):
        y = pipe(p["stages"], batch["x"])
        return jnp.mean((y @ p["head"] - batch["y"]) ** 2), ms

    opt = optax.sgd(LR)
    state, _ = plan.shard_state(TrainState.create(params, opt))

    def loader():
        return jfm.DistributedDataLoader(
            jfm.ArrayDataset({"x": data["pp_x"], "y": data["pp_y"]}), 8,
            mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True, seed=11)

    records = []
    state, summary = train_loop(make_train_step(loss_fn, opt, parallel=plan), state,
                                loader(), epochs=2, flush_every=2, fuse="window",
                                metrics=records.append)
    _JAX[(n, case)] = (state, summary, records, [b["x"] for b in loader()])
    return _JAX[(n, case)]


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_fused_pipeline_bit_identical_to_pipelined(worlds, n, case):
    """Under the plan ``fuse="auto"`` engages a 2-update window on every
    rank (4 batches an epoch, 2 epochs: 4 dispatches against 8), ends on
    the pipelined run's bits, and makes the schedule's exchanges."""
    from fluxmpi_tpu_torch.parallel import pipeline_tick_count

    spec = CASES[n][case]
    ticks = pipeline_tick_count(MICROBATCHES, spec["plan"]["pp"], spec.get("interleave", 1))
    for res in worlds[n]:
        assert str(res[f"{case}/across"]) == "None"
        # The stacked stages' w and b and the head (sgd keeps no state).
        assert int(res[f"{case}/same"]) == int(res[f"{case}/leaves"]) == 3, case
        np.testing.assert_array_equal(res[f"{case}/flushes_fused"],
                                      res[f"{case}/flushes_pipelined"], err_msg=case)
        for key in ("updates", "examples", "epochs"):
            assert res[f"{case}/{key}_fused"] == res[f"{case}/{key}_pipelined"], key
        assert int(res[f"{case}/fused_window"]) == 2
        assert int(res[f"{case}/fused_window_pipelined"]) == 0
        assert int(res[f"{case}/updates_fused"]) == 8
        assert int(res[f"{case}/dispatches_fused"]) == 8 // 2
        assert int(res[f"{case}/dispatches_pipelined"]) == 8
        assert list(res[f"{case}/exchanges"]) == [8 * 2 * (ticks - 1)] * 2, case


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_fused_pipeline_matches_jax_fused_window(worlds, data, n, case):
    """The port's fused run on every rank against JAX's
    ``train_loop(fuse="window")`` under the same plan: counters,
    per-window losses, every block (shape and values) on its mesh
    coordinate, and the loader's rows."""
    jstate, jsum, records, rows = _jax_fused(data, n, case)
    assert jsum["fused_window"] == 2  # JAX fuses the plan too
    want = _flat(jstate.params)
    for r, res in enumerate(worlds[n]):
        for key in ("updates", "epochs", "dispatches"):
            assert int(res[f"{case}/{key}_fused"]) == jsum[key], key
        flushes = res[f"{case}/flushes_fused"]
        assert len(flushes) == len(records) == 4
        for f, rec in zip(flushes, records):
            np.testing.assert_allclose(f[1], rec["loss"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[2], rec["loss_window_mean"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[3], rec["loss_window_max"], atol=ATOL, rtol=0)
        for name, arr in want.items():
            got = res[f"{case}/param/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{r} {name}")
        for b, batch in enumerate(rows):
            np.testing.assert_array_equal(res[f"{case}/rows/array"][b], _shard(batch, r))


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_device_epoch_follows_iteration_in_every_view(worlds, n, case):
    """Every pp worker of one dp replica reads the same rows in a window as
    ``iter()`` yields them, from every cursor, in the loader's three views;
    the views read alike."""
    ranks = worlds[n]
    for res in ranks:
        assert int(res[f"{case}/cursor_batches"]) == 4
        for view in VIEWS:
            assert int(res[f"{case}/cursor_agree/{view}"]) == 4, view
            np.testing.assert_array_equal(res[f"{case}/rows/{view}"],
                                          res[f"{case}/rows/array"])
    for res in ranks[1:]:
        peer = next(r for r in ranks if int(r[f"{case}/dp_index"])
                    == int(res[f"{case}/dp_index"]))
        np.testing.assert_array_equal(res[f"{case}/rows/array"], peer[f"{case}/rows/array"])
    if "dp" in CASES[n][case]["plan"]:
        blocks = {int(r[f"{case}/dp_index"]) for r in ranks}
        assert blocks == {0, 1}
        a, b = (next(r for r in ranks if int(r[f"{case}/dp_index"]) == i) for i in (0, 1))
        assert not np.array_equal(a[f"{case}/rows/array"], b[f"{case}/rows/array"])


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_window_groups_warmed_before_the_capture(worlds, n, case):
    """After a program's eager first window, a window run under a
    pretended capture asks for no subgroup that was not warmed. On 4 ranks
    the subgroups warmed include the pp axis's (the pipeline's shard and
    unshard gathers) and the other axis's (the stage blocks' gradient sums,
    the stage leaves' gathers over tp or ep, the batch axes); the
    exchanges run point to point over the world's communicator. On 2 ranks,
    and under ``pp=4``, every group is the world's."""
    for res in worlds[n]:
        assert str(res[f"{case}/pretend_capture"]) == "", res[f"{case}/pretend_capture"]
        warmed = set(res[f"{case}/warmed"].tolist())
        assert WARMED.get(case, set()) <= warmed, (case, warmed)
        if n == 2 or case == "pp4":
            assert warmed == set()


def test_unwarmed_pp_subgroup_refused_under_capture(worlds):
    for res in worlds[4]:
        err = str(res["unwarmed/error"])
        assert "mesh axes ('pp',)" in err and "no window program warmed it" in err, err


def test_fused_dp_pp_resume_from_sharded_checkpoints(worlds):
    for res in worlds[4]:
        # Killed on the fifth update, inside the third window: the second
        # window's boundary (update 4) is banked, one shard file a worker.
        assert bool(res["kill/raised"]) and int(res["kill/banked"]) == 4
        assert set(res["kill/shard_files"]) == {f"shard_{r}.pt" for r in range(4)}
        assert (int(res["kill/resumed_from"]), int(res["kill/updates"]),
                int(res["kill/fused_window"]), int(res["kill/dispatches"])) == (4, 8, 2, 2)
        assert list(res["kill/flush_updates"]) == [6, 8]
        assert int(res["kill/same"]) == int(res["kill/leaves"])
