"""ROADMAP C.19 and C.20: ``comm.shard_ranks``/``unshard_ranks`` and
``parallel.train.replicate``/``shard_batch`` in a real 2-rank gloo world
(``tests/_torch_seq_worker.py`` group ``surface``, spawned once), each
rank's result held to the JAX package's addressable shard on the same
mesh coordinate (JAX on 2 of its 8 CPU devices):

- ``shard_ranks`` of a stacked value, round-tripped through
  ``unshard_ranks``; ``allreduce`` and ``bcast`` of the laid-out value
  (the JAX package takes it as it is laid out); a second ``shard_ranks``
  of it returns it as it is;
- ``replicate`` of a nested tree;
- ``shard_batch`` with ``P("dp")``, ``P("dp", "sp")`` (both mesh shapes)
  and the plan's ``batch_spec``;
- the ``ValueError`` messages, word for word.

Collectives and cuts are exact.
"""

import json

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from _torch_worlds import join_world, start_world

WORLD = 2
CASES = {
    "ranks": dict(kind="ranks"),
    "replicate": dict(kind="replicate"),
    "batch_dp": dict(kind="batch", shape=[2], axes=["dp"], spec=["dp"]),
    "batch_default": dict(kind="batch", shape=[2], axes=["dp"], spec=[]),
    "batch_dp_sp": dict(kind="batch", shape=[1, 2], axes=["dp", "sp"], spec=["dp", "sp"]),
    "batch_dp_sp_2x1": dict(kind="batch", shape=[2, 1], axes=["dp", "sp"],
                            spec=["dp", "sp"]),
    "batch_plan": dict(kind="batch", spec="plan", plan=dict(sp=2)),
}

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = dict(stacked=rng.normal(size=(WORLD, 3, 2)).astype(np.float32),
             batch=rng.normal(size=(4, 6, 2)).astype(np.float32))
    path = tmp_path_factory.mktemp("surface") / "data.npz"
    np.savez(path, **d, cases=np.array(json.dumps(CASES)))
    return d, path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    return join_world(*start_world("surface", tmp_path_factory.mktemp("surfaceworld"),
                                   WORLD, data[1]))


def _mesh(shape, axes):
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(shape), tuple(axes))


def _shard(arr, r):
    (s,) = [s for s in arr.addressable_shards if s.device.id == r]
    return np.asarray(s.data)


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the message is compared
        return f"{type(exc).__name__}: {exc}"
    return ""


def test_shard_ranks_round_trips_and_lays_out_collectives_like_jax(world, ranks, data):
    from fluxmpi_tpu import comm

    d, _ = data
    mesh = _mesh([WORLD], ["dp"])
    laid = comm.shard_ranks(d["stacked"], mesh)
    summed = comm.allreduce(laid, mesh=mesh)
    top = comm.allreduce(laid, op="max", mesh=mesh)
    root1 = comm.bcast(laid, root=1, mesh=mesh)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["ranks/block"], _shard(laid, r))
        np.testing.assert_array_equal(res["ranks/whole"], comm.unshard_ranks(laid))
        np.testing.assert_allclose(res["ranks/allreduce"], _shard(summed, r), rtol=1e-6)
        np.testing.assert_array_equal(res["ranks/allreduce_whole"], comm.unshard_ranks(top))
        np.testing.assert_array_equal(res["ranks/bcast"], _shard(root1, r))
        assert bool(res["ranks/same"])
        assert str(res["ranks/raised"]) == _raised(
            lambda: comm.shard_ranks(d["stacked"][:1], mesh))


def test_replicate_puts_the_whole_value_on_every_worker(world, ranks, data):
    from fluxmpi_tpu.parallel.train import replicate

    d, _ = data
    out = replicate({"a": d["stacked"], "b": {"c": d["batch"]}}, _mesh([WORLD], ["dp"]))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["replicate/a"], _shard(out["a"], r))
        np.testing.assert_array_equal(res["replicate/c"], _shard(out["b"]["c"], r))


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("batch")])
def test_shard_batch_cuts_each_workers_block_like_jax(world, ranks, data, case):
    from fluxmpi_tpu.parallel import ParallelConfig
    from fluxmpi_tpu.parallel.train import shard_batch

    d, _ = data
    spec = CASES[case]
    if spec["spec"] == "plan":
        plan = ParallelConfig(**spec["plan"]).resolve(jax.devices()[:WORLD])
        mesh, bspec = plan.mesh, plan.batch_spec
    else:
        mesh = _mesh(spec["shape"], spec["axes"])
        bspec = P(*spec["spec"]) if spec["spec"] else None
    out = shard_batch({"x": d["batch"], "y": d["batch"][..., 0]}, mesh, spec=bspec)
    for r, res in enumerate(ranks):
        for k in ("x", "y"):
            np.testing.assert_array_equal(res[f"{case}/{k}"], _shard(out[k], r))
        assert str(res[f"{case}/raised"]) == _raised(
            lambda: shard_batch(d["batch"], mesh, "dp", spec=P("dp")))
