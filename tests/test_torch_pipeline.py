"""GPipe pipeline parallelism in real 2- and 4-rank gloo worlds (the ranks
run ``tests/_torch_seq_worker.py`` group ``pipeline``, each world spawned
once and running all of its cases), held to the JAX package's
``fluxmpi_tpu.parallel.pipeline`` over as many of its 8 CPU devices, from
the same numpy stages and inputs:

- ``make_pipeline_fn`` (GPipe; a microbatch count that pads the grid;
  ``remat_stages``; the interleaved schedule, ``interleave`` 2 and 3; an
  ``EncoderBlock`` stage from stacked flax trees): the global output and
  the gradients of the stacked parameters and of ``x`` of ``sum(sin(y))``
  on every rank, against JAX's ``make_pipeline_fn``;
- ``pipeline_apply`` on each rank's stage block, with the input
  replicated (``input_sharded=False``) and over a dp x pp mesh
  (``input_sharded=True``, the batch over both axes): each rank's output
  block against JAX's ``shard_map`` of the same body, and the gradients,
  summed over the ranks, against JAX's;
- ``pipeline_tick_count`` for M in {1, 2, 4, 8, 16}, ``stack_stage_params``'
  round-robin order, ``pipeline_rules`` and the refusals, in one process.

Tolerances (f32): outputs max|Δ| 3e-5, gradients 1e-4.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from _torch_worlds import join_world, start_world

OUT_ATOL = 3e-5
GRAD_ATOL = 1e-4
D = 8

torch.set_num_threads(1)


def _wrapper(stages, x, m, n_stages=None, **kw):
    return dict(kind="wrapper", stages=stages, x=x, m=m, n_stages=n_stages, kw=kw)


def _apply(stages, x, m, mesh, axes, **kw):
    return dict(kind="apply", stages=stages, x=x, m=m, mesh=mesh, axes=axes, kw=kw)


CASES = {
    4: {
        "gpipe": _wrapper("s4", "x8", 4),
        "gpipe_m3": _wrapper("s4", "x6", 3),
        "remat": _wrapper("s4", "x8", 4, remat_stages=True),
        "interleave": _wrapper("s8", "x8", 4, n_stages=4, interleave=2),
        "interleave_m8": _wrapper("s8", "x16", 8, n_stages=4, interleave=2),
        "replicated": _apply("s4", "x8", 4, [4], ["pp"], input_sharded=False),
        "dp_pp": _apply("s2", "x8", 2, [2, 2], ["dp", "pp"], input_sharded=True),
    },
    2: {
        "gpipe": _wrapper("s2", "x8", 4),
        "interleave3": _wrapper("s6", "x4", 2, n_stages=2, interleave=3),
        "remat_interleave": _wrapper("s4", "x8", 4, n_stages=2, interleave=2,
                                     remat_stages=True),
        "replicated": _apply("s2", "x6", 3, [2], ["pp"], input_sharded=False),
        "block": dict(kind="block", x="blk_x", m=2, kw={}),
    },
}


def _stage_fn(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.models.transformer import EncoderBlock

    rng = np.random.default_rng(0)
    d = {}
    for n in (2, 4, 6, 8):
        d[f"s{n}_w"] = rng.normal(scale=0.5, size=(n, D, D)).astype(np.float32)
        d[f"s{n}_b"] = rng.normal(size=(n, D)).astype(np.float32)
    for n in (4, 6, 8, 16):
        d[f"x{n}"] = rng.normal(size=(n, D)).astype(np.float32)
    block = EncoderBlock(d_model=16, num_heads=2, d_ff=32, dropout=0.0, dtype=jnp.float32)
    d["blk_x"] = rng.normal(size=(4, 8, 16)).astype(np.float32)
    trees = [block.init(jax.random.PRNGKey(i), jnp.asarray(d["blk_x"]), train=False)["params"]
             for i in range(2)]
    # Off their init (zero biases, unit scales): every gradient is live.
    trees = [jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), tr)
        for tr in trees]
    blk = {f"blk/{k}": np.stack([_flat(tr)[k] for tr in trees]) for k in _flat(trees[0])}
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"pipe{n}") / "data.npz"
        np.savez(path, **d, **blk, cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    return dict(d, blk=blk, trees=trees, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world("pipeline", tmp_path_factory.mktemp(f"pipeworld{n}"), n,
                              data["paths"][n]) for n in (4, 2)}
    return {n: join_world(*started[n]) for n in (4, 2)}


def _stacked(data, spec):
    from fluxmpi_tpu.parallel.pipeline import stack_stage_params

    name = spec["stages"]
    chunks = [{"w": jnp.asarray(data[f"{name}_w"][i]), "b": jnp.asarray(data[f"{name}_b"][i])}
              for i in range(data[f"{name}_w"].shape[0])]
    return stack_stage_params(chunks, n_stages=spec["n_stages"] if "n_stages" in spec
                              else None, interleave=spec["kw"].get("interleave", 1))


def _jax_ref(data, n, case):
    """JAX's ``(y, grads of the stacked tree, grad of x)`` of
    ``sum(sin(y))``."""
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn, pipeline_apply

    spec = CASES[n][case]
    kw = dict(spec["kw"])
    x = jnp.asarray(data[spec["x"]])
    if spec["kind"] == "block":
        from fluxmpi_tpu.models.transformer import EncoderBlock
        from fluxmpi_tpu.parallel.pipeline import stack_stage_params

        block = EncoderBlock(d_model=16, num_heads=2, d_ff=32, dropout=0.0,
                             dtype=jnp.float32)
        stacked = stack_stage_params(data["trees"])
        fn = make_pipeline_fn(lambda p, h: block.apply({"params": p}, h, train=False),
                              Mesh(np.asarray(jax.devices()[:n]), ("pp",)),
                              n_microbatches=spec["m"])
    elif spec["kind"] == "wrapper":
        stacked = _stacked(data, spec)
        fn = make_pipeline_fn(_stage_fn, Mesh(np.asarray(jax.devices()[:n]), ("pp",)),
                              n_microbatches=spec["m"], **kw)
    else:
        stacked = _stacked(data, spec)
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(spec["mesh"]), tuple(spec["axes"]))
        xspec = JP(tuple(spec["axes"])) if kw.get("input_sharded") else JP()
        fn = jax.jit(shard_map_unchecked(
            lambda p, xx: pipeline_apply(_stage_fn, p, xx, n_microbatches=spec["m"],
                                         axis_name="pp", **kw),
            mesh, in_specs=(JP("pp"), xspec), out_specs=JP(tuple(spec["axes"]))))
    y, vjp = jax.vjp(fn, stacked, x)
    gp, gx = vjp(jnp.cos(y))
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("n,case", [(n, c) for n in (4, 2) for c in CASES[n]],
                         ids=[f"{n}-{c}" for n in (4, 2) for c in CASES[n]])
def test_pipeline_equals_jax(world, worlds, data, n, case):
    spec = CASES[n][case]
    y, gp, gx = _jax_ref(data, n, case)
    ranks = worlds[n]
    if spec["kind"] == "apply":
        # Each rank's output block; the gradients summed over the ranks
        # (each rank's loss is its block's).
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"{case}/out"], np.split(y, n)[r],
                                       atol=OUT_ATOL, rtol=0, err_msg=f"rank {r}")
        got = {k: sum(res[f"{case}/{k}"] for res in ranks) for k in ("gw", "gb", "gx")}
        for k, ref in (("gw", gp["w"]), ("gb", gp["b"]), ("gx", gx)):
            np.testing.assert_allclose(got[k], ref, atol=GRAD_ATOL, rtol=0, err_msg=k)
        return
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{case}/out"], y, atol=OUT_ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res[f"{case}/gx"], gx, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"rank {r} gx")
        want = ({f"g/{k.replace('/', '.')}": v for k, v in _flat(gp).items()}
                if spec["kind"] == "block" else {"gw": gp["w"], "gb": gp["b"]})
        for k, ref in want.items():
            np.testing.assert_allclose(res[f"{case}/{k}"], ref, atol=GRAD_ATOL, rtol=0,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_pipeline_tick_count_equals_jax(world, m):
    from fluxmpi_tpu.parallel.pipeline import pipeline_tick_count as jax_ticks
    from fluxmpi_tpu_torch.parallel.pipeline import _schedule_period, pipeline_tick_count

    from fluxmpi_tpu.parallel.pipeline import _schedule_period as jax_period

    for s in (1, 2, 3, 4, 8):
        for v in (1, 2, 3):
            assert pipeline_tick_count(m, s, v) == jax_ticks(m, s, v), (m, s, v)
            m_pad = -(-m // s) * s
            assert _schedule_period(m_pad, s, v) == jax_period(m_pad, s, v)


def test_stack_stage_params_and_rules_equal_jax(world, data):
    from fluxmpi_tpu.parallel.pipeline import pipeline_rules as jax_rules
    from fluxmpi_tpu.parallel.pipeline import stack_stage_params as jax_stack
    from fluxmpi_tpu_torch.parallel import pipeline_rules, stack_stage_params

    w = data["s8_w"]
    for kw in (dict(), dict(n_stages=4, interleave=2), dict(n_stages=2, interleave=4)):
        got = stack_stage_params([{"w": torch.from_numpy(a)} for a in w], **kw)
        want = jax_stack([{"w": jnp.asarray(a)} for a in w], **kw)
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    for shape in [(4, 8, 8), (4,), ()]:
        t, j = pipeline_rules("pp")("stages/w", shape), jax_rules("pp")("stages/w", shape)
        assert (t is None and j is None) or tuple(t) == tuple(j)
    with pytest.raises(ValueError) as j:
        jax_stack([{"w": jnp.asarray(a)} for a in w], interleave=2)
    with pytest.raises(ValueError) as t:
        stack_stage_params([{"w": torch.from_numpy(a)} for a in w], interleave=2)
    assert str(t.value) == str(j.value)


def test_pipeline_refusals_equal_jax(world, data):
    """Scalar and mis-stacked leaves, a batch the microbatches do not
    divide, a bad ``interleave``: the same errors as JAX's."""
    import fluxmpi_tpu.parallel.pipeline as jpipe
    from fluxmpi_tpu_torch import _sequence_parallel as sp
    from fluxmpi_tpu_torch.parallel import pipeline as tpipe
    from fluxmpi_tpu_torch.parallel.sharding import Mesh as PortMesh

    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("pp",))
    tmesh = PortMesh(np.arange(4), ("pp",))
    x = data["x8"]
    good = {"w": data["s4_w"], "b": data["s4_b"]}
    for params, m in [({"w": data["s4_w"], "b": 1.0}, 4), ({"w": data["s2_w"]}, 4),
                      (good, 3)]:
        with pytest.raises(ValueError) as j:
            jpipe.make_pipeline_fn(_stage_fn, jmesh, n_microbatches=m)(
                jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
        with pytest.raises(ValueError) as t:
            tpipe.make_pipeline_fn(lambda p, h: h, tmesh, n_microbatches=m)(
                {k: torch.as_tensor(v) for k, v in params.items()}, torch.from_numpy(x))
        assert str(t.value) == str(j.value)
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked

    for kw in (dict(interleave=0), dict(interleave=2)):
        body = lambda p, xx: jpipe.pipeline_apply(_stage_fn, p, xx, n_microbatches=4,  # noqa: E731
                                                  axis_name="pp", **kw)
        mapped = shard_map_unchecked(body, jmesh, in_specs=(JP("pp"), JP()), out_specs=JP("pp"))
        with pytest.raises(ValueError) as j:
            jax.jit(mapped)(jax.tree_util.tree_map(jnp.asarray, good), jnp.asarray(x))
        with sp.active(sp.SequenceParallel(tmesh)), pytest.raises(ValueError) as t:
            tpipe.pipeline_apply(lambda p, h: h, {k: torch.from_numpy(v[:1])
                                                  for k, v in good.items()},
                                 torch.from_numpy(x), n_microbatches=4, axis_name="pp", **kw)
        assert str(t.value) == str(j.value)
