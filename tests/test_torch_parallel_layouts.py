"""The parallel layouts in real 2- and 4-rank worlds (one process per rank,
``torch.distributed`` over gloo through a ``FileStore``, one thread each, a
join timeout; the ranks run ``tests/_torch_layout_worker.py``), held to the
JAX package on as many of its 8 CPU devices, from the same flax weights and
the same global batches:

- ``MoETransformerLM`` trained 3 updates under ``make_train_step(parallel=)``
  (``style="auto"``) with ``ParallelConfig(fsdp=2)`` (2 ranks), ``(dp=2,
  tp=2)``, ``(fsdp=2, tp=2)`` and ``(dp=2, ep=2)`` with
  ``expert_parallel_rules`` (4 ranks), the dense ``TransformerLM`` under
  ``(dp=2, tp=2)`` and ``(fsdp=2, tp=2)`` (4 ranks), and
  ``style="shard_map"`` (2 ranks): every update's loss, every parameter
  block after the third, whose shape must equal the JAX package's
  addressable shard on the same mesh coordinate, and
  ``make_eval_step(parallel=)``'s metric (the workers' mean) against
  JAX's;
- under tp, the layers' split compute from the second update on: the
  heads each attention sees, the step's all-gathers (the fsdp leaves'
  only), the leaves handed over as blocks, and every gradient of the
  second update against JAX's; the model stats built into each plan's
  step against the JAX package's stats of the same update;
- ``shard_tree``'s blocks against JAX's addressable shards;
- ``psum_tree``, ``pmean_tree``, ``pallreduce`` (``prod``, ``max``) and
  ``pbroadcast`` with their gradients against JAX's ``shard_map``;
- ``tp_unembed_cross_entropy``'s loss and gradients (tp over the world;
  the table as a ``Shard(0)`` DTensor and whole) and its validation;
- the loader's rows under ``mesh=``/``axis_name=`` (``dp`` of a dp x tp
  mesh, and the product ``("dp", "fsdp")``) against JAX's addressable
  shards.

Tolerances (f32): losses and parameters atol 2e-5 (an attention key
bias, whose gradient is rounding noise that Adam normalizes, 6 x lr);
collectives exact but for the last bit (1e-6); the fused CE atol 2e-5 on
the loss and 5e-5 on the gradients, as the JAX package's own test.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import fluxmpi_tpu as jfm
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.moe import MoETransformerLM as JaxMoELM
from fluxmpi_tpu.models.moe import expert_parallel_rules as jax_ep_rules
from fluxmpi_tpu.parallel import ParallelConfig as JaxParallelConfig
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_eval_step as jax_make_eval_step
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_layout_worker.py"
JOIN_TIMEOUT = 300
ATOL = 2e-5
LR = 1e-3
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32,
          num_experts=4)
CASES = {"fsdp": (2, dict(fsdp=2, fsdp_min_size=64)),
         "dp_tp": (4, dict(dp=2, tp=2)),
         "fsdp_tp": (4, dict(fsdp=2, tp=2, fsdp_min_size=64)),
         "dp_ep": (4, dict(dp=2, ep=2)),
         "lm_dp_tp": (4, dict(dp=2, tp=2)),
         "lm_fsdp_tp": (4, dict(fsdp=2, tp=2, fsdp_min_size=64))}
TP_CASES = sorted(c for c, (_, kw) in CASES.items() if "tp" in kw)

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    """The addressable shard of ``arr`` on device ``device_id``."""
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    params = JaxMoELM(**LM).init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                                 train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    lm = {k: v for k, v in LM.items() if k != "num_experts"}
    lm_params = JaxLM(**lm).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                                 train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    lm_rng = np.random.default_rng(1)
    lm_params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * lm_rng.normal(size=x.shape).astype(np.float32),
        lm_params)
    d = dict(tokens=rng.integers(0, 32, (40, 8)).astype(np.int32),
             targets=rng.integers(0, 32, (40, 8)).astype(np.int32),
             coll_x=rng.normal(size=(4, 3)).astype(np.float32),
             ce_h=rng.normal(size=(2, 8, 16)).astype(np.float32),
             ce_W=(rng.normal(size=(32, 16)) * 0.3).astype(np.float32),
             ce_t=rng.integers(0, 32, (2, 8)).astype(np.int64))
    path = tmp_path_factory.mktemp("layouts") / "data.npz"
    np.savez(path, **d, **{f"params/{k}": v for k, v in _flat(params).items()},
             **{f"lmparams/{k}": v for k, v in _flat(lm_params).items()})
    return dict(d, params=params, lm_params=lm_params, path=path)


def _start_world(tmp, world, data_path):
    """Start the ranks of one world; ``_run_world`` joins them."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), str(world), str(tmp / "store"),
             str(tmp / f"rank{rank}.npz"), str(data_path)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return tmp, world, procs, logs


def _run_world(tmp, world, procs, logs):
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
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
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False)) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """Each rank's results in the 2-rank and the 4-rank world."""
    # Both worlds run at once.
    started = {n: _start_world(tmp_path_factory.mktemp(f"world{n}"), n, data["path"])
               for n in (2, 4)}
    return {n: _run_world(*started[n]) for n in (2, 4)}


def _jax_train(data, kw, n, style="auto", dense=False, grads=None, stats=None):
    """3 updates of the JAX MoE LM (``dense``: the TransformerLM):
    ``(losses, params tree, eval metric)`` (the metric None for the
    shard_map step). ``grads``, a dict, gets the gradient of the second
    update's loss, each leaf laid out as its parameter; ``stats``, a dict,
    the JAX package's model stats of that update at depth 2."""
    devs = jax.devices()[:n]
    opt = optax.adamw(LR)
    variables = {"params": data["lm_params" if dense else "params"]}
    if style == "shard_map":
        plan, model = None, JaxMoELM(**LM)
        mesh = Mesh(np.asarray(devs), ("dp",))
    else:
        if "ep" in kw:
            kw = dict(kw, rules=jax_ep_rules())
        plan = JaxParallelConfig(**kw).resolve(devs)
        if dense:
            model = JaxLM(**{k: v for k, v in LM.items() if k != "num_experts"})
        else:
            model = JaxMoELM(**LM, mesh=plan.mesh if "ep" in kw else None)

    def loss_fn(p, ms, batch):
        return jnp.mean(model.apply(p, batch["x"], train=False, targets=batch["y"])), ms

    state = JaxTrainState.create(variables, opt)
    if plan is not None:
        state, _ = plan.shard_state(state)
        step = jax_make_train_step(loss_fn, opt, parallel=plan)
    else:
        state = jax.device_put(state, NamedSharding(mesh, JP()))
        step = jax_make_train_step(loss_fn, opt, mesh=mesh, style="shard_map")
    losses = []
    for b in range(3):
        batch = {"x": data["tokens"][8 * b:8 * b + 8], "y": data["targets"][8 * b:8 * b + 8]}
        if b == 1 and (grads is not None or stats is not None):
            from fluxmpi_tpu.telemetry.modelstats import compute_stats

            def grads_and_stats(params, opt_state):
                g = jax.grad(lambda p: loss_fn(p, None, batch)[0])(params)
                upd, _ = opt.update(g, opt_state, params)
                return g, compute_stats(g, params, upd, depth=2)["layers"]

            g, layer_stats = jax.jit(grads_and_stats)(state.params, state.opt_state)
            if grads is not None:
                grads.update(jax.tree_util.tree_map(
                    lambda x, p: jax.device_put(x, p.sharding), g, state.params)["params"])
            if stats is not None:
                stats.update(layer_stats)
        state, loss = step(state, batch)
        losses.append(float(loss))
    if plan is None:
        return np.array(losses), state.params["params"], None
    evaluate = jax_make_eval_step(lambda p, ms, b: loss_fn(p, ms, b)[0], parallel=plan)
    return np.array(losses), state.params["params"], float(evaluate(state, batch))


_JAX_CASES: dict = {}


def _jax_case(data, case):
    """JAX's run of plan case ``case``, once per module: ``(losses, params,
    eval metric, second update's gradients, its model stats)``."""
    if case not in _JAX_CASES:
        n, kw = CASES[case]
        grads, stats = {}, {}
        out = _jax_train(data, kw, n, dense=case.startswith("lm_"), grads=grads,
                         stats=stats)
        _JAX_CASES[case] = out + (grads, stats)
    return _JAX_CASES[case]


def _check_params(ranks, prefix, jparams):
    want = _flat(jparams)
    for r, res in enumerate(ranks):
        for name, arr in want.items():
            got = res[f"{prefix}/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            atol = 6 * LR if name.endswith("attn/key/bias") else ATOL
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=f"{r} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_trains_like_jax(world, worlds, data, case):
    """3 updates under a plan: the loss of each update and every parameter
    block (shape and values) equal JAX's on the same mesh coordinate."""
    n, kw = CASES[case]
    jlosses, jparams, jeval, _, _ = _jax_case(data, case)
    ranks = worlds[n]
    for res in ranks:
        np.testing.assert_allclose(res[f"{case}/losses"], jlosses, atol=ATOL, rtol=0)
        np.testing.assert_allclose(res[f"{case}/eval"], jeval, atol=ATOL, rtol=0)
    _check_params(ranks, f"{case}/param", jparams)
    if "tp" in kw or "fsdp" in kw:
        # Something is sharded: some rank's block is smaller than the leaf.
        tree = data["lm_params" if case.startswith("lm_") else "params"]
        full = {k.replace("/", "."): v.shape for k, v in _flat(tree).items()}
        assert any(ranks[0][f"{case}/param/{k}"].shape != s for k, s in full.items())
    if case == "dp_ep":
        assert ranks[0][f"{case}/param/encoder.block_0.moe.w1"].shape[0] == 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_stats_over_the_layout_equal_jax(world, worlds, data, case):
    """The model stats built into the step under each plan (depth 2, the
    second update): every group's gradient, parameter and update norms sum
    each leaf's blocks once over the workers that hold them, and equal the
    JAX package's stats of the same update on every rank; no noise scale
    under a layout, as JAX's partitioned step has none."""
    n, _ = CASES[case]
    want = _jax_case(data, case)[4]
    for res in worlds[n]:
        names = res[f"{case}/stats_names"].tolist()
        assert names == sorted(want)
        assert bool(res[f"{case}/stats_noise"])
        for name, row in zip(names, res[f"{case}/stats"]):
            ref = [float(want[name][k]) for k in
                   ("grad_norm", "param_norm", "update_norm", "nonfinite")]
            np.testing.assert_allclose(row, ref, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_layers_compute_on_their_blocks(world, worlds, data, case):
    """Under tp, from the second update on: every leaf the tp rules shard
    is handed to the layers as this worker's block (none is all-gathered:
    the step's only all-gathers are the fsdp leaves'), each attention sees
    ``heads / tp`` heads, and the gradient of every leaf, the replicated
    LayerNorms and row-parallel biases included, equals JAX's gradient of
    the same update within 2e-5."""
    n, kw = CASES[case]
    dense = case.startswith("lm_")
    jgrads = _jax_case(data, case)[3]
    # The plan's rule hits count the state's leaves: each parameter and
    # its two adamw moments.
    hits = {k: int(v) // 3 for k, v in worlds[n][0][f"{case}/rule_hits"].tolist()}
    for r, res in enumerate(worlds[n]):
        assert res[f"{case}/heads"].tolist() == [LM["num_heads"] // kw["tp"]]
        assert len(res[f"{case}/tp_blocks"]) == hits["tp"]
        assert int(res[f"{case}/gathers"]) == 2 * hits.get("fsdp", 0)
        for name, arr in _flat(jgrads).items():
            got = res[f"{case}/grad/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{r} {name}")
    if dense:
        blocks = set(worlds[n][0][f"{case}/tp_blocks"].tolist())
        assert {"encoder.block_0.ff1.kernel", "encoder.block_0.ff2.kernel",
                "encoder.block_0.attn.out.kernel", "embed.embedding"} <= blocks


def test_shard_map_step_trains_like_jax(world, worlds, data):
    jlosses, jparams, _ = _jax_train(data, {}, 2, style="shard_map")
    for res in worlds[2]:
        np.testing.assert_allclose(res["shard_map/losses"], jlosses, atol=ATOL, rtol=0)
    _check_params(worlds[2], "shard_map/param", jparams)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_tree_blocks_equal_jax_addressable_shards(world, worlds, data, n):
    from fluxmpi_tpu.parallel import (combine_rules, fsdp_rule, shard_tree,
                                      transformer_tp_rules)

    devs = np.asarray(jax.devices()[:n])
    if n == 4:
        mesh = Mesh(devs.reshape(2, 2), ("fsdp", "tp"))
        rule = combine_rules(transformer_tp_rules(),
                             fsdp_rule(mesh, axis_name="fsdp", min_size=64))
    else:
        mesh = Mesh(devs, ("fsdp",))
        rule = fsdp_rule(mesh, axis_name="fsdp", min_size=64)
    placed, _ = shard_tree(data["params"], mesh, rule)
    for r, res in enumerate(worlds[n]):
        for name, arr in _flat(placed).items():
            got = res[f"shard_tree/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name)
            np.testing.assert_array_equal(got, ref)


def _jax_collectives(x, n):
    from fluxmpi_tpu.parallel import pallreduce, pbroadcast, pmean_tree, psum_tree
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    w = jnp.arange(1.0, 4.0)
    out = {}
    for name, f in [("psum", psum_tree), ("pmean", pmean_tree),
                    ("prod", lambda v: pallreduce(v, "prod")),
                    ("bcast", lambda v: pbroadcast(v, n - 1)),
                    ("max", lambda v: pallreduce(v, "max"))]:
        def body(v, f=f):
            y = f(v)
            if name == "max":
                return y, v
            return y, jax.grad(lambda u: jnp.sum(f(u) * w))(v)

        y, g = jax.jit(shard_map_unchecked(body, mesh, in_specs=(JP("dp"),),
                                           out_specs=(JP("dp"), JP("dp"))))(x)
        out[name], out[f"{name}_grad"] = np.asarray(y), np.asarray(g)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_gradients_equal_jax(world, worlds, data, n):
    want = _jax_collectives(jnp.asarray(data["coll_x"][:n]), n)
    for r, res in enumerate(worlds[n]):
        for name in ("psum", "pmean", "prod", "bcast", "max"):
            np.testing.assert_allclose(res[f"coll/{name}"], want[name][r], atol=1e-6,
                                       rtol=1e-6, err_msg=name)
        for name in ("psum", "pmean", "prod", "bcast"):
            np.testing.assert_allclose(res[f"coll/{name}_grad"], want[f"{name}_grad"][r],
                                       atol=1e-6, rtol=1e-6, err_msg=name)
        # JAX has no differentiation rule for pmax; neither has the port.
        assert bool(res["coll/max_grad_raises"])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_unembed_ce_equals_jax(world, worlds, data, n):
    from fluxmpi_tpu.ops import tp_unembed_cross_entropy as jax_tp_ce

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    h, W, t = (jnp.asarray(data["ce_h"]), jnp.asarray(data["ce_W"]),
               jnp.asarray(data["ce_t"].astype(np.int32)))
    Ws = jax.device_put(W, NamedSharding(mesh, JP("tp", None)))

    def loss(h, W):
        return jnp.mean(jax_tp_ce(h, W, t, mesh=mesh, axis_name="tp", chunk=4))

    out = jax.jit(lambda h, W: jax_tp_ce(h, W, t, mesh=mesh, axis_name="tp", chunk=4))(h, Ws)
    gh, gW = jax.jit(jax.grad(loss, argnums=(0, 1)))(h, Ws)
    v_local = W.shape[0] // n
    for r, res in enumerate(worlds[n]):
        for case in ("ce", "ce_full"):
            np.testing.assert_allclose(res[f"{case}/loss"], np.asarray(out), atol=2e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(res[f"{case}/dh"], np.asarray(gh), atol=5e-5,
                                       rtol=1e-4)
        # A sharded table's gradient is this worker's block; a whole
        # table's is whole.
        np.testing.assert_allclose(res["ce/dW"], np.asarray(gW)[r * v_local:(r + 1) * v_local],
                                   atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(res["ce_full/dW"], np.asarray(gW), atol=5e-5, rtol=1e-4)


def test_tp_unembed_ce_validation_equals_jax(world):
    """The JAX package's validation test (``tests/test_ops.py``'s
    ``test_tp_unembed_ce_validation``), the same messages."""
    from fluxmpi_tpu.ops import tp_unembed_cross_entropy as jax_tp_ce
    from fluxmpi_tpu_torch.ops import tp_unembed_cross_entropy
    from fluxmpi_tpu_torch.parallel.sharding import Mesh as PortMesh

    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("tp",))
    tmesh = PortMesh(np.arange(8), ("tp",))
    for table, axis in [(60, "tp"), (64, "model")]:
        with pytest.raises(ValueError) as j:
            jax_tp_ce(jnp.ones((2, 4, 8)), jnp.ones((table, 8)), jnp.zeros((2, 4), jnp.int32),
                      mesh=jmesh, axis_name=axis)
        with pytest.raises(ValueError) as t:
            tp_unembed_cross_entropy(torch.ones(2, 4, 8), torch.ones(table, 8),
                                     torch.zeros(2, 4, dtype=torch.long), mesh=tmesh,
                                     axis_name=axis)
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("name,shape,axes", [("dp_tp", ("dp", "tp"), "dp"),
                                             ("dp_fsdp", ("dp", "fsdp"), ("dp", "fsdp"))])
def test_loader_rows_equal_jax_addressable_shards(world, worlds, name, shape, axes):
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), shape)
    loader = jfm.DistributedDataLoader(jfm.ArrayDataset({"i": np.arange(40)}), 8,
                                       mesh=mesh, axis_name=axes, shuffle=True, seed=3)
    batches = list(loader)
    for r, res in enumerate(worlds[4]):
        want = np.stack([_shard(b["i"], r) for b in batches])
        np.testing.assert_array_equal(res[f"loader/{name}"], want)
