"""Gradient accumulation over the global batch at world > 1 (ROADMAP C.34).

The JAX package's ``style="auto"`` step with ``grad_accum_steps=k``
reshapes the global batch to ``[k, B/k, ...]`` and scans: microbatch ``j``
is the global rows ``[j B/k, (j + 1) B/k)``, sharded over the devices. The
port's step hands each worker its own rows, so before it chunks them it
exchanges rows over the batch axes: afterwards a worker's ``j``-th chunk is
its block of JAX's microbatch ``j``. In real gloo worlds (one process per
rank, ``tests/_torch_accum_worker.py``), each rank its share of the same
global batches, from the same numpy inputs and flax weights:

- the batch-normalized MLP (the quick-start MLP of the JAX step tests, its
  prediction through ``BatchNorm``), the CNN with ``BatchNorm(axis_name=
  None)``, the DEQ (``damped``, at a ``tol`` where the microbatches' rows
  stop at other iterations than another grouping's) and ``MoEMLP(
  n_groups=3)`` with a capacity that drops tokens, two ``sgd`` updates at
  (N, k) in {(2, 2), (2, 3), (4, 2), (4, 4)}: equal split sizes (N | k),
  unequal ones, and (2, 3), where neither divides the other; each against
  JAX's step over as many of its CPU devices;
- the MoE LM (``n_groups=1``, top 2) under ``ParallelConfig(dp=2, sp=2)``
  with ``grad_accum_steps=2``: the exchange runs over dp at each sp index;
  and two pipeline stages under ``(dp=2, pp=2)``, where JAX accumulates
  too (over dp at each pp index);
- the DDPM UNet's and ViT's draws with ``grad_accum_steps=2`` at world 2
  against world 1, bit for bit, their losses and parameters within 2e-5;
- ``train_loop(fuse="auto")`` with ``grad_accum_steps=2`` at world 2, bit
  for bit against ``fuse=False`` (the CNN's statistics carried, ViT's
  dropout);
- C.35: at B = 16, 8 devices, k = 4 JAX runs 4-row microbatches over 8
  devices; the port's workers hold 2 rows each and raise, naming the sizes.

Tolerance 2e-5 (C.32's): f32 on both sides, sums in other orders. On the
parent every parity case fails: a worker's ``j``-th chunk of its own rows
made microbatch ``j`` the union of every worker's ``j``-th chunk.
"""

import json
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_compose as compose
from _torch_worlds import join_world, start_world
from fluxmpi_tpu.models import CNN as JaxCNN
from fluxmpi_tpu.models import DEQ as JaxDEQ
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.models import MoEMLP as JaxMoEMLP
from fluxmpi_tpu.models import MoETransformerLM as JaxMoELM
from fluxmpi_tpu.models import collect_moe_losses
from fluxmpi_tpu.parallel import ParallelConfig as JaxParallelConfig
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel.train import replicate, shard_batch

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "_torch_accum_worker.py"
ATOL = 2e-5
B, UPDATES = 48, 2
SPLITS = [(2, 2), (2, 3), (4, 2), (4, 4)]
MODELS = ("mlp_bn", "cnn", "deq", "moe")
LR = {"mlp_bn": 0.1, "cnn": 0.1, "deq": 0.1, "moe": 0.5}
DEQ_OPTS = dict(hidden=16, out=2, tol=1e-2, max_iter=60, damping=0.7, solver="damped")
MOE_OPTS = dict(num_experts=4, d_ff=16, capacity_factor=1.0, n_groups=3)
MOE_D, MOE_S = 8, 6
PLAN = {"moe_dp2_sp2": dict(plan=dict(dp=2, sp=2), moe=dict(n_groups=1, top_k=2), k=2,
                            rows=8),
        "pp_dp2_pp2": dict(plan=dict(dp=2, pp=2), k=2, rows=16)}
TINY = dict(unet=dict(out_channels=3, base_channels=8, channel_mults=(1, 2),
                      blocks_per_stage=2, attn_resolutions=(4,), groups=4),
            vit=dict(num_classes=5, patch=8, num_layers=2, d_model=32, num_heads=4, d_ff=64))
DRAWS = {"unet": ("tsteps", "eps"), "vit": ("embed_keep", "attn_keep")}
GROUPS = {1: "draws", 2: "parity,draws,fused", 4: "parity,plan"}


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _BNMLP(fnn.Module):
    """The JAX step tests' MLP with its prediction batch-normalized."""

    @fnn.compact
    def __call__(self, x):
        y = JaxMLP(features=(8, 8, 1), name="mlp")(x)
        return fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                             name="bn")(y)


def _deq_params(rng):
    h = DEQ_OPTS["hidden"]
    return {"W": (0.8 * rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32),
            "U": (rng.normal(size=(3, h)) / np.sqrt(3)).astype(np.float32),
            "b": (0.1 * rng.normal(size=(h,))).astype(np.float32),
            "head": {"kernel": (0.3 * rng.normal(size=(h, 2))).astype(np.float32),
                     "bias": (0.1 * rng.normal(size=(2,))).astype(np.float32)}}


def _jax_model(name):
    """``(module, loss_fn)`` of a parity case on the JAX side."""
    if name == "mlp_bn":
        jm = _BNMLP()
    elif name == "cnn":
        jm = JaxCNN(num_classes=4, channels=(4, 8))
    elif name == "deq":
        jm = JaxDEQ(**DEQ_OPTS)
    else:
        jm = JaxMoEMLP(**MOE_OPTS)

    def loss_fn(p, ms, b):
        if name == "mlp_bn":
            pred, upd = jm.apply({"params": p, "batch_stats": ms}, b[0],
                                 mutable=["batch_stats"])
            return jnp.mean((pred - b[1]) ** 2), upd["batch_stats"]
        if name == "cnn":
            logits, upd = jm.apply({"params": p, "batch_stats": ms}, b[0], train=True,
                                   mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, b[1]).mean(), upd["batch_stats"]
        return jnp.mean((jm.apply({"params": p}, b[0]) - b[1]) ** 2), ms

    return jm, loss_fn


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = dict(mlp_bn_x=rng.normal(size=(UPDATES, B, 2)).astype(np.float32),
             mlp_bn_y=rng.normal(size=(UPDATES, B, 1)).astype(np.float32),
             cnn_x=rng.normal(size=(UPDATES, B, 8, 8, 3)).astype(np.float32),
             cnn_y=rng.integers(0, 4, (UPDATES, B)).astype(np.int32),
             # Rows of growing size converge at different speeds.
             deq_x=(rng.normal(size=(UPDATES, B, 3))
                    * np.linspace(0.2, 3, B)[None, :, None]).astype(np.float32),
             deq_y=rng.normal(size=(UPDATES, B, 2)).astype(np.float32),
             moe_x=rng.normal(size=(UPDATES, B, MOE_S, MOE_D)).astype(np.float32),
             moe_y=rng.normal(size=(UPDATES, B, MOE_S, MOE_D)).astype(np.float32))
    weights = {}
    for name, kw in (("mlp_bn", {}), ("cnn", dict(train=False))):
        jm, _ = _jax_model(name)
        v = jax.jit(lambda x, jm=jm, kw=kw: jm.init(jax.random.PRNGKey(0), x, **kw))(
            jnp.asarray(d[f"{name}_x"][0]))
        weights[name] = jax.tree_util.tree_map(np.asarray, dict(v))
    weights["deq"] = {"params": _deq_params(rng)}
    moe = JaxMoEMLP(**MOE_OPTS).init(jax.random.PRNGKey(3), jnp.asarray(d["moe_x"][0]))
    weights["moe"] = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        moe["params"])}
    lm = dict(tokens=rng.integers(0, 32, (24, 16)).astype(np.int32),
              targets=rng.integers(0, 32, (24, 16)).astype(np.int32),
              **compose.pp_data(rng))
    moe_lm = compose.moe_weights(rng)
    paths = {}
    for n in GROUPS:
        cases = dict(parity=[(m, k) for m in MODELS for nn_, k in SPLITS if nn_ == n],
                     plan=PLAN if n == 4 else {}, lr=LR, lm=compose.LM, draw_rows=8, **TINY)
        p = tmp_path_factory.mktemp(f"accum{n}") / "data.npz"
        np.savez(p, **d, **lm, cases=np.array(json.dumps(cases)),
                 deq_opts=np.array(json.dumps(DEQ_OPTS)),
                 moe_opts=np.array(json.dumps(dict(MOE_OPTS, d_model=MOE_D))),
                 **{f"{m}/{k}": v for m, w in weights.items() for k, v in _flat(w).items()},
                 **{f"moe_lm/{k}": np.asarray(v) for k, v in compose.flat(moe_lm).items()})
        paths[n] = p
    return dict(d, **lm, weights=weights, moe_lm=moe_lm, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world(GROUPS[n], tmp_path_factory.mktemp(f"accumw{n}"), n,
                              data["paths"][n], worker=WORKER) for n in GROUPS}
    return {n: join_world(*w) for n, w in started.items()}


_JAX: dict = {}


def _jax_parity(data, name, n, k):
    """JAX's ``style="auto"`` step with ``grad_accum_steps=k`` over ``n``
    CPU devices, ``UPDATES`` updates of ``sgd``: ``(losses, params,
    statistics)`` keyed by flax path."""
    key = (name, n, k)
    if key not in _JAX:
        mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
        _, loss_fn = _jax_model(name)
        w = data["weights"][name]
        opt = optax.sgd(LR[name])
        step = jax_make_train_step(loss_fn, opt, mesh=mesh, axis_name="dp", donate=False,
                                   grad_accum_steps=k)
        state = replicate(JaxTrainState.create(w["params"], opt, w.get("batch_stats")), mesh)
        losses = []
        for u in range(UPDATES):
            batch = shard_batch((jnp.asarray(data[f"{name}_x"][u]),
                                 jnp.asarray(data[f"{name}_y"][u])), mesh)
            state, loss = step(state, batch)
            losses.append(float(loss))
        stats = _flat(state.model_state) if w.get("batch_stats") else {}
        _JAX[key] = (losses, _flat(state.params), stats)
    return _JAX[key]


def _assert_close(res, case, want, rank):
    losses, params, stats = want
    for u, loss in enumerate(losses):
        assert abs(float(res[f"{case}/loss{u}"]) - loss) <= ATOL, (case, rank, u)
    for k, p in params.items():
        np.testing.assert_allclose(res[f"{case}/param/{k.replace('/', '.')}"], p, atol=ATOL,
                                   rtol=0, err_msg=f"{case} rank {rank} {k}")
    for k, s in stats.items():
        np.testing.assert_allclose(res[f"{case}/stats/{k.replace('/', '.')}"], s, atol=ATOL,
                                   rtol=0, err_msg=f"{case} rank {rank} {k}")


@pytest.mark.parametrize("n,k", SPLITS, ids=[f"N{n}-k{k}" for n, k in SPLITS])
@pytest.mark.parametrize("model", MODELS)
def test_accumulated_update_matches_jax_auto(world, worlds, data, model, n, k):
    want = _jax_parity(data, model, n, k)
    for r, res in enumerate(worlds[n]):
        _assert_close(res, f"{model}_k{k}", want, r)


def test_jax_microbatches_are_the_global_batch_slices(world, data):
    """JAX's accumulated update over the devices equals the serial update
    over the contiguous slices, and another grouping of the rows (each
    device's chunks, the port's before C.34) moves the batch-coupled
    model's loss well past the tolerance."""
    name, k = "mlp_bn", 2
    _, loss_fn = _jax_model(name)
    w = data["weights"][name]
    x, y = data[f"{name}_x"][0], data[f"{name}_y"][0]

    def serial(rows):
        loss = 0.0
        for j in range(k):
            sl = rows[j * B // k:(j + 1) * B // k]
            loss += float(loss_fn(w["params"], w["batch_stats"], (x[sl], y[sl]))[0]) / k
        return loss

    got = _jax_parity(data, name, 4, k)[0][0]
    assert abs(serial(np.arange(B)) - got) <= 1e-6
    chunked = np.arange(B).reshape(4, k, -1).transpose(1, 0, 2).reshape(-1)
    assert abs(serial(chunked) - got) > 10 * ATOL


def test_plan_dp_x_pp_accumulates_like_jax(world, worlds, data):
    """JAX runs ``grad_accum_steps`` under pp as under any plan (each
    microbatch through the pipeline's own microbatches); so does the port,
    its rows exchanged over dp at each pp index."""
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn, pipeline_rules

    spec = PLAN["pp_dp2_pp2"]
    rule = pipeline_rules("pp")
    plan = JaxParallelConfig(**spec["plan"], rules=lambda path, shape: (
        rule(path, shape) if "stages" in path else jax.sharding.PartitionSpec())).resolve(
        jax.devices()[:4])
    pipe = make_pipeline_fn(compose._stage_fn, plan.mesh, n_microbatches=4, axis_name="pp")

    def loss_fn(p, ms, batch):
        y = pipe(p["stages"], batch["x"])
        return jnp.mean((y @ p["head"] - batch["y"]) ** 2), ms

    opt = optax.sgd(compose.LR)
    params = {"stages": {"w": data["pp_w"], "b": data["pp_b"]}, "head": data["pp_head"]}
    state, _ = plan.shard_state(JaxTrainState.create(params, opt))
    step = jax_make_train_step(loss_fn, opt, parallel=plan, grad_accum_steps=spec["k"])
    losses = []
    for b in range(len(data["pp_x"]) // spec["rows"]):
        sl = slice(spec["rows"] * b, spec["rows"] * (b + 1))
        state, loss = step(state, {"x": data["pp_x"][sl], "y": data["pp_y"][sl]})
        losses.append(float(loss))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_allclose(res["pp_dp2_pp2/losses"], losses, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["pp_dp2_pp2/param/head"], state.params["head"],
                                   atol=ATOL, rtol=0, err_msg=f"rank {r}")


def test_plan_dp_x_sp_accumulates_like_jax(world, worlds, data):
    spec = PLAN["moe_dp2_sp2"]
    plan = JaxParallelConfig(**spec["plan"]).resolve(jax.devices()[:4])
    model = JaxMoELM(**compose.MOE, **spec["moe"])

    def loss_fn(p, ms, batch):
        ce, mut = model.apply({"params": p["params"]}, batch["x"], train=True,
                              targets=batch["y"], mutable=["losses"])
        aux, z = collect_moe_losses(mut["losses"])
        return jnp.mean(ce) + compose.AUX * aux + compose.Z * z, ms

    opt = optax.sgd(compose.LR)
    state, _ = plan.shard_state(JaxTrainState.create({"params": data["moe_lm"]}, opt))
    step = jax_make_train_step(loss_fn, opt, parallel=plan, grad_accum_steps=spec["k"])
    losses = []
    for b in range(3):
        sl = slice(spec["rows"] * b, spec["rows"] * (b + 1))
        state, loss = step(state, {"x": data["tokens"][sl], "y": data["targets"][sl]})
        losses.append(float(loss))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_allclose(res["moe_dp2_sp2/losses"], losses, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, arr in _flat(state.params["params"]).items():
            np.testing.assert_allclose(res[f"moe_dp2_sp2/param/{name.replace('/', '.')}"],
                                       arr, atol=ATOL, rtol=0, err_msg=f"{r} {name}")


@pytest.mark.parametrize("kind", ["unet", "vit"])
def test_world_two_accumulates_the_draws_of_world_one(worlds, kind):
    (one,), two = worlds[1], worlds[2]
    case = f"draws_{kind}"
    for name in DRAWS[kind]:
        calls = int(one[f"{case}/{name}_calls"])
        assert calls >= 4 and all(int(r[f"{case}/{name}_calls"]) == calls for r in two)
        for i in range(calls):
            key = f"{case}/{name}{i}"
            np.testing.assert_array_equal(np.concatenate([r[key] for r in two]), one[key],
                                          err_msg=key)
    for r in two:
        for u in range(2):
            np.testing.assert_allclose(r[f"{case}/loss{u}"], one[f"{case}/loss{u}"],
                                       atol=ATOL, rtol=0)
        params = [k for k in one if k.startswith(f"{case}/param/")]
        assert params
        for k in params:
            np.testing.assert_allclose(r[k], one[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["cnn", "vit"])
def test_fused_windows_accumulate_bit_for_bit(worlds, kind):
    for r in worlds[2]:
        case = f"fused_{kind}"
        assert int(r[f"{case}/fused_window_auto"]) == 2
        assert int(r[f"{case}/fused_window_False"]) == 0
        assert int(r[f"{case}/updates_auto"]) == int(r[f"{case}/updates_False"]) > 0
        assert int(r[f"{case}/same"]) == int(r[f"{case}/leaves"]) > 0
        assert bool(r[f"{case}/flushes_equal"])


def test_uneven_shares_refuse_naming_the_sizes_where_jax_runs(world):
    """C.35 (open): 16 rows, 8 devices, k = 4. JAX runs it and equals the
    serial update over the contiguous quarters; the port's 8 workers would
    hold 2 rows each, which do not divide into 4 blocks: it raises."""
    from fluxmpi_tpu_torch import _batch_parallel
    from fluxmpi_tpu_torch.parallel.train import _microbatch_rows

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(16, 2)).astype(np.float32), rng.normal(size=(16, 1)).astype(
        np.float32)
    jm, loss_fn = _jax_model("mlp_bn")
    w = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), x)))
    opt = optax.sgd(0.1)
    step = jax_make_train_step(loss_fn, opt, mesh=mesh, axis_name="dp", donate=False,
                               grad_accum_steps=4)
    state = replicate(JaxTrainState.create(w["params"], opt, w["batch_stats"]), mesh)
    _, loss = step(state, shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh))
    serial = np.mean([float(loss_fn(w["params"], w["batch_stats"],
                                    (x[4 * j:4 * j + 4], y[4 * j:4 * j + 4]))[0])
                      for j in range(4)])
    np.testing.assert_allclose(float(loss), serial, rtol=1e-6)

    class Rows(_batch_parallel.BatchAxes):
        def __init__(self):
            self.mesh, self.axes, self.size, self.index = None, (), 8, 0
            self.ranks = list(range(8))

        @property
        def group(self):
            return None

    import torch.distributed as dist

    real = dist.get_process_group_ranks
    dist.get_process_group_ranks = lambda group: list(range(8))
    try:
        with pytest.raises(ValueError, match=r"grad_accum_steps=4 over 8 batch workers of "
                                             r"2 rows each.*C\.35.*JAX package runs"):
            _microbatch_rows((torch.from_numpy(x[:2]),), Rows(), 4)
        with pytest.raises(ValueError, match="batch dim 24 not divisible by "
                                             "grad_accum_steps 5"):
            _microbatch_rows((torch.zeros(3, 2),), Rows(), 5)
    finally:
        dist.get_process_group_ranks = real
