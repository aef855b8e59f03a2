"""``make_train_step(parallel=)`` over plans with ``sp`` and ``pp``, and
ROADMAP C.18's repair, in real 2- and 4-rank gloo worlds (the ranks run
``tests/_torch_seq_worker.py`` group ``step``, each world spawned once and
running all of its cases), held to the JAX package's step over the same
plan on as many of its 8 CPU devices, from the same flax weights and
global batches, 3 updates of ``sgd(0.1)`` each:

- the LM under ``ParallelConfig(dp=2, sp=2)``: each worker's loss sees
  its sequence block and its attention runs as a ring (dense, and flash
  through the kernels' plain versions); under ``sp=2`` with
  ``attention_fn=ring_attention_fn(...)`` and ``ulysses_attention_fn(...)``
  as given. JAX's partitioned step computes global attention;
- a ``make_pipeline_fn`` loss under ``pp=2`` (GPipe and ``interleave=2``)
  and ``dp=2, pp=2``, the stacked stages sharded by ``pipeline_rules``;
- C.18: the LM's mean CE plus 0.1 times the sum of every parameter's
  2-norm under ``tp=2`` and ``dp=2, tp=2`` (every claimed leaf has a
  reader outside the layers, so none is handed over as a block), and plus
  block 0's ff1 kernel's norm alone (only that layer's group stays
  gathered);
- the MoE LM (``tests/_torch_compose.py``: CE plus the balance and z
  losses) under ``sp=2`` with top-1, top-2, expert choice and
  ``n_groups=4`` (each group two rows, cut across both sequence blocks),
  under ``sp=2, ep=2`` (with ``remat=True``) and ``dp=2, sp=2`` (the flash
  ring through the kernels' plain versions): each group routes as a whole;
- a ``make_pipeline_fn`` loss under ``pp=2`` with ``tp=2``, ``ep=2`` and
  ``sp=2`` (its batch cut over sp by ``shard_batch``): every other axis
  replicates the pipeline, as JAX's ``shard_map`` over ``pp`` does;
- the refusals: a loss that enters no sequence-parallel layer, and an
  ``attention_fn`` that is not sequence-parallel; an ``MoEMLP`` built with
  ``mesh=`` inside a pipeline stage, refused by both packages.

Every update's loss and every parameter block (shape and values, against
JAX's addressable shard on the same mesh coordinate) within 2e-5. And the
LM's dense attention dropout under ``sp=2`` (the ring drops each tick's
slice of the whole-sequence mask) equals the port's no-plan run with the
same dropout generator, within 2e-5.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_compose as compose
from _torch_worlds import join_world, start_world

ATOL = 2e-5
LR = 0.1
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)
FF1 = "encoder/block_0/ff1/kernel"

torch.set_num_threads(1)


def _lm(plan, **kw):
    return dict(kind="lm", plan=plan, **kw)


def _pp(plan, w="pp", interleave=1):
    return dict(kind="pp", plan=plan, w=w, interleave=interleave)


CASES = {
    4: {
        "lm_dp_sp": _lm(dict(dp=2, sp=2)),
        "lm_dp_sp_flash": _lm(dict(dp=2, sp=2), attention="flash"),
        "c18_dp_tp": _lm(dict(dp=2, tp=2), penalty="all"),
        "pp_dp": _pp(dict(dp=2, pp=2)),
        "sp_tp": _lm(dict(sp=2, tp=2)),
        "moe_sp_ep": dict(kind="moe", plan=dict(sp=2, ep=2), remat=True),
        "moe_dp_sp_top2": dict(kind="moe", plan=dict(dp=2, sp=2), moe=dict(top_k=2),
                               attention="flash"),
        "pp_tp": _pp(dict(pp=2, tp=2)),
        "pp_ep": _pp(dict(pp=2, ep=2)),
        "pp_sp": _pp(dict(pp=2, sp=2)) | dict(shard_batch=True),
    },
    2: {
        "lm_sp_ring_fn": _lm(dict(sp=2), fn="ring_fn"),
        "lm_sp_ulysses_fn": _lm(dict(sp=2), fn="ulysses_fn"),
        "c18_tp": _lm(dict(tp=2), penalty="all"),
        "c18_tp_ff1": _lm(dict(tp=2), penalty=FF1.replace("/", ".")),
        "pp": _pp(dict(pp=2)),
        "pp_interleave": _pp(dict(pp=2), w="pp2", interleave=2),
        "sp_no_layer_refused": _lm(dict(sp=2), no_layer=True, refused=True),
        "sp_fn_refused": _lm(dict(sp=2), fn="not_sp_fn", refused=True),
        "moe_sp": dict(kind="moe", plan=dict(sp=2)),
        "moe_sp_top2": dict(kind="moe", plan=dict(sp=2), moe=dict(top_k=2)),
        "moe_sp_experts": dict(kind="moe", plan=dict(sp=2), moe=dict(routing="experts")),
        "moe_sp_groups": dict(kind="moe", plan=dict(sp=2), moe=dict(n_groups=4)),
        "dropout_sp": dict(kind="dropout", plan=dict(sp=2)),
    },
}
TRAINED = [(n, c) for n in (4, 2) for c, s in CASES[n].items()
           if not s.get("refused") and s["kind"] != "dropout"]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.models import TransformerLM as JaxLM

    rng = np.random.default_rng(0)
    lm = JaxLM(**LM).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                          train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    lm = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), lm)
    d = dict(tokens=rng.integers(0, 32, (40, 16)).astype(np.int32),
             targets=rng.integers(0, 32, (40, 16)).astype(np.int32))
    d.update(compose.pp_data(rng))
    moe = compose.moe_weights(rng)
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"step{n}") / "data.npz"
        np.savez(path, **d, **{f"lm/{k}": v for k, v in _flat(lm).items()},
                 **{f"moe/{k}": v for k, v in _flat(moe).items()},
                 cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    return dict(d, lm=lm, moe=moe, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world("step", tmp_path_factory.mktemp(f"stepworld{n}"), n,
                              data["paths"][n]) for n in (4, 2)}
    return {n: join_world(*started[n]) for n in (4, 2)}


_JAX: dict = {}


def _jax_train(data, n, case):
    """JAX's step over the same plan: ``(losses, params tree)``. The LM
    cases that differ only in the port's attention path share one run."""
    from fluxmpi_tpu.models import TransformerLM as JaxLM
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step

    spec = CASES[n][case]
    if spec["kind"] == "moe":
        return compose.jax_moe_train(data, n, spec)
    if spec["kind"] == "pp":
        return compose.jax_pp_train(data, n, {k: spec[k] for k in ("plan", "w", "interleave")})
    key = (n, json.dumps(spec["plan"], sort_keys=True), spec.get("penalty"))
    if key in _JAX:
        return _JAX[key]
    plan = ParallelConfig(**spec["plan"]).resolve(jax.devices()[:n])
    model = JaxLM(**LM)
    penalty = spec.get("penalty")

    def loss_fn(p, ms, batch):
        ce = jnp.mean(model.apply({"params": p["params"]}, batch["x"], train=False,
                                  targets=batch["y"]))
        if penalty == "all":
            ce = ce + 0.1 * sum(jnp.linalg.norm(w) for w in jax.tree_util.tree_leaves(p))
        elif penalty is not None:
            ce = ce + 0.1 * jnp.linalg.norm(_flat(p["params"])[penalty.replace(".", "/")])
        return ce, ms

    opt = optax.sgd(LR)
    state, _ = plan.shard_state(TrainState.create({"params": data["lm"]}, opt))
    step = make_train_step(loss_fn, opt, parallel=plan)
    losses = []
    for b in range(3):
        sl = slice(8 * b, 8 * b + 8)
        state, loss = step(state, {"x": data["tokens"][sl], "y": data["targets"][sl]})
        losses.append(float(loss))
    _JAX[key] = (np.array(losses), state.params["params"])
    return _JAX[key]


@pytest.mark.parametrize("n,case", TRAINED, ids=[f"{n}-{c}" for n, c in TRAINED])
def test_step_over_the_plan_trains_like_jax(world, worlds, data, n, case):
    losses, tree = _jax_train(data, n, case)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res[f"{case}/losses"], losses, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, arr in _flat(tree).items():
            got = res[f"{case}/param/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{r} {name}")


def test_c18_every_claimed_leaf_with_an_outside_reader_stays_gathered(world, worlds):
    """Under tp the layers claim their leaves; a penalty on every
    parameter reads each of them outside the layers, so none is handed
    over as a block; a penalty on one ff1 kernel keeps that layer's group
    (ff1 kernel and bias, ff2 kernel) gathered and no other."""
    for res in worlds[2] + worlds[4]:
        for case in ("c18_tp", "c18_dp_tp"):
            if f"{case}/tp_blocks" in res:
                assert res[f"{case}/tp_blocks"].tolist() == []
    blocks = set(worlds[2][0]["c18_tp_ff1/tp_blocks"].tolist())
    group = {"encoder.block_0.ff1.kernel", "encoder.block_0.ff1.bias",
             "encoder.block_0.ff2.kernel"}
    assert not blocks & group
    assert {"encoder.block_1.ff1.kernel", "encoder.block_0.attn.query.kernel",
            "embed.embedding"} <= blocks


def test_sequence_parallel_refusals_name_their_gap(world, worlds):
    """A loss that no sequence-parallel layer enters, and an attention_fn
    that is not sequence-parallel, raise at the first update naming sp.
    Every composition of the plan's axes trains (sp with ep, pp with tp,
    ep and sp, the MoE LM under sp: the cases above), so no step refuses
    a plan any more."""
    msg = str(worlds[2][0]["sp_no_layer_refused/raised"])
    assert msg.startswith("ValueError: under a plan with sp=2") and "sequence block" in msg
    msg = str(worlds[2][0]["sp_fn_refused/raised"])
    assert msg.startswith("ValueError:") and "not sequence-parallel over 'sp'" in msg
    for n in (2, 4):
        for r, res in enumerate(worlds[n]):
            assert not any(k.endswith("/raised") and "NotImplementedError" in str(v)
                           for k, v in res.items()), (n, r)


def test_dense_dropout_under_sp_equals_the_no_plan_run(world, worlds):
    """The LM's dense attention dropout under ``sp=2``: each ring tick
    drops its slice of the mask the whole-sequence attend draws from the
    same generator, so losses and parameters equal the port's no-plan run
    on the global batches (within the f32 rounding of the ring's online
    softmax)."""
    for r, res in enumerate(worlds[2]):
        np.testing.assert_allclose(res["dropout_sp/sp/losses"], res["dropout_sp/none/losses"],
                                   atol=ATOL, rtol=0, err_msg=f"rank {r}")
        names = [k for k in res if k.startswith("dropout_sp/none/param/")]
        assert names
        for k in names:
            np.testing.assert_allclose(res[k.replace("/none/", "/sp/")], res[k], atol=ATOL,
                                       rtol=0, err_msg=f"rank {r} {k}")
    # It drops: the first update's loss differs from the dropout-free LM's.
    assert abs(float(worlds[2][0]["dropout_sp/sp/losses"][0])
               - float(worlds[2][0]["lm_sp_ring_fn/losses"][0])) > 1e-4


def test_a_moe_layer_built_with_a_mesh_is_refused_in_a_pipeline_stage(world):
    """Both packages refuse an ``MoEMLP`` built with ``mesh=`` inside a
    pipeline stage (pp=2 x ep=2): JAX's sharding pins inside its
    ``shard_map`` over pp, the port before any exchange, naming the
    reason."""
    from fluxmpi_tpu.models import MoEMLP as JaxMoE
    from fluxmpi_tpu.parallel import ParallelConfig as JaxConfig
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn as jax_pipe
    from fluxmpi_tpu_torch.models import MoEMLP
    from fluxmpi_tpu_torch.parallel import make_pipeline_fn
    from fluxmpi_tpu_torch.parallel.sharding import Mesh

    jmesh = JaxConfig(pp=2, ep=2).resolve(jax.devices()[:4]).mesh
    jlayer = JaxMoE(num_experts=4, d_ff=8, mesh=jmesh)
    jp = jlayer.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 8)))["params"]
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jp)
    pipe = jax_pipe(lambda p, h: h + jlayer.apply({"params": p}, h), jmesh,
                    n_microbatches=2, axis_name="pp")
    with pytest.raises(ValueError):
        pipe(stacked, jnp.ones((4, 2, 8)))
    layer = MoEMLP(num_experts=4, d_ff=8, d_model=8, mesh=Mesh(np.arange(4).reshape(2, 2),
                                                             ("pp", "ep")), device="cpu")
    tpipe = make_pipeline_fn(lambda p, h: h + p["w"] * layer(h), layer.mesh,
                             n_microbatches=2, axis_name="pp")
    with pytest.raises(ValueError, match="pipeline stage.*mesh="):
        tpipe({"w": torch.ones(2, 8)}, torch.ones(4, 2, 8))
