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
- the refusals: a loss that enters no sequence-parallel layer, an
  ``attention_fn`` that is not sequence-parallel, the MoE LM's routed
  feed-forward under sp, sp with ep and pp with tp (sp with tp trains
  since slice 15, the ``sp_tp`` case).

Every update's loss and every parameter block (shape and values, against
JAX's addressable shard on the same mesh coordinate) within 2e-5.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

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
        "sp_ep_refused": _lm(dict(sp=2, ep=2), refused=True),
        "pp_tp_refused": _pp(dict(pp=2, tp=2)) | dict(refused=True),
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
        "sp_moe_refused": dict(kind="moe", plan=dict(sp=2), refused=True),
    },
}
TRAINED = [(n, c) for n in (4, 2) for c, s in CASES[n].items() if not s.get("refused")]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.models import TransformerLM as JaxLM
    from fluxmpi_tpu.parallel.pipeline import stack_stage_params

    rng = np.random.default_rng(0)
    lm = JaxLM(**LM).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                          train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    lm = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), lm)
    d = dict(tokens=rng.integers(0, 32, (40, 16)).astype(np.int32),
             targets=rng.integers(0, 32, (40, 16)).astype(np.int32),
             pp_x=rng.normal(size=(40, 8)).astype(np.float32),
             pp_y=rng.normal(size=(40, 8)).astype(np.float32),
             pp_head=(0.3 * rng.normal(size=(8, 8))).astype(np.float32))
    for name, chunks, v in (("pp", 2, 1), ("pp2", 4, 2)):
        ws = [(0.5 * rng.normal(size=(8, 8))).astype(np.float32) for _ in range(chunks)]
        bs = [rng.normal(size=(8,)).astype(np.float32) for _ in range(chunks)]
        st = stack_stage_params([{"w": w, "b": b} for w, b in zip(ws, bs)],
                                n_stages=2, interleave=v)
        d[f"{name}_w"], d[f"{name}_b"] = np.asarray(st["w"]), np.asarray(st["b"])
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"step{n}") / "data.npz"
        np.savez(path, **d, **{f"lm/{k}": v for k, v in _flat(lm).items()},
                 cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    return dict(d, lm=lm, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world("step", tmp_path_factory.mktemp(f"stepworld{n}"), n,
                              data["paths"][n]) for n in (4, 2)}
    return {n: join_world(*started[n]) for n in (4, 2)}


def _stage_fn(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


_JAX: dict = {}


def _jax_train(data, n, case):
    """JAX's step over the same plan: ``(losses, params tree)``. The LM
    cases that differ only in the port's attention path share one run."""
    from fluxmpi_tpu.models import TransformerLM as JaxLM
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn, pipeline_rules

    spec = CASES[n][case]
    key = (n, json.dumps(spec["plan"], sort_keys=True), spec["kind"], spec.get("penalty"),
           spec.get("w"))
    if key in _JAX:
        return _JAX[key]
    devs = jax.devices()[:n]
    kw = dict(spec["plan"])
    if spec["kind"] == "pp":
        rule = pipeline_rules("pp")
        kw["rules"] = lambda path, shape: (rule(path, shape) if "stages" in path
                                           else jax.sharding.PartitionSpec())
    plan = ParallelConfig(**kw).resolve(devs)
    if spec["kind"] == "pp":
        pipe = make_pipeline_fn(_stage_fn, plan.mesh, n_microbatches=4, axis_name="pp",
                                interleave=spec["interleave"])
        params = {"stages": {"w": data[f"{spec['w']}_w"], "b": data[f"{spec['w']}_b"]},
                  "head": data["pp_head"]}

        def loss_fn(p, ms, batch):
            y = pipe(p["stages"], batch["x"])
            return jnp.mean((y @ p["head"] - batch["y"]) ** 2), ms

        xs, ys = data["pp_x"], data["pp_y"]
    else:
        model = JaxLM(**LM)
        params = data["lm"]
        penalty = spec.get("penalty")

        def loss_fn(p, ms, batch):
            ce = jnp.mean(model.apply({"params": p["params"]}, batch["x"], train=False,
                                      targets=batch["y"]))
            if penalty == "all":
                ce = ce + 0.1 * sum(jnp.linalg.norm(w) for w in jax.tree_util.tree_leaves(p))
            elif penalty is not None:
                ce = ce + 0.1 * jnp.linalg.norm(_flat(p["params"])[penalty.replace(".", "/")])
            return ce, ms

        xs, ys = data["tokens"], data["targets"]
    opt = optax.sgd(LR)
    state = TrainState.create({"params": params} if spec["kind"] == "lm" else params, opt)
    state, _ = plan.shard_state(state)
    step = make_train_step(loss_fn, opt, parallel=plan)
    losses = []
    for b in range(3):
        state, loss = step(state, {"x": xs[8 * b:8 * b + 8], "y": ys[8 * b:8 * b + 8]})
        losses.append(float(loss))
    tree = state.params["params"] if spec["kind"] == "lm" else state.params
    _JAX[key] = (np.array(losses), tree)
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
    that is not sequence-parallel, raise at the first update naming sp;
    sp with ep and pp with tp raise when the step is built, naming the
    open gap."""
    msg = str(worlds[2][0]["sp_no_layer_refused/raised"])
    assert msg.startswith("ValueError: under a plan with sp=2") and "sequence block" in msg
    msg = str(worlds[2][0]["sp_fn_refused/raised"])
    assert msg.startswith("ValueError:") and "not sequence-parallel over 'sp'" in msg
    # sp with tp trains (the sp_tp case); sp with ep and pp with tp still
    # raise naming the gap.
    msg = str(worlds[4][0]["sp_ep_refused/raised"])
    assert msg.startswith("NotImplementedError:") and "sp=2 and ep=2" in msg, msg
    msg = str(worlds[4][0]["pp_tp_refused/raised"])
    assert msg.startswith("NotImplementedError:") and "pp=2 and tp=2" in msg, msg
    # The MoE layers route each whole sequence as one group.
    msg = str(worlds[2][0]["sp_moe_refused/raised"])
    assert msg.startswith("NotImplementedError: the feed-forward sublayer 'moe'"), msg
