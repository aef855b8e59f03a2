"""The JAX package's side of the plan compositions that
``tests/test_torch_sequence_step.py`` and ``tests/test_torch_sp_tp.py`` run
in the port's gloo worlds (``tests/_torch_seq_worker.py`` group ``step``):
the MoE LM's flax weights, and JAX's partitioned step over the same plan
from them, 3 updates of ``sgd(0.1)`` on the same global batches. A case
``dict(kind="moe", plan=..., moe=...)`` trains the tiny MoE LM (``moe``:
``top_k``, ``routing``, ``n_groups``; the port's ``attention`` and
``remat`` do not change JAX's side) on its mean cross-entropy plus 0.1
times the balance loss and 0.01 times the router z-loss; with ``ep`` in
the plan its experts are laid out over ``ep`` (``expert_parallel_rules``,
the model built with the plan's mesh)."""

import json

import numpy as np
import optax

import jax
import jax.numpy as jnp

LR = 0.1
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)
MOE = dict(LM, num_experts=4)
AUX, Z = 0.1, 0.01


def flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def moe_weights(rng):
    """The MoE LM's flax weights, moved off their init (zero biases, unit
    scales) so that every gradient is live."""
    from fluxmpi_tpu.models import MoETransformerLM

    params = MoETransformerLM(**MOE).init(jax.random.PRNGKey(2), jnp.zeros((2, 8), jnp.int32),
                                          train=False)["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), params)


_CACHE: dict = {}


def jax_moe_train(data, n, spec):
    """``(losses, params tree)`` of JAX's step over the case's plan on
    ``n`` of its CPU devices."""
    from fluxmpi_tpu.models import MoETransformerLM, collect_moe_losses, expert_parallel_rules
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step

    key = (n, json.dumps({k: spec.get(k) for k in ("plan", "moe")}, sort_keys=True))
    if key in _CACHE:
        return _CACHE[key]
    kw = dict(spec["plan"])
    ep = "ep" in kw
    if ep:
        kw["rules"] = expert_parallel_rules()
    plan = ParallelConfig(**kw).resolve(jax.devices()[:n])
    model = MoETransformerLM(**MOE, **spec.get("moe", {}), mesh=plan.mesh if ep else None)

    def loss_fn(p, ms, batch):
        ce, mut = model.apply({"params": p["params"]}, batch["x"], train=True,
                              targets=batch["y"], mutable=["losses"])
        aux, z = collect_moe_losses(mut["losses"])
        return jnp.mean(ce) + AUX * aux + Z * z, ms

    opt = optax.sgd(LR)
    state, _ = plan.shard_state(TrainState.create({"params": data["moe"]}, opt))
    step = make_train_step(loss_fn, opt, parallel=plan)
    losses = []
    for b in range(3):
        sl = slice(8 * b, 8 * b + 8)
        state, loss = step(state, {"x": data["tokens"][sl], "y": data["targets"][sl]})
        losses.append(float(loss))
    _CACHE[key] = (np.array(losses), state.params["params"])
    return _CACHE[key]


def pp_data(rng):
    """A ``make_pipeline_fn`` loss's inputs, targets and head, and its two
    stacked stage sets: ``pp`` (2 stages) and ``pp2`` (4 chunks over 2
    stages, ``interleave=2``)."""
    from fluxmpi_tpu.parallel.pipeline import stack_stage_params

    d = dict(pp_x=rng.normal(size=(40, 8)).astype(np.float32),
             pp_y=rng.normal(size=(40, 8)).astype(np.float32),
             pp_head=(0.3 * rng.normal(size=(8, 8))).astype(np.float32))
    for name, chunks, v in (("pp", 2, 1), ("pp2", 4, 2)):
        ws = [(0.5 * rng.normal(size=(8, 8))).astype(np.float32) for _ in range(chunks)]
        bs = [rng.normal(size=(8,)).astype(np.float32) for _ in range(chunks)]
        st = stack_stage_params([{"w": w, "b": b} for w, b in zip(ws, bs)],
                                n_stages=2, interleave=v)
        d[f"{name}_w"], d[f"{name}_b"] = np.asarray(st["w"]), np.asarray(st["b"])
    return d


def _stage_fn(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


def jax_pp_train(data, n, spec):
    """``(losses, params tree)`` of JAX's step over the case's plan
    (``pipeline_rules`` for the stacked stages, the rest replicated) with
    the loss ``mean((pipe(x) @ head - y) ** 2)``, GPipe or interleaved."""
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step
    from fluxmpi_tpu.parallel.pipeline import make_pipeline_fn, pipeline_rules

    key = (n, json.dumps(spec, sort_keys=True))
    if key in _CACHE:
        return _CACHE[key]
    rule = pipeline_rules("pp")
    plan = ParallelConfig(**spec["plan"], rules=lambda path, shape: (
        rule(path, shape) if "stages" in path else jax.sharding.PartitionSpec())).resolve(
        jax.devices()[:n])
    pipe = make_pipeline_fn(_stage_fn, plan.mesh, n_microbatches=4, axis_name="pp",
                            interleave=spec.get("interleave", 1))
    w = spec.get("w", "pp")
    params = {"stages": {"w": data[f"{w}_w"], "b": data[f"{w}_b"]}, "head": data["pp_head"]}

    def loss_fn(p, ms, batch):
        y = pipe(p["stages"], batch["x"])
        return jnp.mean((y @ p["head"] - batch["y"]) ** 2), ms

    opt = optax.sgd(LR)
    state, _ = plan.shard_state(TrainState.create(params, opt))
    step = make_train_step(loss_fn, opt, parallel=plan)
    losses = []
    for b in range(3):
        sl = slice(8 * b, 8 * b + 8)
        state, loss = step(state, {"x": data["pp_x"][sl], "y": data["pp_y"][sl]})
        losses.append(float(loss))
    _CACHE[key] = (np.array(losses), state.params)
    return _CACHE[key]
