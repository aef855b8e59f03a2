"""``make_train_step(parallel=)`` over ``sp`` with ``tp`` (ROADMAP A.6's
gap that the examples use), and the zigzag LM of
``examples_torch/long_context_zigzag.py``, in real gloo worlds spawned
once each (``tests/_torch_seq_worker.py``: group ``step`` at 4 and 8
ranks, group ``zigzag`` at 4), held to the JAX package on as many of its
8 CPU devices, from the same flax weights (``models/convert.py``) and
global batches, 3 updates each:

- the LM under ``ParallelConfig(sp=2, tp=2)`` and ``(dp=2, sp=2, tp=2)``:
  each tp worker runs its heads, columns and vocab rows, the ring runs
  over the sp group on those heads (dense, and flash through the kernels'
  plain versions), with ``remat=True``, and with C.18's penalty on every
  parameter (so every claimed leaf stays gathered); JAX's partitioned
  step computes global attention;
- a Ulysses plan whose worker's heads do not divide by sp is refused,
  naming the sizes;
- at 8 ranks, two more compositions (``tests/_torch_compose.py``): the
  MoE LM under ``dp=2, sp=2, ep=2`` (each group routed whole over the sp
  group, tokens exchanged over the ep group at the worker's sp index) and
  a ``make_pipeline_fn`` loss under ``dp=2, pp=2, tp=2`` (tp replicates
  the pipeline);
- the zigzag LM at 4 ranks (dp=1, sp=4): the example's per-block LM
  (local positions, zigzag ring attention over the kernels' plain
  versions) and its global next-token loss, against the JAX example's
  loss under ``shard_map`` with the same permutation. Both update with
  ``sgd(0.1)``, not the example's ``adam(1e-3)``: the key biases'
  gradient is zero in exact arithmetic (a constant added to every score
  of a query), and adam scales each framework's rounding noise there to a
  step of the learning rate's size.

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

import _torch_compose as compose
from _torch_worlds import join_world, start_world

ATOL = 2e-5
LR = 0.1
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)
ZZ = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)


def _lm(plan, **kw):
    return dict(kind="lm", plan=plan, **kw)


CASES = {
    4: {
        "sp_tp": _lm(dict(sp=2, tp=2)),
        "sp_tp_flash": _lm(dict(sp=2, tp=2), attention="flash"),
        "sp_tp_remat": _lm(dict(sp=2, tp=2), remat=True),
        "sp_tp_c18": _lm(dict(sp=2, tp=2), penalty="all"),
        "sp_tp_ulysses_refused": _lm(dict(sp=2, tp=2), fn="ulysses_fn", refused=True),
    },
    8: {
        "dp_sp_tp": _lm(dict(dp=2, sp=2, tp=2)),
        "dp_sp_tp_flash": _lm(dict(dp=2, sp=2, tp=2), attention="flash", remat=True),
        "dp_sp_tp_c18": _lm(dict(dp=2, sp=2, tp=2), penalty="all", remat=True),
        "moe_dp_sp_ep": dict(kind="moe", plan=dict(dp=2, sp=2, ep=2)),
        "pp_dp_tp": dict(kind="pp", plan=dict(dp=2, pp=2, tp=2), w="pp", interleave=1),
    },
}
TRAINED = [(n, c) for n in (4, 8) for c, s in CASES[n].items() if not s.get("refused")]

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


def _weights(rng, shape_kw):
    from fluxmpi_tpu.models import TransformerLM as JaxLM

    lm = JaxLM(**shape_kw).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                                train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), lm)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    lm = _weights(rng, LM)
    zz = _weights(rng, ZZ)
    d = dict(tokens=rng.integers(0, 32, (40, 16)).astype(np.int32),
             targets=rng.integers(0, 32, (40, 16)).astype(np.int32),
             zz_tokens=rng.integers(0, 32, (3, 2, 16)).astype(np.int32))
    d.update(compose.pp_data(rng))
    moe = compose.moe_weights(rng)
    paths = {}
    for n in (4, 8):
        path = tmp_path_factory.mktemp(f"sptp{n}") / "data.npz"
        np.savez(path, **d, **{f"lm/{k}": v for k, v in _flat(lm).items()},
                 **{f"moe/{k}": v for k, v in _flat(moe).items()},
                 cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    path = tmp_path_factory.mktemp("zigzag") / "data.npz"
    np.savez(path, **d, **{f"lm/{k}": v for k, v in _flat(zz).items()},
             cases=np.array(json.dumps({"zigzag": dict(lm=ZZ, sp=4)})))
    paths["zigzag"] = path
    return dict(d, lm=lm, zz=zz, moe=moe, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world("step", tmp_path_factory.mktemp(f"sptpworld{n}"), n,
                              data["paths"][n]) for n in (4, 8)}
    started["zigzag"] = start_world("zigzag", tmp_path_factory.mktemp("zzworld"), 4,
                                    data["paths"]["zigzag"])
    return {n: join_world(*w) for n, w in started.items()}


_JAX: dict = {}


def _jax_train(data, n, case):
    """JAX's step over the same plan: ``(losses, params tree)``; the cases
    that differ only in the port's attention path or remat share a run."""
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
def test_sp_with_tp_trains_like_jax(world, worlds, data, n, case):
    losses, tree = _jax_train(data, n, case)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res[f"{case}/losses"], losses, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, arr in _flat(tree).items():
            got = res[f"{case}/param/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{r} {name}")


def test_sp_tp_blocks_and_c18_reads(world, worlds):
    """From the second update the layers run on their tp blocks under sp;
    a penalty on every parameter keeps every claimed leaf gathered."""
    for case, n in (("sp_tp", 4), ("dp_sp_tp", 8)):
        for res in worlds[n]:
            assert "encoder.block_0.attn.query.kernel" in res[f"{case}/tp_blocks"].tolist()
    for case, n in (("sp_tp_c18", 4), ("dp_sp_tp_c18", 8)):
        for res in worlds[n]:
            assert res[f"{case}/tp_blocks"].tolist() == []


def test_ulysses_under_tp_is_refused_naming_the_sizes(world, worlds):
    msg = str(worlds[4][0]["sp_tp_ulysses_refused/raised"])
    assert msg.startswith("ValueError: Ulysses over 'sp' of size 2 under tp=2"), msg
    assert "holds 1 of the 2 heads" in msg, msg


def _jax_zigzag(data, sp):
    """The JAX example's loss and update (``examples/long_context_zigzag.py``:
    the LM per block under ``shard_map`` with zigzag ring attention, the
    logits un-permuted, the shifted CE) on ``sp`` CPU devices."""
    from jax.sharding import PartitionSpec as P

    from fluxmpi_tpu.models import TransformerLM as JaxLM
    from fluxmpi_tpu.parallel import TrainState, make_train_step
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked
    from fluxmpi_tpu.parallel.ring import zigzag_indices, zigzag_ring_attention

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:sp]).reshape(1, sp), ("dp", "sp"))
    model = JaxLM(**ZZ, attention_fn=lambda q, k, v, bias=None, mask=None, **kw:
                  zigzag_ring_attention(q, k, v, axis_name="sp"))
    seq = ZZ["max_len"]
    idxs = zigzag_indices(seq, sp)

    def loss_fn(p, mstate, toks_perm):
        logits = shard_map_unchecked(
            lambda p, t: model.apply(p, t, train=False), mesh=mesh,
            in_specs=(P(), P("dp", "sp")), out_specs=P("dp", "sp"))(p, toks_perm)
        inv = jnp.argsort(jnp.asarray(idxs))
        logits, toks = logits[:, inv], toks_perm[:, inv]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], toks[:, 1:]).mean(), mstate

    opt = optax.sgd(LR)
    step = make_train_step(loss_fn, opt, mesh=mesh, style="auto",
                           batch_spec=P("dp", "sp"))
    state = TrainState.create({"params": data["zz"]}, opt)
    losses = []
    for toks in data["zz_tokens"]:
        state, loss = step(state, jnp.asarray(toks)[:, idxs])
        losses.append(float(loss))
    return np.array(losses), state.params["params"]


def test_zigzag_lm_of_the_example_trains_like_jax(world, worlds, data):
    losses, tree = _jax_zigzag(data, 4)
    for r, res in enumerate(worlds["zigzag"]):
        np.testing.assert_allclose(res["zigzag/losses"], losses, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, arr in _flat(tree).items():
            np.testing.assert_allclose(res[f"zigzag/param/{name.replace('/', '.')}"],
                                       np.asarray(arr), atol=ATOL, rtol=0,
                                       err_msg=f"{r} {name}")


def test_c22_remat_recompute_re_enters_the_parallel_contexts():
    """ROADMAP C.22: under ``remat=`` the forward is recomputed where the
    backward runs. On the card that is autograd's device thread, which
    does not see the caller's thread-local tensor- and sequence-parallel
    contexts: the recompute took the plain path (a step over ``sp`` with
    ``remat=True`` failed on four cards: 92 tensors saved in the forward,
    70 in the recompute). Here the backward runs on another thread, as it
    does there: the recompute must see the forward's contexts, and the
    gradient equal the one without remat."""
    import threading

    from fluxmpi_tpu_torch import _sequence_parallel, _tensor_parallel
    from fluxmpi_tpu_torch.parallel import train
    from fluxmpi_tpu_torch.parallel.sharding import Mesh

    def loss(p, ms, b):
        seen = (_sequence_parallel.current() is not None) + 2 * (
            _tensor_parallel.current() is not None)
        return (p["w"] * (1.0 + seen)).sin().sum() * b, ms

    grads = {}
    for remat in (False, True):
        fn = train._with_policy_and_remat(loss, None, remat, train._CastWatch())
        w = torch.ones(3, requires_grad=True)
        seq = _sequence_parallel.SequenceParallel(Mesh(np.arange(1), ("sp",)), "sp")
        with _sequence_parallel.active(seq), _tensor_parallel.active(object()):
            value, _ = fn({"w": w}, None, 1.0)
        worker = threading.Thread(
            target=lambda: grads.update({remat: torch.autograd.grad(value, [w])[0]}))
        worker.start()
        worker.join()
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)
    torch.testing.assert_close(grads[False], 4 * torch.cos(torch.full((3,), 4.0)))
