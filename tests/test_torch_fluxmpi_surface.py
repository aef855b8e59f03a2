"""The rest of the FluxMPI surface in real 2- and 4-rank worlds (one
process per rank, ``torch.distributed`` over gloo through a ``FileStore``,
one thread each, a join timeout), held to the reference's own test oracles
(SURVEY.md §4): sum-scaling and identity under ``*`` (``iallreduce`` as
``Iallreduce!``, and the blocking ``allreduce``), the root-ones pattern
(``ibcast``, ``bcast``), ``reduce`` leaving its result on the root only,
shard-sum conservation; ``iallreduce``/``ibcast`` after ``wait()`` /
``wait_all()`` equal to the blocking calls; ``host_*`` equal to numpy;
``donate=True`` returning the caller's tensor; ``FluxModelWrapper``
letting the root win through nested attributes and an ``nn.Module``; and
``FlatParamVector`` round-tripping and synchronizing (and all-reducing a
step's gradient) in one collective.

Two BatchNorm steps in each world, against the JAX package on as many of
its 8 CPU devices, from the same converted weights and the same global
batch of 8 (each rank its share):

- C.5: ``make_train_step``'s default ``state_reduce="mean"`` averages the
  new running statistics over the ranks, as the JAX ``style="shard_map"``
  step does; ``"local"`` keeps each rank's own (the parent's behaviour,
  which this comparison refused).
- sync-BN: ``CNN(axis_name="dp")`` on 2 ranks of 4 samples (4 of 2) gives
  the loss, every gradient and the statistics of the JAX ``style="auto"``
  step and of the port in one process on all 8 samples.

Tolerances: collectives exact; f32 BatchNorm steps atol 1e-5 on the
statistics and the loss, gradients ``max|diff| / max|g| <= 1e-4`` per leaf
(sums over other splits of the batch).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from fluxmpi_tpu.models import CNN as JaxCNN
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel.train import replicate, shard_batch
from fluxmpi_tpu_torch.models import CNN, load_flax_variables, to_flax_params

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 240
LR_C5, LR_SYNC = 0.1, 1.0

torch.set_num_threads(1)

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    torch.set_num_threads(1)
    rank, world, store_path, out, data_path = (int(sys.argv[1]), int(sys.argv[2]),
                                               sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import CNN, MLP, load_flax_variables
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    fm.init(device="cpu")
    res = {"local_device_count": fm.local_device_count()}
    ones = torch.ones(3)

    def calls(name, fn):
        """fn() and the number of torch.distributed.<name> calls it made."""
        real, count = getattr(dist, name), [0]

        def counted(*a, **k):
            count[0] += 1
            return real(*a, **k)

        setattr(dist, name, counted)
        try:
            return fn(), count[0]
        finally:
            setattr(dist, name, real)

    # Sum-scaling and identity under *, non-blocking and blocking.
    v, req = fm.iallreduce(ones, "+")
    res["iallreduce_sum"] = req.wait().numpy()
    res["iallreduce_value_is_result"] = v is req.wait()
    res["iallreduce_prod"] = fm.iallreduce(ones, "*")[1].wait().numpy()
    res["allreduce_sum"] = fm.allreduce(ones, "+").numpy()
    res["allreduce_prod"] = fm.allreduce(ones, "*").numpy()
    # The root-ones pattern.
    root = world - 1
    pattern = torch.ones(3) if rank == root else torch.zeros(3)
    res["ibcast_root"] = fm.ibcast(pattern, root)[1].wait().numpy()
    res["bcast_root"] = fm.bcast(pattern, root).numpy()
    # reduce: the root only.
    mine = torch.full((2,), float(rank + 1))
    res["reduce_sum"] = fm.reduce(mine, "+", root).numpy()
    # Shard-sum conservation over the loader's container.
    data = np.arange(1, 11, dtype=np.float64)
    shard = fm.DistributedDataContainer(data)
    res["shard_total"] = fm.allreduce(torch.tensor(float(sum(shard)))).numpy()
    # Non-blocking == blocking, on a tree of two dtypes, per op.
    tree = {"f": torch.arange(4.0) * (rank + 1), "i": torch.tensor([rank + 2, 7 - rank])}
    for op in ("sum", "mean", "max", "min", "prod"):
        val, req = fm.iallreduce(tree, op)
        got, want = req.wait(), fm.allreduce(tree, op)
        res[f"i_eq_{op}"] = all(torch.equal(got[k], want[k]) and torch.equal(val[k], got[k])
                                for k in tree)
    reqs = [fm.ibcast(tree, r)[1] for r in range(world)]
    waited = fm.Request.wait_all(reqs)
    res["ibcast_eq"] = all(torch.equal(w[k], fm.bcast(tree, r)[k])
                           for r, w in enumerate(waited) for k in tree)
    # host_*: numpy in, numpy out.
    h = np.array([rank + 1, 10 * (rank + 1)], np.int32)
    for op in ("sum", "max", "mean"):
        res[f"host_allreduce_{op}"] = fm.host_allreduce(h, op)
    res["host_allreduce_type"] = isinstance(fm.host_allreduce(h), np.ndarray)
    res["host_allgather"] = fm.host_allgather(h.astype(np.float32))
    res["host_bcast"] = fm.host_bcast(h, root)
    # donate=True: in place, the caller's tensor back.
    t = torch.full((4,), float(rank + 1))
    res["donate_allreduce_same"] = fm.allreduce(t, donate=True) is t
    res["donate_allreduce"] = t.numpy().copy()
    t = torch.full((4,), float(rank + 1))
    res["donate_bcast_same"] = fm.bcast(t, root, donate=True) is t
    res["donate_bcast"] = t.numpy().copy()
    t = torch.full((4,), float(rank + 1))
    res["donate_reduce_same"] = fm.reduce(t, "+", root, donate=True) is t
    res["donate_reduce"] = t.numpy().copy()
    fm.barrier(tag="after_donate")

    # FluxModelWrapper: the root wins through nested objects and a module.
    class Inner:
        def __init__(self, r):
            self.w = torch.full((2, 2), float(r))
            self.n = r
            self.module = MLP((4, 1), device="cpu",
                              generator=torch.Generator().manual_seed(100 + r))

    class Outer:
        def __init__(self, r):
            self.a = torch.arange(3) + r
            self.inner = Inner(r)
            self.items = [torch.tensor([float(r)])]
            self._private = torch.tensor(float(r))

    obj = Outer(rank)
    wrapped = fm.synchronize(fm.FluxModelWrapper(obj))
    res["wrapper_type"] = isinstance(wrapped, fm.FluxModelWrapper) and wrapped.model is obj
    res["wrapper_a"] = obj.a.numpy()
    res["wrapper_inner_w"] = obj.inner.w.numpy()
    res["wrapper_inner_n"] = obj.inner.n
    res["wrapper_items"] = obj.items[0].numpy()
    res["wrapper_private"] = obj._private.numpy()
    for name, p in obj.inner.module.named_parameters():
        res["wrapper_module/" + name] = p.detach().numpy()

    # FlatParamVector: round trip, one collective for a sync and for a step.
    ftree = {"w": torch.full((3, 2), float(rank)), "b": torch.arange(2) + rank}
    fpv = fm.FlatParamVector.from_tree(ftree)
    back = fpv.to_tree()
    res["fpv_roundtrip"] = (len(fpv) == 8 and back["b"].dtype == torch.int64
                            and back["w"].shape == (3, 2)
                            and all(torch.equal(back[k], ftree[k]) for k in ftree))
    synced, n = calls("broadcast", lambda: fm.synchronize(fpv))
    res["fpv_sync_calls"] = n
    res["fpv_sync_type"] = isinstance(synced, fm.FlatParamVector)
    res["fpv_synced_w"] = synced.to_tree()["w"].numpy()
    spec = fm.FlatParamVector.from_tree({"W": torch.zeros(3, 1), "b": torch.zeros(1)})
    flat = torch.nn.Parameter(torch.zeros(4))

    def fpv_loss(params, ms, batch):
        p = fm.FlatParamVector(params["flat"], spec._shapes, spec._treedef, spec._sizes,
                               spec._dtypes).to_tree()
        return ((batch[0] @ p["W"] + p["b"] - batch[1]) ** 2).mean(), ms

    opt = optim.sgd(0.1)
    fpv_step = make_train_step(fpv_loss, opt)
    xb = torch.randn(4, 3, generator=torch.Generator().manual_seed(rank))
    _, n = calls("all_reduce", lambda: fpv_step(TrainState.create({"flat": flat}, opt),
                                                (xb, xb.sum(1, keepdim=True))))
    res["fpv_step_all_reduce_calls"] = n

    # The BatchNorm steps: each rank its share of the global batch of 8.
    z = np.load(data_path)
    x, y = z["x"], z["y"]
    half = slice(rank * 8 // world, (rank + 1) * 8 // world)
    variables = {"params": {}, "batch_stats": {}}
    for key in z.files:
        if key.startswith(("params/", "batch_stats/")):
            coll, *path = key.split("/")
            node = variables[coll]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = z[key]

    def bn_step(axis_name, lr, state_reduce="mean"):
        model, ms = load_flax_variables(CNN(4, (4, 8), axis_name=axis_name,
                                            device="cpu"), variables)

        def loss_fn(p, ms, b):
            logits, new = model(b[0], ms, train=True)
            return F.cross_entropy(logits, b[1].long()), new

        opt = optim.sgd(lr)
        st = TrainState.create(model, opt, model_state=ms)
        before = {k: v.detach().clone() for k, v in st.params.items()}
        st, loss = make_train_step(loss_fn, opt, state_reduce=state_reduce)(
            st, (torch.from_numpy(x[half]), torch.from_numpy(y[half])))
        return st, loss, before

    for mode in ("mean", "local"):
        st, _, _ = bn_step(None, 0.1, mode)
        for k, v in st.model_state.items():
            res[f"c5_{mode}/{k}"] = v.numpy()
    st, loss, before = bn_step("dp", 1.0)
    res["sync_loss"] = loss.numpy()
    for k, v in st.params.items():
        res["sync_grad/" + k] = ((before[k] - v.detach()) / 1.0).numpy()
    for k, v in st.model_state.items():
        res["sync_stats/" + k] = v.numpy()

    np.savez(out, **res)
    fm.shutdown()
    dist.destroy_process_group()
''')


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def bn_data(tmp_path_factory):
    """A small CNN's flax variables and a global batch of 8, in an npz the
    ranks read."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 8).astype(np.int32)
    jm = JaxCNN(num_classes=4, channels=(4, 8))
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    path = tmp_path_factory.mktemp("bn") / "data.npz"
    np.savez(path, x=x, y=y, **{f"params/{k}": a for k, a in _flat(v["params"]).items()},
             **{f"batch_stats/{k}": a for k, a in _flat(v["batch_stats"]).items()})
    return dict(x=x, y=y, variables=v, path=path)


def _run_world(tmp, world, data_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), str(tmp / "store"),
             str(tmp / f"rank{rank}.npz"), str(data_path)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, bn_data):
    """Each rank's results in the 2-rank and the 4-rank world."""
    return {n: _run_world(tmp_path_factory.mktemp(f"world{n}"), n, bn_data["path"])
            for n in (2, 4)}


@pytest.fixture(params=[2, 4])
def ranks(request, worlds):
    return request.param, worlds[request.param]


def test_reference_oracles(ranks):
    world, rs = ranks
    root = world - 1
    for rank, r in enumerate(rs):
        assert int(r["local_device_count"]) == 1
        for k in ("iallreduce_sum", "allreduce_sum"):
            np.testing.assert_array_equal(r[k], np.full(3, float(world)))
        for k in ("iallreduce_prod", "allreduce_prod"):
            np.testing.assert_array_equal(r[k], np.ones(3))
        assert bool(r["iallreduce_value_is_result"])
        for k in ("ibcast_root", "bcast_root"):
            np.testing.assert_array_equal(r[k], np.ones(3))
        want = world * (world + 1) / 2 if rank == root else rank + 1
        np.testing.assert_array_equal(r["reduce_sum"], np.full(2, float(want)))
        assert float(r["shard_total"]) == 55.0


def test_nonblocking_equals_blocking(ranks):
    _, rs = ranks
    for r in rs:
        for op in ("sum", "mean", "max", "min", "prod"):
            assert bool(r[f"i_eq_{op}"]), op
        assert bool(r["ibcast_eq"])


def test_host_collectives_equal_numpy(ranks):
    world, rs = ranks
    per_rank = np.stack([np.array([k + 1, 10 * (k + 1)], np.int32) for k in range(world)])
    for r in rs:
        assert bool(r["host_allreduce_type"])
        np.testing.assert_array_equal(r["host_allreduce_sum"], per_rank.sum(0))
        assert r["host_allreduce_sum"].dtype == np.int32
        np.testing.assert_array_equal(r["host_allreduce_max"], per_rank.max(0))
        np.testing.assert_allclose(r["host_allreduce_mean"], per_rank.mean(0))
        np.testing.assert_array_equal(r["host_allgather"], per_rank.astype(np.float32))
        np.testing.assert_array_equal(r["host_bcast"], per_rank[world - 1])


def test_donate_returns_the_callers_tensor(ranks):
    world, rs = ranks
    total = world * (world + 1) / 2
    for rank, r in enumerate(rs):
        assert bool(r["donate_allreduce_same"]) and bool(r["donate_bcast_same"])
        assert bool(r["donate_reduce_same"])
        np.testing.assert_array_equal(r["donate_allreduce"], np.full(4, total))
        np.testing.assert_array_equal(r["donate_bcast"], np.full(4, float(world)))
        want = total if rank == world - 1 else rank + 1
        np.testing.assert_array_equal(r["donate_reduce"], np.full(4, float(want)))


def test_flux_model_wrapper_lets_the_root_win(ranks):
    from fluxmpi_tpu_torch.models import MLP

    _, rs = ranks
    root = MLP((4, 1), device="cpu", generator=torch.Generator().manual_seed(100))
    for rank, r in enumerate(rs):
        assert bool(r["wrapper_type"])
        np.testing.assert_array_equal(r["wrapper_a"], np.arange(3))
        np.testing.assert_array_equal(r["wrapper_inner_w"], np.zeros((2, 2)))
        assert int(r["wrapper_inner_n"]) == 0
        np.testing.assert_array_equal(r["wrapper_items"], [0.0])
        assert float(r["wrapper_private"]) == rank  # private attributes stay
        for name, p in root.named_parameters():
            np.testing.assert_array_equal(r["wrapper_module/" + name], p.detach().numpy())


def test_flat_param_vector_is_one_collective(ranks):
    _, rs = ranks
    for r in rs:
        assert bool(r["fpv_roundtrip"]) and bool(r["fpv_sync_type"])
        assert int(r["fpv_sync_calls"]) == 1
        np.testing.assert_array_equal(r["fpv_synced_w"], np.zeros((3, 2)))
        # The gradient and the loss ride in one f32 collective.
        assert int(r["fpv_step_all_reduce_calls"]) == 1


def _jax_bn_step(bn_data, style, lr, n):
    """One step of the JAX package on ``n`` CPU devices over the global
    batch."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    jm = JaxCNN(num_classes=4, channels=(4, 8))
    v = bn_data["variables"]

    def loss_fn(p, ms, b):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, b[0], train=True,
                               mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean(), \
            upd["batch_stats"]

    opt = optax.sgd(lr)
    kw = dict(grad_reduce="mean", state_reduce="mean") if style == "shard_map" else {}
    step = jax_make_train_step(loss_fn, opt, mesh=mesh, axis_name="dp", style=style,
                               donate=False, **kw)
    state = replicate(JaxTrainState.create(v["params"], opt, v["batch_stats"]), mesh)
    batch = shard_batch((jnp.asarray(bn_data["x"]), jnp.asarray(bn_data["y"])), mesh)
    state, loss = step(state, batch)
    grads = {k: (a - b) / lr for (k, a), b in zip(_flat(v["params"]).items(),
                                                    _flat(state.params).values())}
    return float(loss), grads, _flat(state.model_state)


def test_c5_state_reduce_mean_matches_jax_shard_map(world, ranks, bn_data):
    """C.5: the port's step averages the new BatchNorm statistics over the
    ranks, as JAX's ``style="shard_map"`` step with its default
    ``state_reduce="mean"``; ``"local"`` keeps each rank's own."""
    nranks, rs = ranks
    _, _, want = _jax_bn_step(bn_data, "shard_map", LR_C5, nranks)
    for r in rs:
        for k, s in want.items():
            np.testing.assert_allclose(r[f"c5_mean/{k.replace('/', '.')}"], s, atol=1e-5,
                                       rtol=0, err_msg=k)
    differ = [k for k in want if np.abs(rs[0][f"c5_local/{k.replace('/', '.')}"]
                                        - rs[1][f"c5_local/{k.replace('/', '.')}"]).max() > 1e-3]
    assert differ  # the ranks' own statistics differ: "mean" is doing the work
    for k in want:
        key = k.replace("/", ".")
        np.testing.assert_allclose(sum(r[f"c5_local/{key}"] for r in rs) / nranks,
                                   rs[0][f"c5_mean/{key}"], atol=1e-6, rtol=0)


def test_sync_bn_ranks_equal_the_global_batch(world, ranks, bn_data):
    """``CNN(axis_name="dp")`` on 2 ranks x 4 samples (4 x 2) = the JAX
    ``"auto"`` step on 8 = the port in one process on 8 (no
    ``axis_name``)."""
    nranks, rs = ranks
    jloss, jgrads, jstats = _jax_bn_step(bn_data, "auto", LR_SYNC, nranks)
    model, ms = load_flax_variables(CNN(4, (4, 8), device="cpu"), bn_data["variables"])
    logits, new = model(torch.from_numpy(bn_data["x"]), ms, train=True)
    loss = F.cross_entropy(logits, torch.from_numpy(bn_data["y"]).long())
    names = [n for n, _ in model.named_parameters()]
    one = to_flax_params(dict(zip(names, torch.autograd.grad(loss, list(model.parameters())))))
    for r in rs:
        assert abs(float(r["sync_loss"]) - jloss) <= 1e-5
        assert abs(float(r["sync_loss"]) - float(loss.detach())) <= 1e-5
        for k, g in jgrads.items():
            got = r["sync_grad/" + k.replace("/", ".")]
            for ref in (g, one[k]):
                assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), k
        for k, s in jstats.items():
            key = k.replace("/", ".")
            np.testing.assert_allclose(r["sync_stats/" + key], s, atol=1e-5, rtol=0)
            np.testing.assert_allclose(r["sync_stats/" + key], new[key].numpy(),
                                       atol=1e-5, rtol=0)


def test_config_shares_the_jax_packages_preferences(tmp_path, monkeypatch):
    """One preferences file, one namespace and the same keys: what one
    package sets the other reads; env overrides and the integer-knob parse
    behave alike."""
    from fluxmpi_tpu import config as jax_config
    from fluxmpi_tpu_torch import config

    monkeypatch.setenv("FLUXMPI_TPU_PREFS", str(tmp_path / "LocalPreferences.json"))
    config.set_preference("dp_axis_name", "data")
    assert jax_config.load_preference("dp_axis_name") == "data"
    jax_config.set_preference("donate_buffers", False)
    assert config.load_preference("donate_buffers") is False
    monkeypatch.setenv("FLUXMPI_TPU_DONATE_BUFFERS", "yes")
    assert config.load_preference("donate_buffers") is jax_config.load_preference(
        "donate_buffers") is True
    config.delete_preference("dp_axis_name")
    assert jax_config.load_preference("dp_axis_name") == "dp"
    with pytest.warns(UserWarning):
        config.disable_device_collectives()
    assert jax_config.load_preference("disable_device_collectives") is True
    monkeypatch.setenv("KNOB", "x")
    with pytest.warns(UserWarning, match="not an integer"):
        assert config.env_int("KNOB", 3) == jax_config.env_int("KNOB", 3) == 3
    monkeypatch.setenv("KNOB", "0")
    with pytest.warns(UserWarning, match=">= 1"):
        assert config.env_int("KNOB", 2, minimum=1) == 2


def test_cpu_and_device_move_arrays_and_leave_the_rest():
    import fluxmpi_tpu_torch as tfm

    t = torch.arange(3.0)
    a = np.arange(3)
    assert torch.equal(tfm.cpu(t), t) and tfm.cpu(a) is a and tfm.cpu("x") == "x"
    moved = tfm.device(a, "cpu")
    assert isinstance(moved, torch.Tensor) and moved.tolist() == [0, 1, 2]
    assert tfm.device(t, torch.device("cpu")).device.type == "cpu"
    assert tfm.device(7, "cpu") == 7 and tfm.device(None) is None
