"""ROADMAP C.25: under the default ``style="auto"`` step the layers that
couple the rows of a batch couple the global batch, as in the JAX
package's ``"auto"`` step, whose loss sees the global batch. In real 2- and
4-rank gloo worlds (one process per rank, ``tests/_torch_c25_worker.py``
for the CNN and the DEQ, ``tests/_torch_seq_worker.py`` group ``step`` for
the MoE LM), each rank its share of the same global batch, against the
JAX package's step on as many of its 8 CPU devices from the same weights:

- ``CNN`` with ``axis_name=None``: BatchNorm's statistics over every
  rank's rows (loss, every gradient, the new statistics), also with
  ``remat=True``;
- the DEQ with each solver (``damped``, ``anderson``, ``broyden``) at a
  ``tol`` where each rank's rows alone would stop at another iteration
  than the global batch (checked here first): the freeze test reads the
  MAX of the residual over the ranks;
- the MoE LM (``tests/_torch_compose.py``: CE plus the balance and z
  losses, 3 updates) with ``n_groups`` under ``dp``: groups that fall
  whole inside each rank's rows (``n_groups / W`` routed locally) and
  groups that span ranks (routed whole, the router probabilities
  gathered), and under ``dp x sp``.

``style="shard_map"`` keeps JAX's ``shard_map`` result (each rank's own
statistics and stopping test, the statistics averaged by
``state_reduce="mean"``). In one process: the remat recompute and the
DEQ's adjoint solve, run on another thread as autograd's device thread
runs them on the card, see the forward's batch axes.

Tolerances (f32 both sides, sums over other splits of the batch): losses
atol 1e-5 (MoE: 2e-5, every parameter too, as the other step tests);
gradients ``max|diff| / max|g| <= 1e-4`` per leaf; statistics atol 1e-5.
On the parent each comparison fails: a rank normalised, stopped and
grouped on its own rows.
"""

import json
import threading
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_compose as compose
from _torch_worlds import join_world, start_world
from fluxmpi_tpu.models import CNN as JaxCNN
from fluxmpi_tpu.models import DEQ as JaxDEQ
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel.train import replicate, shard_batch
from fluxmpi_tpu_torch import _batch_parallel
from fluxmpi_tpu_torch.models import deq as tdeq

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "_torch_c25_worker.py"
SOLVERS = ["damped", "anderson", "broyden"]
DEQ_OPTS = dict(hidden=16, out=2, tol=1e-2, max_iter=60, damping=0.7)
DEQ_IN, N = 3, 8
LR = {"cnn": 1.0, "deq": 0.1}
ATOL, GRAD_REL, MOE_ATOL = 1e-5, 1e-4, 2e-5

MOE_CASES = {
    2: {"moe_dp_groups_inside": dict(kind="moe", plan=dict(dp=2), moe=dict(n_groups=4)),
        "moe_dp_groups_span": dict(kind="moe", plan=dict(dp=2), moe=dict(n_groups=1))},
    4: {"moe_dp4_groups_span": dict(kind="moe", plan=dict(dp=4), moe=dict(n_groups=2)),
        "moe_dp_sp_groups_inside": dict(kind="moe", plan=dict(dp=2, sp=2),
                                        moe=dict(n_groups=4)),
        "moe_dp_sp_groups_span": dict(kind="moe", plan=dict(dp=2, sp=2),
                                      moe=dict(n_groups=1, top_k=2))},
}
MOE = [(n, c) for n in (2, 4) for c in MOE_CASES[n]]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _deq_params(rng):
    h = DEQ_OPTS["hidden"]
    return {"W": (0.8 * rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32),
            "U": (rng.normal(size=(DEQ_IN, h)) / np.sqrt(DEQ_IN)).astype(np.float32),
            "b": (0.1 * rng.normal(size=(h,))).astype(np.float32),
            "head": {"kernel": (0.3 * rng.normal(size=(h, 2))).astype(np.float32),
                     "bias": (0.1 * rng.normal(size=(2,))).astype(np.float32)}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = dict(cnn_x=rng.normal(size=(N, 8, 8, 3)).astype(np.float32),
             cnn_y=rng.integers(0, 4, N).astype(np.int32),
             # Rows of growing size converge at different speeds.
             deq_x=(rng.normal(size=(N, DEQ_IN)) * np.linspace(0.2, 3, N)[:, None]
                    ).astype(np.float32),
             deq_y=rng.normal(size=(N, 2)).astype(np.float32))
    cnn = jax.jit(lambda x: JaxCNN(num_classes=4, channels=(4, 8)).init(
        jax.random.PRNGKey(0), x, train=False))(jnp.asarray(d["cnn_x"]))
    cnn = jax.tree_util.tree_map(np.asarray, cnn)
    deq = _deq_params(rng)
    tokens = dict(tokens=rng.integers(0, 32, (40, 16)).astype(np.int32),
                  targets=rng.integers(0, 32, (40, 16)).astype(np.int32))
    moe = compose.moe_weights(rng)
    path = tmp_path_factory.mktemp("c25") / "data.npz"
    np.savez(path, **d, deq_opts=np.array(json.dumps(DEQ_OPTS)),
             **{f"cnn/params/{k}": v for k, v in _flat(cnn["params"]).items()},
             **{f"cnn/batch_stats/{k}": v for k, v in _flat(cnn["batch_stats"]).items()},
             **{f"deq/params/{k}": v for k, v in _flat(deq).items()})
    moe_paths = {}
    for n in (2, 4):
        p = tmp_path_factory.mktemp(f"c25moe{n}") / "data.npz"
        np.savez(p, **tokens, **{f"moe/{k}": v for k, v in _flat(moe).items()},
                 cases=np.array(json.dumps(MOE_CASES[n])))
        moe_paths[n] = p
    return dict(d, **tokens, cnn=cnn, deq=deq, moe=moe, path=path, moe_paths=moe_paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {}
    for n in (2, 4):
        started[("step", n)] = start_world("step", tmp_path_factory.mktemp(f"c25s{n}"), n,
                                           data["moe_paths"][n])
        started[("c25", n)] = start_world("c25", tmp_path_factory.mktemp(f"c25w{n}"), n,
                                          data["path"], worker=WORKER)
    return {key: join_world(*procs) for key, procs in started.items()}


_JAX: dict = {}


def _jax_step(data, model, style, n):
    """One JAX ``sgd`` update on ``n`` CPU devices over the global batch:
    ``(loss, gradients, new statistics)`` keyed by flax path."""
    key = (model, style, n)
    if key in _JAX:
        return _JAX[key]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    if model == "cnn":
        jm, v = JaxCNN(num_classes=4, channels=(4, 8)), data["cnn"]
        params, stats = v["params"], v["batch_stats"]
        x, y = data["cnn_x"], data["cnn_y"]

        def loss_fn(p, ms, b):
            logits, upd = jm.apply({"params": p, "batch_stats": ms}, b[0], train=True,
                                   mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, b[1]).mean(), upd["batch_stats"]
    else:
        jm = JaxDEQ(**DEQ_OPTS, solver=model.split("_")[1])
        params, stats, x, y = data["deq"], None, data["deq_x"], data["deq_y"]

        def loss_fn(p, ms, b):
            return jnp.mean((jm.apply({"params": p}, b[0]) - b[1]) ** 2), ms

    lr = LR[model.split("_")[0]]
    opt = optax.sgd(lr)
    kw = dict(grad_reduce="mean", state_reduce="mean") if style == "shard_map" else {}
    step = jax_make_train_step(loss_fn, opt, mesh=mesh, axis_name="dp", style=style,
                               donate=False, **kw)
    state = replicate(JaxTrainState.create(params, opt, stats), mesh)
    batch = shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    state, loss = step(state, batch)
    grads = {k: (a - b) / lr for (k, a), b in zip(_flat(params).items(),
                                                    _flat(state.params).values())}
    _JAX[key] = (float(loss), grads, _flat(state.model_state) if stats else {})
    return _JAX[key]


def _assert_like_jax(rs, case, want):
    loss, grads, stats = want
    for r, res in enumerate(rs):
        assert abs(float(res[f"{case}/loss"]) - loss) <= ATOL, (case, r)
        for k, g in grads.items():
            got = res[f"{case}/grad/{k.replace('/', '.')}"]
            assert np.abs(got - g).max() <= GRAD_REL * np.abs(g).max(), (case, r, k)
        for k, s in stats.items():
            np.testing.assert_allclose(res[f"{case}/stats/{k.replace('/', '.')}"], s,
                                       atol=ATOL, rtol=0, err_msg=f"{case} {r} {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["auto", "auto_remat"])
def test_batchnorm_normalises_by_the_global_batch_like_jax_auto(world, worlds, data, n,
                                                               variant):
    _assert_like_jax(worlds[("c25", n)], f"cnn_{variant}", _jax_step(data, "cnn", "auto", n))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("solver", SOLVERS)
def test_deq_stops_on_the_global_residual_like_jax_auto(world, worlds, data, n, solver):
    # Each rank's rows alone would stop at another iteration than the
    # global batch: the stopping test is what the comparison holds.
    x = torch.from_numpy(data["deq_x"])
    p = {k: torch.from_numpy(v) for k, v in _flat(data["deq"]).items()}
    cell = (p["W"], p["U"], p["b"])
    opts = (DEQ_OPTS["tol"], DEQ_OPTS["max_iter"], DEQ_OPTS["damping"], solver, 5, 1.0)

    def iters(rows):
        z0 = torch.zeros((len(rows), DEQ_OPTS["hidden"]))
        return int(tdeq._solve(lambda z: tdeq._cell(cell, x[rows], z), z0, *opts)[1])

    alone = {iters(list(range(r * N // n, (r + 1) * N // n))) for r in range(n)}
    assert alone != {iters(list(range(N)))}
    _assert_like_jax(worlds[("c25", n)], f"deq_{solver}_auto",
                     _jax_step(data, f"deq_{solver}", "auto", n))
    _assert_like_jax(worlds[("c25", n)], f"deq_{solver}_auto_remat",
                     _jax_step(data, f"deq_{solver}", "auto", n))


@pytest.mark.parametrize("n", [2, 4])
def test_shard_map_keeps_each_ranks_batch_like_jax_shard_map(world, worlds, data, n):
    """Per-rank statistics and stopping tests, the statistics averaged over
    the ranks by ``state_reduce="mean"``, as JAX's ``shard_map`` step."""
    rs = worlds[("c25", n)]
    _assert_like_jax(rs, "cnn_shard_map", _jax_step(data, "cnn", "shard_map", n))
    for solver in SOLVERS:
        _assert_like_jax(rs, f"deq_{solver}_shard_map",
                         _jax_step(data, f"deq_{solver}", "shard_map", n))


@pytest.mark.parametrize("n,case", MOE, ids=[f"{n}-{c}" for n, c in MOE])
def test_moe_n_groups_route_the_global_grouping_like_jax_auto(world, worlds, data, n, case):
    spec = MOE_CASES[n][case]
    losses, tree = compose.jax_moe_train(data, n, spec)
    for r, res in enumerate(worlds[("step", n)]):
        np.testing.assert_allclose(res[f"{case}/losses"], losses, atol=MOE_ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, arr in _flat(tree).items():
            np.testing.assert_allclose(res[f"{case}/param/{name.replace('/', '.')}"], arr,
                                       atol=MOE_ATOL, rtol=0, err_msg=f"{r} {name}")


class _Rows:
    """A stand-in batch group of one member that counts its reductions."""

    size, index = 1, 0

    def __init__(self):
        self.maxes = 0

    def mean(self, t):
        return t

    def max(self, t):
        self.maxes += 1
        return t


def _on_another_thread(fn):
    out = {}
    worker = threading.Thread(target=lambda: out.update(value=fn()))
    worker.start()
    worker.join()
    return out["value"]


def test_remat_recompute_re_enters_the_batch_axes():
    """The recompute under ``remat=`` runs where the backward runs (on
    the card, autograd's device thread): it sees the forward's batch axes,
    and the gradient equals the one without remat."""
    from fluxmpi_tpu_torch.parallel import train

    def loss(p, ms, b):
        seen = _batch_parallel.current() is not None
        return (p["w"] * (1.0 + seen)).sin().sum() * b, ms

    grads = {}
    for remat in (False, True):
        fn = train._with_policy_and_remat(loss, None, remat, train._CastWatch())
        w = torch.ones(3, requires_grad=True)
        with _batch_parallel.active(_Rows()):
            value, _ = fn({"w": w}, None, 1.0)
        grads[remat] = _on_another_thread(lambda: torch.autograd.grad(value, [w])[0])
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)
    torch.testing.assert_close(grads[False], 2 * torch.cos(torch.full((3,), 2.0)))


@pytest.mark.parametrize("solver", SOLVERS)
def test_deq_adjoint_solve_reduces_over_the_forwards_batch_axes(solver):
    """The implicit backward's adjoint solve, run on another thread,
    reduces every residual over the group the forward saw: one MAX per
    freeze test (forward and backward)."""
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in _flat(_deq_params(rng)).items()}
    x = torch.from_numpy(rng.normal(size=(4, DEQ_IN)).astype(np.float32))
    rows = _Rows()
    with _batch_parallel.active(rows):
        z = tdeq.fixed_point_solve(tdeq._cell, (p["W"], p["U"], p["b"]), x,
                                   torch.zeros((4, DEQ_OPTS["hidden"])), 1e-4, 20, 0.7,
                                   solver)
    forward = rows.maxes
    assert forward == {"damped": 19, "anderson": 20, "broyden": 19}[solver]
    _on_another_thread(lambda: torch.autograd.grad(z.sum(), [p["W"]]))
    assert rows.maxes == 2 * forward
