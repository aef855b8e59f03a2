"""The port's DEQ against the JAX package's, on the CPU, for each solver
(``damped``, ``anderson``, ``broyden``): the fixed point ``z*`` of
``fixed_point_solve``, its implicit gradients in the cell's parameters and
the input, and ``DEQ``'s loss and every parameter's gradient, from the
same numpy inputs and converted weights; the autograd graph of a solve is
one node whatever ``max_iter``; the device-side stop freezes the iterate
(more iterations give the same bits); and a few data-parallel updates
lower the loss.

Tolerances (f32 both sides; the solves stop at ``tol=1e-6`` on the
batch-global residual, so the two fixed points may stand a few ``tol``
apart): ``z*`` atol 1e-5; gradients ``max|diff| / max|g| <= 1e-4`` per
leaf; losses atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import DEQ as JaxDEQ
from fluxmpi_tpu.models.deq import fixed_point_solve as jax_fixed_point_solve
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import DEQ, fixed_point_solve, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.models import deq as tdeq
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

torch.set_num_threads(1)

SOLVERS = ["damped", "anderson", "broyden"]
TOL, MAX_ITER, DAMPING = 1e-6, 60, 0.7
HIDDEN, IN = 16, 3


def _cell_jax(params, x, z):
    W, U, b = params
    return jnp.tanh(z @ W + x @ U + b)


def _inputs(seed=0, n=8):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(HIDDEN, HIDDEN)) * 0.25 / np.sqrt(HIDDEN)).astype(np.float32)
    U = (rng.normal(size=(IN, HIDDEN)) / np.sqrt(IN)).astype(np.float32)
    b = (rng.normal(size=(HIDDEN,)) * 0.1).astype(np.float32)
    x = rng.normal(size=(n, IN)).astype(np.float32)
    c = rng.normal(size=(n, HIDDEN)).astype(np.float32)
    return (W, U, b), x, c


def _grad_err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("solver", SOLVERS)
def test_fixed_point_and_implicit_gradients_match_jax(solver):
    params, x, c = _inputs()
    z0 = np.zeros((x.shape[0], HIDDEN), np.float32)

    @jax.jit
    def jax_obj(params, x):
        z = jax_fixed_point_solve(_cell_jax, params, x, jnp.asarray(z0), TOL, MAX_ITER,
                                  DAMPING, solver, 5, 1.0)
        return jnp.sum(z * c), z

    (_, jz), (jgp, jgx) = jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True)(
        tuple(map(jnp.asarray, params)), jnp.asarray(x))
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    tx = torch.from_numpy(x).requires_grad_()
    z = fixed_point_solve(tdeq._cell, tuple(tp), tx, torch.from_numpy(z0), TOL, MAX_ITER,
                          DAMPING, solver, 5, 1.0)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-5, rtol=0)
    # The fixed point: z* = f(z*).
    np.testing.assert_allclose(tdeq._cell(tp, tx, z).detach().numpy(),
                               z.detach().numpy(), atol=1e-5, rtol=0)
    grads = torch.autograd.grad((z * torch.from_numpy(c)).sum(), [*tp, tx])
    for got, want in zip(grads, [*jgp, jgx]):
        assert _grad_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("solver", SOLVERS)
def test_deq_loss_and_gradients_match_jax(solver):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, IN)).astype(np.float32)
    y = np.tanh(x.sum(axis=1, keepdims=True)).astype(np.float32)
    jm = JaxDEQ(hidden=HIDDEN, out=1, tol=TOL, max_iter=MAX_ITER, solver=solver)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))

    @jax.jit
    def jax_loss(p):
        return jnp.mean((jm.apply(p, jnp.asarray(x)) - y) ** 2)

    jloss, jgrads = jax.value_and_grad(jax_loss)(params)
    model = load_flax_params(DEQ(hidden=HIDDEN, out=1, tol=TOL, max_iter=MAX_ITER,
                                 solver=solver, in_features=IN, device="cpu"), params)
    loss = ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = to_flax_params(dict(zip(names, torch.autograd.grad(loss, list(model.parameters())))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    flat = {"/".join(str(getattr(p, "key", p)) for p in path[1:]): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(grads) == {"W", "U", "b", "head/kernel", "head/bias"}
    for k, g in flat.items():
        assert _grad_err(grads[k], g) <= 1e-4, k


def _graph_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


@pytest.mark.parametrize("solver", SOLVERS)
def test_graph_does_not_grow_with_iterations_and_the_stop_freezes(solver):
    """The implicit gradient is one autograd node: the graph of a solve
    with 5 iterations and one with 200 have the same size. Once converged
    the iterate freezes on the device, so 60 and 200 iterations give the
    same bits (the early exit's ``z*``)."""
    params, x, _ = _inputs()
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    z0 = torch.zeros((x.shape[0], HIDDEN))
    out = {n: fixed_point_solve(tdeq._cell, tuple(tp), torch.from_numpy(x), z0, TOL, n,
                                DAMPING, solver) for n in (5, 60, 200)}
    assert _graph_nodes(out[5]) == _graph_nodes(out[200]) == 1 + len(tp)
    assert torch.equal(out[60], out[200])
    fixed = [p.detach() for p in tp]
    _, iters = tdeq._solve(lambda z: tdeq._cell(fixed, torch.from_numpy(x), z),
                           z0, TOL, 200, DAMPING, solver, 5, 1.0)
    assert 1 < int(iters) < 60


def test_deq_trains_data_parallel_one_worker():
    tfm.init(device="cpu")
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(64, IN)).astype(np.float32))
        y = torch.tanh(x.sum(1, keepdim=True))
        model = DEQ(hidden=32, out=1, solver="anderson", in_features=IN, device="cpu")
        tfm.synchronize(model)

        def loss_fn(p, ms, batch):
            return ((model(batch[0]) - batch[1]) ** 2).mean(), ms

        opt = optim.adam(5e-3)
        step = make_train_step(loss_fn, opt)
        state = TrainState.create(model, opt)
        losses = []
        for _ in range(20):
            state, loss = step(state, (x, y))
            losses.append(float(loss))
        assert losses[-1] < 0.5 * losses[0]
    finally:
        tfm.shutdown()
