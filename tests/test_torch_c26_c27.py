"""ROADMAP C.26 and C.27.

C.26: ``make_eval_step`` returns what JAX's eval step returns over the
global batch, on every worker: in real 2- and 4-rank gloo worlds of
``tests/_torch_c26_worker.py`` (each rank its share of the same global
batch), without a plan and with a dp-only plan, against JAX's
``make_eval_step`` on as many of its CPU devices from the same weights:
``tests/test_train.py::test_eval_step``'s mse and mae, a sum, a max and a
count of the quick-start MLP, and a DEQ's mse with each solver at a
``tol`` where each rank's rows alone would stop at another iteration
(checked first). f32 both sides: atol 1e-5 relative to the value; the
count exactly. On the parent each rank returned its own rows' metrics.

C.27: a ``decode=True`` module called with ``train=True`` and ``dropout >
0`` drops, as flax's decode does (``deterministic=not train``), where the
parent raised. The keep rate at decode shapes (one query over a cache)
against flax's ``dot_product_attention`` in law (both within five
binomial standard deviations of ``1 - rate``); and ``TransformerLM`` and
``MoETransformerLM`` decoded tick by tick, teacher-forced, each tick
drawing from a generator seeded as the training forward's: every keep
mask row equal to the forward's at the same position bit for bit, the
logits the forward's at that position (f32, 1e-5), and unlike the
``train=False`` decode.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from _torch_worlds import join_world, start_world
from fluxmpi_tpu.models import DEQ as JaxDEQ
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_eval_step as jax_make_eval_step
from fluxmpi_tpu.parallel.train import replicate, shard_batch
from fluxmpi_tpu_torch.models import MoETransformerLM, TransformerLM
from fluxmpi_tpu_torch.models import _layers
from fluxmpi_tpu_torch.models import deq as tdeq
from fluxmpi_tpu_torch.models.generate import _decode_twin, _sized_cache

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "_torch_c26_worker.py"
SOLVERS = ["damped", "anderson", "broyden"]
DEQ_OPTS = dict(hidden=16, out=2, tol=1e-2, max_iter=60, damping=0.7)
DEQ_IN, N_DEQ, N_MLP = 3, 8, 16
RTOL = 1e-5


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(N_MLP, 1)).astype(np.float32)
    y = (x ** 2 + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    mlp = jax.tree_util.tree_map(np.asarray, JaxMLP(features=(16, 16, 1)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1))))
    h = DEQ_OPTS["hidden"]
    deq = {"W": (0.8 * rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32),
           "U": (rng.normal(size=(DEQ_IN, h)) / np.sqrt(DEQ_IN)).astype(np.float32),
           "b": (0.1 * rng.normal(size=(h,))).astype(np.float32),
           "head": {"kernel": (0.3 * rng.normal(size=(h, 2))).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=(2,))).astype(np.float32)}}
    # Rows of growing size converge at different speeds.
    deq_x = (rng.normal(size=(N_DEQ, DEQ_IN)) * np.linspace(0.2, 3, N_DEQ)[:, None]
             ).astype(np.float32)
    deq_y = rng.normal(size=(N_DEQ, 2)).astype(np.float32)
    path = tmp_path_factory.mktemp("c26") / "data.npz"
    np.savez(path, x=x, y=y, deq_x=deq_x, deq_y=deq_y,
             deq_opts=np.array(json.dumps(DEQ_OPTS)),
             **{f"mlp/{k}": v for k, v in _flat(mlp["params"]).items()},
             **{f"deq/{k}": v for k, v in _flat(deq).items()})
    return dict(x=x, y=y, mlp=mlp, deq=deq, deq_x=deq_x, deq_y=deq_y, path=path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    started = {n: start_world("eval", tmp_path_factory.mktemp(f"c26w{n}"), n, data["path"],
                              worker=WORKER) for n in (2, 4)}
    return {n: join_world(*procs) for n, procs in started.items()}


def _jax_eval(metric_fn, params, batch, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    import optax

    state = replicate(JaxTrainState.create(params, optax.sgd(0.1)), mesh)
    out = jax_make_eval_step(metric_fn, mesh=mesh)(state, shard_batch(batch, mesh))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        assert int(got) == int(want), what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * abs(float(want)),
                                   err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("plan", ["none", "dp_plan"])
def test_eval_step_returns_jax_global_metrics(world, worlds, data, n, plan):
    model = JaxMLP(features=(16, 16, 1))

    def metric_fn(p, ms, b):
        x, y = b
        pred = model.apply(p, x)
        d = pred - y
        return {"mse": jnp.mean(d ** 2), "mae": jnp.mean(jnp.abs(d)),
                "sum": jnp.sum(d ** 2), "max": jnp.max(jnp.abs(d)),
                "count": jnp.sum(pred > y)}

    want = _jax_eval(metric_fn, data["mlp"], (data["x"], data["y"]), n)
    for r, res in enumerate(worlds[n]):
        for k, v in want.items():
            _close(res[f"mlp_{plan}/{k}"], v, f"rank {r} {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("solver", SOLVERS)
def test_eval_step_deq_stops_on_the_global_batch(world, worlds, data, n, solver):
    x = torch.from_numpy(data["deq_x"])
    p = {k: torch.from_numpy(v) for k, v in _flat(data["deq"]).items()}
    cell = (p["W"], p["U"], p["b"])
    opts = (DEQ_OPTS["tol"], DEQ_OPTS["max_iter"], DEQ_OPTS["damping"], solver, 5, 1.0)

    def iters(rows):
        z0 = torch.zeros((len(rows), DEQ_OPTS["hidden"]))
        return int(tdeq._solve(lambda z: tdeq._cell(cell, x[rows], z), z0, *opts)[1])

    alone = {iters(list(range(r * N_DEQ // n, (r + 1) * N_DEQ // n))) for r in range(n)}
    assert alone != {iters(list(range(N_DEQ)))}
    jm = JaxDEQ(**DEQ_OPTS, solver=solver)

    def metric_fn(prm, ms, b):
        return jnp.mean((jm.apply({"params": prm}, b[0]) - b[1]) ** 2)

    want = _jax_eval(metric_fn, data["deq"], (data["deq_x"], data["deq_y"]), n)
    for r, res in enumerate(worlds[n]):
        for plan in ("none", "dp_plan"):
            _close(res[f"deq_{solver}_{plan}/mse"], want, f"rank {r} {plan}")


# ---------------------------------------------------------------------------
# C.27: decode=True drops in training.
# ---------------------------------------------------------------------------

RATE = 0.25
CFG = dict(vocab_size=32, max_len=12, num_layers=2, d_model=16, num_heads=2, d_ff=32)


def test_decode_keep_rate_in_law_against_flax():
    """One query at position ``pos`` over a cache of ``T`` keys: the
    fraction of attention weights kept, read off one-hot values, for the
    port's attend (``dropout_positions``) and flax's, each within five
    binomial standard deviations of ``1 - rate``."""
    b, h, T = 64, 4, 64
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, 1, h, T)).astype(np.float32)
    k = rng.normal(size=(b, T, h, T)).astype(np.float32)
    v = np.broadcast_to(np.eye(T, dtype=np.float32)[None, :, None, :], (b, T, h, T)).copy()
    kept = {"port": [], "flax": []}
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        pos = torch.full((b,), 7 + seed)
        o = _layers.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            dropout_rng=gen, dropout_rate=RATE, deterministic=False, dropout_positions=pos)
        kept["port"].append((o != 0).float().mean().item())
        # The port's mask is shared by the rows at one position (flax's
        # broadcast): each seed gives T draws per position; flax's draws
        # one shared [1, T] row per call as well.
        jo = nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      dropout_rng=jax.random.PRNGKey(seed),
                                      dropout_rate=RATE, deterministic=False)
        kept["flax"].append(float((np.asarray(jo) != 0).mean()))
    draws = 4 * T
    sigma = np.sqrt(RATE * (1 - RATE) / draws)
    for who, fractions in kept.items():
        assert abs(np.mean(fractions) - (1 - RATE)) <= 5 * sigma, (who, fractions)
    assert abs(np.mean(kept["port"]) - np.mean(kept["flax"])) <= 5 * np.sqrt(2) * sigma


def _dropping_twin(model):
    """The decode twin of ``model`` keeping its dropout rate."""
    twin = _decode_twin(model)
    for m in twin.modules():
        if hasattr(m, "decode"):
            m.dropout = RATE
        if hasattr(m, "attn"):
            m.attn.dropout_rate = RATE
    return twin


def _recording(monkeypatch):
    """Every keep mask the dense attend draws, in order."""
    seen = []
    draw = _layers.dense_dropout_keep

    @functools.wraps(draw)
    def record(*args, **kw):
        keep = draw(*args, **kw)
        seen.append(keep)
        return keep

    monkeypatch.setattr(_layers, "dense_dropout_keep", record)
    return seen


@pytest.mark.parametrize("cls", [TransformerLM, MoETransformerLM])
def test_decode_drops_as_the_training_forward_at_each_position(monkeypatch, cls):
    kw = dict(num_experts=4, capacity_factor=8.0) if cls is MoETransformerLM else {}
    model = cls(**CFG, **kw, dropout=RATE, device="cpu",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # off the zero init, so the attention matters
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    twin = _dropping_twin(model)
    b, T, seed = 3, CFG["max_len"], 123
    tokens = torch.randint(0, CFG["vocab_size"], (b, T),
                           generator=torch.Generator().manual_seed(2))
    seen = _recording(monkeypatch)
    with torch.no_grad():
        full = model(tokens, train=True, dropout_rng=torch.Generator().manual_seed(seed))
    forward_masks = list(seen)
    assert len(forward_masks) == CFG["num_layers"]
    cache = _sized_cache(twin, b, T)
    quiet = _sized_cache(twin, b, T)
    for pos in range(T):
        seen.clear()
        step = tokens[:, pos:pos + 1]
        got, cache = twin(step, train=True, pos_offset=pos, cache=cache,
                          dropout_rng=torch.Generator().manual_seed(seed))
        for layer, keep in enumerate(seen):
            # This tick's rows (one per sequence, all at pos) equal the
            # forward's row pos, bit for bit.
            assert torch.equal(keep, forward_masks[layer][pos][None].expand_as(keep)), (
                pos, layer)
        assert len(seen) == CFG["num_layers"]
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, pos].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"position {pos}")
        plain, quiet = twin(step, train=False, pos_offset=pos, cache=quiet)
    # Dropping moved the logits: the train=False ticks do not reach them.
    assert not torch.allclose(plain[:, 0], got[:, 0], atol=1e-4)


def test_decode_training_without_a_dropout_rng_raises():
    twin = _dropping_twin(TransformerLM(**CFG, dropout=RATE, device="cpu"))
    cache = _sized_cache(twin, 1, CFG["max_len"])
    with pytest.raises(ValueError, match="dropout_rng"):
        twin(torch.zeros((1, 1), dtype=torch.long), train=True, cache=cache)
