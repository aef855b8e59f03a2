"""The port's training path against the JAX package's, on the CPU at small
widths: the LM's per-token loss and every parameter's gradient
(``targets=`` through the fused head, naive and flash attention) against
``jax.grad``; the optimizer rules against optax; the loader's batch
order against the JAX loader sample for sample; three
``make_train_step`` + ``train_loop`` updates against the JAX package's
from the same converted weights; and the quick-start MLP.

Tolerances (f32 on both sides, sums in different orders): losses and
gradients atol 2e-5 on O(1) values; optimizer rules 1e-6 (the same
elementwise arithmetic); three training updates atol 2e-5 on the
parameters (lr 1e-3: Adam divides each gradient element by its own
magnitude, so the few near-zero elements carry the gradients' summation
noise into the update; key biases, whose gradient is exactly zero, are
bounded by Adam's step instead)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.mlp import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import (MLP, TransformerLM, load_flax_params,
                                      to_flax_params)
from fluxmpi_tpu_torch.parallel import (TrainState, make_eval_step,
                                        make_train_step, train_loop)

torch.set_num_threads(1)

ATOL = 2e-5
CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4,
           d_ff=64)


@pytest.fixture(scope="module")
def port_world():
    """The port's runtime as a one-process gloo world."""
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


def _flat(tree):
    """flax tree → ``{"a/b/c": numpy array}``."""
    tree = tree["params"] if set(tree) == {"params"} else tree
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in path)] = np.asarray(leaf)
    return out


def _corpus(n=64, seq=16, vocab=CFG["vocab_size"], seed=0):
    """``examples/lm_pretrain.py``'s synthetic corpus: t -> 3t + 1 mod V."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % vocab)
    return np.concatenate(seqs, axis=1).astype(np.int32)


def _lm_pair(attention, seed=0):
    jlm = JaxLM(**CFG, attention=attention)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
                      train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tlm = TransformerLM(**CFG, attention=attention, device="cpu")
    load_flax_params(tlm, params)
    return jlm, params, tlm


# ---------------------------------------------------------------------------
# The LM's loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_lm_loss_and_every_gradient_match_jax(attention):
    jlm, params, tlm = _lm_pair(attention, seed=1)
    corpus = _corpus(n=4)
    x, y = corpus[:, :-1], corpus[:, 1:]

    def jloss(p):
        return jlm.apply(p, jnp.asarray(x), train=False, targets=jnp.asarray(y),
                         loss_chunk=40).mean()

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    loss = tlm(torch.from_numpy(x), targets=torch.from_numpy(y), loss_chunk=40).mean()
    grads = torch.autograd.grad(loss, list(tlm.parameters()))
    names = [n for n, _ in tlm.named_parameters()]
    got = to_flax_params(dict(zip(names, grads)))
    want = _flat(want_grads)
    assert set(got) == set(want) and len(got) == 2 + 2 * 16 + 2
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL, rtol=0)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_lm_per_token_losses_hidden_and_logits_agree():
    _, _, tlm = _lm_pair("naive", seed=2)
    corpus = _corpus(n=2)
    x, y = torch.from_numpy(corpus[:, :-1]), torch.from_numpy(corpus[:, 1:])
    per_token = tlm(x, targets=y)
    logits = tlm(x)
    ref = torch.nn.functional.cross_entropy(logits.reshape(-1, 97), y.reshape(-1).long(),
                                            reduction="none").reshape(y.shape)
    torch.testing.assert_close(per_token, ref, atol=ATOL, rtol=0)
    h, table = tlm(x, hidden=True)
    assert h.shape == (2, 16, 32) and table is tlm.embed.embedding
    with pytest.raises(ValueError, match="either targets or hidden"):
        tlm(x, targets=y, hidden=True)


def test_lm_dropout_training_raises_and_names_the_reason():
    lm = TransformerLM(**CFG, dropout=0.1, attention="flash", device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dense attention fallback"):
        lm(toks, targets=toks)
    assert lm(toks, train=False).shape == (1, 4, 97)  # inference is unaffected


def test_to_flax_params_round_trips_through_load_flax_params():
    _, params, tlm = _lm_pair("naive", seed=3)
    back = to_flax_params(tlm)
    want = _flat(params)
    assert set(back) == set(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name])


def test_mlp_matches_jax_from_converted_weights():
    jm = JaxMLP()
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1))))
    tm = MLP(device="cpu")
    load_flax_params(tm, params)
    x = np.linspace(-2, 2, 11, dtype=np.float32)[:, None]
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want,
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Optimizer rules against optax
# ---------------------------------------------------------------------------


RULES = {
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=0.1),
              lambda: optim.adamw(1e-2, weight_decay=0.1)),
    "adamw_defaults": (lambda: optax.adamw(3e-4), lambda: optim.adamw(3e-4)),
    "adam": (lambda: optax.adam(1e-2), lambda: optim.adam(1e-2)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: optim.sgd(0.1, momentum=0.9)),
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_three_updates_track_optax(name):
    make_jax, make_port = RULES[name]
    rng = np.random.default_rng(len(name))
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jopt, topt = make_jax(), make_port()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tupd)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The loader's batch order against the JAX loader
# ---------------------------------------------------------------------------


class _ListDataset:
    """Not array-backed: the loaders stack samples one by one."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


LOADERS = {
    "plain": dict(),
    "shuffle": dict(shuffle=True, seed=3),
    "global_shuffle": dict(global_shuffle=True, seed=5),
    "rank2_of3_shuffle": dict(shuffle=True, seed=1, rank=2, world=3),
    "rank2_of3_global": dict(global_shuffle=True, rank=2, world=3),
    "rank1_of3_plain": dict(rank=1, world=3),
    "list_dataset_shuffle": dict(shuffle=True, list_dataset=True),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_order_matches_jax_sample_for_sample(world, name):
    opts = dict(LOADERS[name])
    rank, wsize = opts.pop("rank", None), opts.pop("world", None)
    listed = opts.pop("list_dataset", False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((70, 3)).astype(np.float32)
    y = np.arange(70, dtype=np.int32)

    def make(pkg, cpu):
        ds = _ListDataset(x, y) if listed else pkg.ArrayDataset((x, y))
        kw = {} if rank is None else dict(rank=rank, world=wsize)
        cont = pkg.DistributedDataContainer(ds, **kw)
        extra = dict(device="cpu") if cpu else {}
        return pkg.DistributedDataLoader(cont, global_batch_size=8, **opts, **extra)

    jl, tl = make(jfm, False), make(tfm, True)
    assert len(tl) == len(jl) > 0
    for epoch in range(3):
        jb = [tuple(np.asarray(a) for a in b) for b in jl]
        tb = [tuple(a.numpy() for a in b) for b in tl]
        assert len(tb) == len(jb) == len(jl), epoch
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tx, jx)
    assert tl.state_dict() == {k: int(v) for k, v in jl.state_dict().items()}


def test_loader_state_dict_resumes_mid_epoch():
    x = np.arange(40, dtype=np.int32)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset(x), global_batch_size=4,
                                       shuffle=True, device="cpu")
    first = [b.numpy() for b in loader]
    it = iter(loader)
    seen = [next(it).numpy() for _ in range(3)]
    state = loader.state_dict()
    assert state["cursor"] == 3 and loader.geometry()["num_batches"] == 10
    again = tfm.DistributedDataLoader(tfm.ArrayDataset(x), global_batch_size=4,
                                      shuffle=True, device="cpu")
    again.load_state_dict(state)
    rest = [b.numpy() for b in again]
    fresh = tfm.DistributedDataLoader(tfm.ArrayDataset(x), global_batch_size=4,
                                      shuffle=True, device="cpu")
    fresh.set_epoch(1)
    second = [b.numpy() for b in fresh]
    assert len(seen) + len(rest) == 10
    np.testing.assert_array_equal(np.concatenate(seen + rest), np.concatenate(second))
    assert not np.array_equal(np.concatenate(first), np.arange(40))


def test_loader_drop_last_and_scan_batches():
    x = np.arange(30, dtype=np.int32)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset(x), global_batch_size=4,
                                       drop_last=False, prefetch=0, device="cpu")
    sizes = [len(b) for b in loader]
    assert sizes == [4] * 7 + [2] and len(loader) == 8
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset(x), global_batch_size=4,
                                       device="cpu")
    groups = list(tfm.scan_batches(loader, 3))
    assert len(groups) == 2 and groups[0].shape == (3, 4)
    np.testing.assert_array_equal(groups[1].numpy().ravel(), np.arange(12, 24))


def test_loader_waiting_options_raise():
    ds = tfm.ArrayDataset(np.zeros(8))
    for kw in (dict(elastic_order=True), dict(transform=lambda b: b),
               dict(transform_with_rng=True)):
        with pytest.raises(NotImplementedError):
            tfm.DistributedDataLoader(ds, 4, device="cpu", **kw)
    # device_gather=True is ported: the JAX package's errors and batches.
    with pytest.raises(ValueError, match="array-backed"):
        tfm.DistributedDataLoader(_ListDataset(np.zeros((8, 2)), np.zeros(8)), 4,
                                  device="cpu", device_gather=True)
    with pytest.raises(ValueError, match="device_gather must be"):
        tfm.DistributedDataLoader(ds, 4, device="cpu", device_gather="always")
    forced = tfm.DistributedDataLoader(ds, 4, device="cpu", device_gather=True)
    assert forced.fusible() and len(list(forced)) == 2
    with pytest.raises(ValueError, match="needs the full-dataset view"):
        tfm.DistributedDataLoader(ds, 4, global_shuffle=True, device="cpu")


# ---------------------------------------------------------------------------
# make_train_step + train_loop against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_three_updates_track_jax_loss_and_parameters(world, port_world, attention):
    jlm, params, tlm = _lm_pair(attention, seed=4)
    corpus = _corpus(n=32)
    lr = 1e-3

    jloader = jfm.DistributedDataLoader(
        jfm.DistributedDataContainer(jfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=8, shuffle=True)

    def jloss_fn(p, ms, batch):
        x, y = batch
        return jlm.apply(p, x, train=False, targets=y, loss_chunk=64).mean(), ms

    jopt = optax.adamw(lr)
    jstep = jax_make_train_step(jloss_fn, jopt)
    jstate = replicate(JaxTrainState.create(params, jopt))
    jstate, jsummary = jax_train_loop(jstep, jstate, jloader, steps=3, flush_every=1)

    tloader = tfm.DistributedDataLoader(
        tfm.DistributedDataContainer(tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=8, shuffle=True)
    tfm.synchronize(tlm)

    def tloss_fn(p, ms, batch):
        x, y = batch
        return tlm(x, targets=y, loss_chunk=64).mean(), ms

    topt = optim.adamw(lr)
    tstate = TrainState.create(tlm, topt)
    tstate, tsummary = train_loop(make_train_step(tloss_fn, topt), tstate,
                                  tloader, steps=3, flush_every=1)

    assert tsummary["updates"] == jsummary["updates"] == 3 and tstate.step == 3
    assert set(jsummary) - {"window_compile_seconds", "window_cache"} <= set(tsummary)
    assert [f["updates"] for f in tsummary["flushes"]] == [1, 2, 3]
    np.testing.assert_allclose(tsummary["loss"], jsummary["loss"], atol=ATOL, rtol=0)
    got, want = to_flax_params(tlm), _flat(jax.device_get(jstate.params))
    assert set(got) == set(want)
    for name in sorted(want):
        # A key bias shifts every score of a query row alike, so its
        # gradient is 0 in exact arithmetic and ~1e-9 of rounding noise in
        # both frameworks; Adam divides that noise by its own magnitude,
        # so each side moves it by up to lr per update, in any direction.
        atol = 6 * lr if name.endswith("attn/key/bias") else ATOL
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


def _mlp_problem():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (16, 1)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(x ** 2)


def _mse(model):
    def loss_fn(p, ms, batch):
        x, y = batch
        return ((model(x) - y) ** 2).mean(), ms
    return loss_fn


def test_grad_accum_and_scan_steps_equal_plain_steps(port_world):
    x, y = _mlp_problem()
    results = []
    for accum, scan in ((1, 1), (2, 1), (1, 2)):
        model = MLP(device="cpu")
        opt = optim.sgd(0.05, momentum=0.9)
        step = make_train_step(_mse(model), opt, grad_accum_steps=accum,
                               scan_steps=scan)
        state = TrainState.create(model, opt)
        if scan == 1:
            for _ in range(2):
                state, loss = step(state, (x, y))
        else:
            state, loss = step(state, (torch.stack([x, x]), torch.stack([y, y])))
            assert loss.shape == (2,)
        assert state.step == 2
        results.append([p.detach().clone() for p in model.parameters()])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_eval_step_and_loss_stays_on_the_device_as_a_tensor(port_world):
    x, y = _mlp_problem()
    model = MLP(device="cpu")
    opt = optim.adam(1e-2)
    state = TrainState.create(model, opt)
    state, loss = make_train_step(_mse(model), opt)(state, (x, y))
    assert torch.is_tensor(loss) and not loss.requires_grad
    ev = make_eval_step(lambda p, ms, b: _mse(model)(p, ms, b)[0])
    assert ev(state, (x, y)).item() < loss.item()


def test_train_loop_budgets_and_errors(port_world):
    x, y = _mlp_problem()
    model = MLP(device="cpu")
    opt = optim.adam(1e-2)
    step = make_train_step(_mse(model), opt)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x.numpy(), y.numpy())),
                                       global_batch_size=4, device="cpu")
    state = TrainState.create(model, opt)
    state, s = train_loop(step, state, loader, epochs=2, flush_every=3, in_flight=0)
    assert (s["updates"], s["epochs"], s["examples"], s["dispatches"]) == (8, 2, 32, 8)
    assert [f["updates"] for f in s["flushes"]] == [3, 6, 8]
    assert len(s["step_ms"]) == 7 and all(ms >= 0 for ms in s["step_ms"])
    means = [f["loss_mean"] for f in s["flushes"]]
    assert means[0] > means[-1] and s["loss"] == s["flushes"][-1]["loss"]
    state, s = train_loop(step, state, loader, steps=5)
    assert (s["updates"], s["epochs"]) == (5, 1)
    scan = make_train_step(_mse(model), opt, scan_steps=2)
    state, s = train_loop(scan, state, loader, steps=3)
    assert s["updates"] == 4 and s["dispatches"] == 2  # whole dispatches
    with pytest.raises(ValueError, match="ran dry"):
        train_loop(step, state, iter([(x, y)]), steps=3)
    # One-program flush windows are ported: the 4-batch epoch is one
    # window (flush_every clamped), and a forced window over a plain
    # iterable raises the JAX package's reason.
    state, s = train_loop(step, state, loader, fuse="window")
    assert (s["updates"], s["fused_window"], s["dispatches"]) == (4, 4, 1)
    with pytest.raises(ValueError, match="not a DistributedDataLoader"):
        train_loop(step, state, iter([(x, y)]), steps=3, fuse="window")
    # metrics= is ported: a spec it cannot record into raises at build.
    with pytest.raises(ValueError, match="metrics must be"):
        make_train_step(_mse(model), opt, metrics="loud")
    with pytest.raises(ValueError, match="remat must be"):
        make_train_step(_mse(model), opt, remat="everything")
