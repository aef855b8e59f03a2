"""Mixed precision in the port against the JAX package, on the CPU.

Checked: ``get_policy`` gives the JAX package's dtype triples and rejects
the same specs with the same messages; ``Policy`` casts float leaves only;
``DynamicLossScale`` gives the JAX scale and counter sequence over a fixed
pattern of finite and non-finite steps; ``TransformerLM(dtype=bfloat16)``
(f32 parameters, bf16 compute) from converted JAX weights gives the JAX
model's loss and every gradient with naive and flash attention;
``make_train_step(policy=get_policy("bf16"))`` feeds the loss bf16
parameters, keeps the state f32, hands its optimizer at every one of three
updates the gradients that the JAX step's policy-cast ``value_and_grad``
gives at the same parameters and batch, and tracks the JAX step with the
same policy; a ``loss_fn`` that ignores the parameters it is given makes
``policy=`` raise instead of doing nothing; ``remat=True`` and ``remat="dots"`` give the
same parameters as no remat, bit for bit, and the recomputed forward runs
the attention forward again.

Tolerances for bf16 compute, derived from bf16's unit roundoff
``U = 2**-8`` (each rounding adds a relative error of at most U) times the
number of bf16 roundings in sequence on the path (the "depth"), not fitted
to what is observed. The two frameworks round at different points (flax's
softmax in bf16 ops, PyTorch's in f32 rounded once; XLA's and PyTorch's
bf16 matmuls and their summation orders), so each side is within depth x U
of the exact value and the pair within about that again:

- the loss: the forward's bf16 products in sequence, 6 per layer (q/k/v,
  scores, P.V, out, ff1, ff2) plus the embedding: ``|dloss| <= U (6 L + 1)
  |loss|``;
- each gradient leaf, ``||dg|| / ||g||`` (Frobenius): forward and backward,
  12 per layer: ``<= 12 L U``; the key biases, whose gradient is zero in
  exact arithmetic, are held to the same bound times the largest gradient
  norm of the model;
- the policy step's gradients: the gradient bound above, at each update,
  against the JAX loss at the parameters and batch that update saw, so
  each comparison starts from the same point;
- three Adam updates, JAX step against port step: Adam moves an element by
  at most about ``lr`` per update whatever its gradient, so a gradient
  element near zero whose sign the roundings flip moves the two sides
  apart by up to ``2 lr`` per update: ``|dparam| <= 2 lr n``. This coarse
  bound catches a wrong learning rate, a lost or repeated update or a
  non-finite step, not a wrong gradient: the gradient check does that.
"""

import importlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu.utils import precision as jprec
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_eval_step, make_train_step, train_loop
from fluxmpi_tpu_torch.utils import (DynamicLossScale, Policy, all_finite,
                                     get_policy, loss_scale_init)

fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

U = 2.0 ** -8
L = 2
CFG = dict(vocab_size=97, max_len=32, num_layers=L, d_model=32, num_heads=4,
           d_ff=64)
LOSS_RTOL = U * (6 * L + 1)
GRAD_RTOL = U * 12 * L


@pytest.fixture(scope="module")
def port_world():
    dev = tfm.init(device="cpu")
    yield dev
    tfm.shutdown()


def _name(dtype):
    """A dtype's name on either side (None stays None)."""
    return None if dtype is None else str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Policy and loss scaling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "bf16", "bfloat16", "f32", "float32", "f16", "float16", " BF16 ",
    "params=float32,compute=bfloat16,output=float32", "compute=bfloat16",
    "output=float16, params=float32", "compute=float64",
])
def test_get_policy_gives_the_jax_triples(spec):
    want = jprec.get_policy(spec)
    got = get_policy(spec)
    assert [_name(d) for d in got] == [None if d is None else jnp.dtype(d).name
                                       for d in want]


@pytest.mark.parametrize("spec", [
    "speed=maximum", "compute=bfloat16,compute=float16", " , ,",
    "compute=bf16", "compute=", "params", "compute=notatype",
])
def test_get_policy_rejects_what_jax_rejects_with_its_message(spec):
    with pytest.raises(ValueError) as jerr:
        jprec.get_policy(spec)
    with pytest.raises(ValueError) as terr:
        get_policy(spec)
    assert str(terr.value) == str(jerr.value)


def test_policy_casts_only_float_leaves():
    tree = {"w": torch.ones(2, 2), "ids": torch.arange(3, dtype=torch.int32),
            "mask": torch.ones(2, dtype=torch.bool), "eps": 0.1,
            "n": 3, "np": np.ones(2, np.float32)}
    pol = get_policy("bf16")
    comp = pol.cast_to_compute(tree)
    assert comp["w"].dtype == torch.bfloat16
    assert comp["ids"].dtype == torch.int32 and comp["ids"] is tree["ids"]
    assert comp["mask"].dtype == torch.bool and comp["n"] == 3
    assert comp["eps"].dtype == torch.bfloat16 and comp["np"].dtype == torch.bfloat16
    assert pol.cast_to_param(comp)["w"].dtype == torch.float32
    assert pol.cast_to_output({"x": torch.ones(2, dtype=torch.bfloat16)})["x"].dtype \
        == torch.float32
    assert Policy().cast_to_compute(tree)["w"].dtype == torch.float32
    assert bool(all_finite(tree)) and not bool(all_finite(
        {"a": torch.tensor([1.0, float("inf")]), "i": torch.tensor([1])}))
    assert bool(all_finite({"i": torch.tensor([1])}))


def test_dynamic_loss_scale_sequence_matches_jax():
    pattern = [True, True, False, True, True, True, True, False, False, True,
               True, True] + [True] * 8 + [False] * 30
    js = jprec.loss_scale_init(initial=2.0 ** 22, growth_interval=2)
    ts = loss_scale_init(initial=2.0 ** 22, growth_interval=2)
    assert isinstance(ts, DynamicLossScale)
    for finite in pattern:
        js = js.adjust(jnp.asarray(finite))
        ts = ts.adjust(torch.tensor(finite))
        assert float(ts.scale) == float(js.scale)
        assert int(ts.counter) == int(js.counter)
    assert float(ts.scale) == 1.0  # clamped at the floor
    loss = torch.tensor(1.5, dtype=torch.float16)
    assert ts.scale_loss(loss).dtype == torch.float32
    g = {"w": torch.full((2,), 8.0, dtype=torch.bfloat16), "i": torch.tensor([4])}
    ls = loss_scale_init(initial=4.0)
    un = ls.unscale(g)
    assert un["w"].dtype == torch.bfloat16 and float(un["w"][0]) == 2.0
    assert un["i"] is g["i"]
    with pytest.raises(ValueError, match="initial scale"):
        loss_scale_init(initial=0.5)
    with pytest.raises(ValueError, match="growth_interval"):
        loss_scale_init(growth_interval=0)


# ---------------------------------------------------------------------------
# The LM in bf16 compute
# ---------------------------------------------------------------------------


def _flat(tree):
    tree = tree["params"] if set(tree) == {"params"} else tree
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _corpus(n=4, seq=16, vocab=CFG["vocab_size"], seed=0):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % vocab)
    return np.concatenate(seqs, axis=1).astype(np.int32)


def _lm_pair(attention, seed=1):
    jlm = JaxLM(**CFG, attention=attention, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jlm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32), train=False))
    tlm = TransformerLM(**CFG, attention=attention, dtype=torch.bfloat16,
                        device="cpu")
    load_flax_params(tlm, params)
    return jlm, params, tlm


def _assert_grads_close(got, want):
    """Each leaf within the bound; prints the worst leaf (``pytest -s``)."""
    assert set(got) == set(want)
    scale = max(np.linalg.norm(g) for g in want.values())
    rel = {}
    for name in sorted(want):
        err = np.linalg.norm(got[name] - want[name])
        if name.endswith("attn/key/bias"):
            assert err <= GRAD_RTOL * scale, name
        else:
            rel[name] = err / np.linalg.norm(want[name])
            assert rel[name] <= GRAD_RTOL, (name, rel[name])
    worst = max(rel, key=rel.get)
    print(f"worst gradient ||diff||/||g|| {rel[worst]:.3e} ({worst}), "
          f"embedding {rel['embed/embedding']:.3e}; bound {GRAD_RTOL:.3e}")


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_bf16_lm_logits_are_bf16_and_match_jax(attention):
    """The head of a bf16 LM gives bf16 logits, as flax's ``Embed.attend``
    does (bf16 operands, f32 sums, one rounding of the result).

    On the same final-LN activations the port's head and the JAX head
    differ only by f32 summation order before the one rounding: at most
    one bf16 ulp of each logit (``U |logit|``, since bf16 keeps 8
    significant bits: half an ulp is at most ``2**-9`` relative, so one
    ulp is at most ``U``). The whole model: the forward's bound (6 bf16
    products per layer and the embedding) plus the head's three
    roundings (two operands, the logits), ``U (6 L + 4) max|logit|``.
    Tokens are not compared: argmax ties flip even within JAX."""
    jlm, params, tlm = _lm_pair(attention)
    x = _corpus()[:, :-1]
    want = np.asarray(jlm.apply(params, jnp.asarray(x), train=False))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = tlm(torch.from_numpy(x), train=False)
        h, table = tlm(torch.from_numpy(x), train=False, hidden=True)
        head = tlm(torch.from_numpy(x[:, :1]), pos_offset=torch.zeros(4),
                   kv_cache=tuple(torch.zeros(tlm.cache_shape(4, 4), dtype=torch.bfloat16)
                                  for _ in range(2)))
    assert got.dtype == head.dtype == torch.bfloat16
    scale = np.abs(want.astype(np.float32)).max()
    err = np.abs(got.float().numpy() - want.astype(np.float32)).max()
    assert err <= U * (6 * L + 4) * scale, (err, scale)
    # The head alone, on the same activations.
    jhead = np.asarray(jnp.dot(jnp.asarray(h.numpy()).astype(jnp.bfloat16),
                               jnp.asarray(table.detach().numpy()).astype(jnp.bfloat16).T)
                       ).astype(np.float32)
    with torch.no_grad():
        mine = tlm._head(h).float().numpy()
    assert np.all(np.abs(mine - jhead) <= U * np.abs(jhead) + 1e-6)
    print(f"{attention}: logits max|diff| {err:.4e} of max|logit| {scale:.3f}; "
          f"head alone {np.abs(mine - jhead).max():.3e}")


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_bf16_lm_loss_and_every_gradient_match_jax(attention):
    jlm, params, tlm = _lm_pair(attention)
    corpus = _corpus()
    x, y = corpus[:, :-1], corpus[:, 1:]

    def jloss(p):
        return jlm.apply(p, jnp.asarray(x), train=False, targets=jnp.asarray(y),
                         loss_chunk=40).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    per_token = tlm(torch.from_numpy(x), targets=torch.from_numpy(y), loss_chunk=40)
    assert per_token.dtype == torch.float32
    loss = per_token.mean()
    grads = torch.autograd.grad(loss, list(tlm.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)  # the masters' dtype
    got = to_flax_params(dict(zip([n for n, _ in tlm.named_parameters()], grads)))
    print(f"{attention}: loss {loss.item():.6f} vs {float(want_loss):.6f}")
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_grads_close(got, _flat(want_grads))


# ---------------------------------------------------------------------------
# make_train_step(policy=, remat=)
# ---------------------------------------------------------------------------


def _loader(pkg, corpus, **extra):
    return pkg.DistributedDataLoader(
        pkg.DistributedDataContainer(pkg.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=8, shuffle=True, **extra)


def _nest(flat, like):
    """The flat ``{"a/b": array}`` as a tree shaped like the JAX ``like``
    (``{"params": ...}``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat["/".join(str(getattr(p, "key", p)) for p in path[1:])],
        like)


def test_policy_feeds_bf16_params_keeps_f32_state_and_tracks_jax(world, port_world):
    jlm, params, tlm = _lm_pair("flash", seed=4)
    corpus = _corpus(n=32)
    lr, n = 1e-3, 3
    jpol = jprec.get_policy("bf16")

    def jloss_fn(p, ms, batch):
        x, y = batch
        return jlm.apply(p, x, train=False, targets=y, loss_chunk=64).mean(), ms

    jopt = optax.adamw(lr)
    jstep = jax_make_train_step(jloss_fn, jopt, policy=jpol)
    jstate = replicate(JaxTrainState.create(params, jopt))
    jstate, jsummary = jax_train_loop(jstep, jstate, _loader(jfm, corpus), steps=n,
                                      flush_every=1)

    seen, batches, fed = [], [], []

    def tloss_fn(p, ms, batch):
        x, y = batch
        seen.append({v.dtype for v in p.values()})
        out = torch.func.functional_call(tlm, p, (x,), {"targets": y,
                                                        "loss_chunk": 64})
        batches.append((x.numpy().copy(), y.numpy().copy(), out.mean().item()))
        return out.mean(), ms

    adamw = optim.adamw(lr)

    def update(grads, opt_state, masters):
        # What the step hands its optimizer, and the masters it stood at.
        fed.append((to_flax_params(grads), to_flax_params(masters)))
        return adamw.update(grads, opt_state, masters)

    topt = optim.GradientTransformation(adamw.init, update)
    tstate = TrainState.create(tlm, topt)
    tstep = make_train_step(tloss_fn, topt, policy=get_policy("bf16"))
    tstate, tsummary = train_loop(tstep, tstate, _loader(tfm, corpus, device="cpu"),
                                  steps=n, flush_every=1)
    assert seen and all(s == {torch.bfloat16} for s in seen)
    assert all(v.dtype == torch.float32 for v in tstate.params.values())
    assert all(v.dtype == torch.float32 for m in ("mu", "nu")
               for v in tstate.opt_state[m].values())

    # Each update's gradients against the JAX step's: value_and_grad of the
    # policy-cast loss (fluxmpi_tpu/parallel/train.py, ``policy``) at the
    # masters and batch that update saw.
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, x, y: jloss_fn(jpol.cast_to_compute(p), None, (x, y))[0]))
    assert len(fed) == len(batches) == n
    for (grads, masters), (x, y, loss) in zip(fed, batches):
        want_loss, want = jgrad(_nest(masters, params), jnp.asarray(x), jnp.asarray(y))
        assert abs(loss - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
        _assert_grads_close(grads, _flat(want))

    assert abs(tsummary["loss"] - jsummary["loss"]) <= LOSS_RTOL * abs(jsummary["loss"])
    got, want = to_flax_params(tlm), _flat(jax.device_get(jstate.params))
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], atol=2 * lr * n, rtol=0,
                                   err_msg=name)

    ev = make_eval_step(lambda p, ms, b: (seen.append({v.dtype for v in p.values()}),
                                          0)[1], policy=get_policy("bf16"))
    ev(tstate, None)
    assert seen[-1] == {torch.bfloat16}


def test_policy_raises_when_the_loss_ignores_the_params_it_is_given(port_world):
    """A ``loss_fn`` that computes from the module's own tensors never sees
    the cast parameters: ``policy=`` would train in f32 without a word."""
    tlm = TransformerLM(**CFG, attention="flash", device="cpu",
                        generator=torch.Generator().manual_seed(2))
    corpus = torch.from_numpy(_corpus(n=8))
    batch = (corpus[:, :-1], corpus[:, 1:])
    opt = optim.adamw(1e-3)
    own = make_train_step(lambda p, ms, b: (tlm(b[0], targets=b[1]).mean(), ms), opt,
                          policy=get_policy("bf16"))
    state = TrainState.create(tlm, opt)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    with pytest.raises(ValueError, match="policy= has no effect"):
        own(state, batch)
    assert state.step == 0
    assert all(torch.equal(state.params[k], before[k]) for k in before)

    given = make_train_step(
        lambda p, ms, b: (torch.func.functional_call(
            tlm, p, (b[0],), {"targets": b[1]}).mean(), ms),
        opt, policy=get_policy("bf16"), remat=True)
    state, loss = given(state, batch)
    state, loss = given(state, batch)  # checked once; the second runs as usual
    assert state.step == 2 and torch.isfinite(loss)
    # A policy whose compute dtype is the masters' casts nothing: no check.
    same = make_train_step(lambda p, ms, b: (tlm(b[0], targets=b[1]).mean(), ms), opt,
                           policy=get_policy("f32"))
    state, _ = same(state, batch)
    assert state.step == 3


def test_remat_gives_the_same_bits_and_recomputes_the_forward(port_world, monkeypatch):
    corpus = _corpus(n=16)
    batches = [(torch.from_numpy(corpus[i:i + 8, :-1]),
                torch.from_numpy(corpus[i:i + 8, 1:])) for i in (0, 8)]
    calls = []
    plain = fa.flash_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    results = {}
    for remat in (False, True, "dots"):
        lm = TransformerLM(**CFG, attention="flash", device="cpu",
                           generator=torch.Generator().manual_seed(5))
        opt = optim.adamw(1e-3)
        step = make_train_step(
            lambda p, ms, b, lm=lm: (lm(b[0], targets=b[1], loss_chunk=40).mean(), ms),
            opt, remat=remat)
        state = TrainState.create(lm, opt)
        calls.clear()
        for batch in batches:
            state, _ = step(state, batch)
        results[remat] = ({k: v.detach().clone() for k, v in state.params.items()},
                          len(calls))
    base, n_plain = results[False]
    assert n_plain == 2 * L  # one forward per layer per update
    for remat in (True, "dots"):
        params, n = results[remat]
        assert n == 2 * n_plain, remat  # the forward runs again in the backward
        for k in base:
            assert torch.equal(params[k], base[k]), (remat, k)
    with pytest.raises(ValueError, match="remat must be False, True, or 'dots'"):
        make_train_step(lambda p, s, b: (None, s), opt, remat="everything")
