"""Attention dropout in the port against the JAX package, on the CPU.

(a) ``flash_attention``'s dropout seed as a 0-d tensor (int64, or the
    int32 bit pattern of a uint32) equals the same ``int`` bit for bit,
    outputs and gradients, through the plain versions, with no host read of
    the tensor; both match JAX's ``flash_attention(dropout_seed=
    jnp.uint32(s))`` (its Pallas kernels in interpret mode) within 2e-5.
(b) The flash LM at ``dropout=0.1`` trained with a dropout generator
    against the JAX flash LM with ``rngs={"dropout": key}``: flax's keyword
    filter hands ``flash_attention_fn`` no rate, so neither drops; loss
    and every gradient within the LM parity tests' 2e-5, and the port's
    equal to its ``dropout=0.0`` model bit for bit.
(c) The naive LM's dense dropout (flax's ``dot_product_attention`` with
    ``broadcast_dropout=True``): flax's random stream cannot be
    reproduced, so the law is checked: the keep fraction within a 5-sigma
    binomial bound of ``1 - rate``, one ``[sq, sk]`` mask shared by every
    batch row and head (in flax's output too), kept weights scaled by
    ``1 / keep_prob`` exactly, the same draws under the same seeded
    generator, and ``train=False`` equal to a ``dropout=0.0`` model.
(d) An ``attention_fn`` whose signature names ``dropout_rng``,
    ``dropout_rate`` and ``deterministic``, dropping in the kernels with a
    fixed seed: both packages pass it the same keywords, and the loss and
    every gradient agree within 2e-5.
"""

import importlib

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.models._layers import dot_product_attention

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL = 2e-5
CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)
RATE = 0.1


def _no_host_read(self):
    raise AssertionError("a tensor dropout seed was read on the host")


def _qkvg(seed, b=2, s=32, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def _port(q, k, v, g, seed):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, dropout_rate=0.25,
                              dropout_seed=seed)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


@pytest.mark.parametrize("seed", [7, 2 ** 32 - 5])
def test_a_tensor_seed_equals_the_int_seed_and_jax(seed, monkeypatch):
    q, k, v, g = _qkvg(seed % 1000)
    want = _port(q, k, v, g, seed)
    bits = seed - 2 ** 32 if seed >= 2 ** 31 else seed
    monkeypatch.setattr(torch.Tensor, "item", _no_host_read)
    for tensor in (torch.tensor(seed), torch.tensor(bits, dtype=torch.int32),
                   torch.tensor([seed], dtype=torch.int64)):
        got = _port(q, k, v, g, tensor)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    monkeypatch.undo()

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, dropout_rate=0.25,
                                  dropout_seed=jnp.uint32(seed))
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    for a, b, label in zip(want, [jout, *jgrads], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0, err_msg=label)
    assert not np.array_equal(want[0], _port(q, k, v, g, seed + 1)[0])


def test_a_bad_tensor_seed_is_refused():
    x = torch.zeros(1, 4, 1, 8)
    for bad in (torch.zeros(2, dtype=torch.int64), torch.tensor(1.0),
                torch.tensor(True)):
        with pytest.raises(ValueError, match="dropout_seed"):
            tfa.flash_attention(x, x, x, dropout_rate=0.1, dropout_seed=bad)


def _flat(tree):
    tree = tree["params"] if set(tree) == {"params"} else tree
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(attention="naive", attention_fn=None, jax_fn=None, seed=0):
    jlm = JaxLM(**CFG, attention=attention, dropout=RATE, attention_fn=jax_fn)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32), train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tlm = TransformerLM(**CFG, attention=attention, dropout=RATE,
                        attention_fn=attention_fn, device="cpu")
    load_flax_params(tlm, params)
    return jlm, params, tlm


def _tokens(seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, CFG["vocab_size"], size=(b, s + 1)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


def _compare(jlm, params, tlm, x, y, gen):
    def jloss(p):
        return jlm.apply(p, jnp.asarray(x), train=True, targets=jnp.asarray(y),
                         loss_chunk=40, rngs={"dropout": jax.random.PRNGKey(5)}).mean()

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    loss = tlm(torch.from_numpy(x), targets=torch.from_numpy(y), loss_chunk=40,
               dropout_rng=gen).mean()
    grads = torch.autograd.grad(loss, list(tlm.parameters()))
    got = to_flax_params(dict(zip([n for n, _ in tlm.named_parameters()], grads)))
    want = _flat(want_grads)
    assert set(got) == set(want)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL, rtol=0)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=0, err_msg=name)
    return loss, grads


def test_flash_lm_with_dropout_trains_as_the_jax_flash_lm():
    jlm, params, tlm = _pair("flash", seed=1)
    x, y = _tokens(1)
    loss, grads = _compare(jlm, params, tlm, x, y, torch.Generator().manual_seed(0))
    plain = TransformerLM(**CFG, attention="flash", dropout=0.0, device="cpu")
    load_flax_params(plain, params)
    loss0 = plain(torch.from_numpy(x), targets=torch.from_numpy(y), loss_chunk=40).mean()
    assert torch.equal(loss, loss0)
    for a, b in zip(grads, torch.autograd.grad(loss0, list(plain.parameters()))):
        assert torch.equal(a, b)


def _dense_masks(b=3, h=4, s=64, d=8, seed=0):
    """The port's dense attend with and without dropout on the same inputs;
    returns (weights ratio, kept) per [b, h]: the output with V = identity
    is the (dropped) weight matrix."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    eye = torch.eye(s).expand(b, h, s, s).permute(0, 2, 1, 3).contiguous()
    gen = torch.Generator().manual_seed(seed)
    dropped = dot_product_attention(q, k, eye, dropout_rng=gen, dropout_rate=RATE,
                                    deterministic=False).permute(0, 2, 1, 3)
    plain = dot_product_attention(q, k, eye).permute(0, 2, 1, 3)
    return dropped, plain


def _within_five_sigma(kept: int, n: int, p: float) -> bool:
    return abs(kept - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def test_dense_dropout_keeps_flax_law():
    dropped, plain = _dense_masks()
    keep = dropped != 0
    assert bool((plain != 0).all())
    # One [sq, sk] mask for every batch row and head (broadcast_dropout).
    assert bool((keep == keep[:1, :1]).all())
    n = keep.shape[-1] * keep.shape[-2]
    assert _within_five_sigma(int(keep[0, 0].sum()), n, 1 - RATE)
    # Kept weights times keep / keep_prob, in the weights' dtype.
    scale = torch.tensor(1.0) / torch.tensor(1 - RATE)
    assert torch.equal(dropped, plain * keep.float() * scale)
    # The same generator state draws the same mask.
    again, _ = _dense_masks()
    assert torch.equal(again, dropped)
    # flax's own attend under its rng obeys the same law.
    rng = np.random.default_rng(0)
    b, s, h, d = 3, 64, 4, 8
    q, k = (jnp.asarray(rng.standard_normal((b, s, h, d)).astype(np.float32))
            for _ in range(2))
    w = fnn.dot_product_attention_weights(
        q, k, dropout_rng=jax.random.PRNGKey(1), dropout_rate=RATE, deterministic=False)
    fkeep = np.asarray(w) != 0
    assert (fkeep == fkeep[:1, :1]).all()
    assert _within_five_sigma(int(fkeep[0, 0].sum()), n, 1 - RATE)


def test_dense_dropout_needs_a_generator_and_eval_does_not_drop():
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="dropout_rng"):
        dot_product_attention(x, x, x, dropout_rate=RATE, deterministic=False)
    _, params, tlm = _pair("naive", seed=2)
    plain = TransformerLM(**CFG, attention="naive", dropout=0.0, device="cpu")
    load_flax_params(plain, params)
    x, y = (torch.from_numpy(t) for t in _tokens(2))
    assert torch.equal(tlm(x, train=False), plain(x, train=False))
    assert torch.equal(tlm(x, targets=y, train=False), plain(x, targets=y, train=False))
    with pytest.raises(ValueError, match="dropout_rng"):
        tlm(x, targets=y)
    draws = [tlm(x, targets=y, dropout_rng=torch.Generator().manual_seed(s)).mean()
             for s in (4, 4, 5)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], plain(x, targets=y).mean())


def test_attention_fn_naming_the_dropout_keywords_drops_as_in_jax():
    seen = {"jax": [], "port": []}

    def port_fn(query, key, value, mask=None, dropout_rng=None, dropout_rate=0.0,
                deterministic=True):
        seen["port"].append((dropout_rate, deterministic, dropout_rng is not None))
        return tfa.flash_attention(query, key, value, causal=True,
                                   dropout_rate=0.0 if deterministic else dropout_rate,
                                   dropout_seed=11)

    def jax_fn(query, key, value, mask=None, dropout_rng=None, dropout_rate=0.0,
               deterministic=True):
        seen["jax"].append((dropout_rate, deterministic, dropout_rng is not None))
        return jfa.flash_attention(query, key, value, causal=True,
                                   dropout_rate=0.0 if deterministic else dropout_rate,
                                   dropout_seed=jnp.uint32(11))

    jlm, params, tlm = _pair(attention_fn=port_fn, jax_fn=jax_fn, seed=3)
    seen["jax"].clear()
    x, y = _tokens(3)
    _compare(jlm, params, tlm, x, y, torch.Generator().manual_seed(0))
    assert seen["port"] == [(RATE, False, True)] * CFG["num_layers"]
    assert set(seen["jax"]) == {(RATE, False, True)}
