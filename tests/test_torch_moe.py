"""The MoE models against the JAX package's, on the same weights (flax's
init, copied with ``load_flax_params``), f32 on the CPU:

- ``MoEMLP`` under Switch top-1, GShard top-2, expert choice, explicit
  ``n_groups`` and a capacity that drops tokens: the routing first (the
  chosen experts ``topk_idx``, then the kept positions, i.e. the dispatch
  tensor, exactly; the smallest top-1 margin is printed, since a routing
  difference at a margin above 1e-6 is a fault), then the output, the
  two sowed losses and the gradients of every parameter and the input;
- ``collect_moe_losses`` over the LM's nested collection;
- ``MoETransformerLM``'s logits, per-token losses and gradients (task loss
  plus both sowed losses), its greedy ``generate`` token for token (the
  ``"auto"`` prefill is the scan, equal to an explicit ``"scan"``), and
  the expert-choice warning.

Tolerances: outputs and losses atol 1e-5, gradients ``max|diff| <= 1e-4 *
max|g|`` per leaf (sums over other orders; an attention key bias, whose
gradient is rounding noise around 0, atol 1e-6), routing exact.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models.generate import generate as jax_generate
from fluxmpi_tpu.models.moe import MoEMLP as JaxMoEMLP
from fluxmpi_tpu.models.moe import MoETransformerLM as JaxMoELM
from fluxmpi_tpu.models.moe import collect_moe_losses as jax_collect
from fluxmpi_tpu_torch.models import (MoEMLP, MoETransformerLM, collect_moe_losses,
                                      generate, load_flax_params, to_flax_params)

torch.set_num_threads(1)

D, E, DFF = 16, 4, 32
LM = dict(vocab_size=48, max_len=32, num_layers=2, d_model=D, num_heads=2, d_ff=DFF,
          num_experts=E)
VARIANTS = {"top1": {}, "top2": dict(top_k=2), "experts": dict(routing="experts"),
            "groups": dict(n_groups=4), "drops": dict(capacity_factor=0.5)}


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        # A key bias's gradient is 0 in exact arithmetic: rounding noise.
        bound = 1e-6 if k.endswith("attn/key/bias") else 1e-4 * np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= bound, k


def _jax_routing(probs, top_k, capacity):
    """The reference's token-choice routing (``MoEMLP.__call__``) on JAX's
    router probabilities: ``(topk_idx, dispatch)``."""
    _, idx = jax.lax.top_k(probs, top_k)
    g, _, e = probs.shape
    dispatch = jnp.zeros(probs.shape + (capacity,))
    counts = jnp.zeros((g, 1, e))
    for c in range(top_k):
        onehot = jax.nn.one_hot(idx[..., c], e)
        pos = (jnp.cumsum(onehot, axis=1) - 1.0 + counts) * onehot
        kept = (pos < capacity) & (onehot > 0)
        dispatch = dispatch + jax.nn.one_hot(pos.astype(jnp.int32), capacity) * kept[..., None]
        counts = counts + jnp.sum(onehot, axis=1, keepdims=True)
    return np.asarray(idx), np.asarray(dispatch)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_moe_mlp_routing_outputs_losses_and_gradients(name):
    kw = VARIANTS[name]
    x = np.random.default_rng(1).normal(size=(2, 8, D)).astype(np.float32)
    jm = JaxMoEMLP(num_experts=E, d_ff=DFF, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), x)["params"])
    tm = load_flax_params(MoEMLP(E, DFF, d_model=D, device="cpu", **kw), params)

    # Routing first.
    groups = kw.get("n_groups", 2)
    tokens = x.reshape(groups, -1, D)
    jprobs = jax.nn.softmax(jnp.einsum("gsd,de->gse", tokens, params["router"]), axis=-1)
    tprobs = torch.softmax(torch.einsum("gsd,de->gse", torch.from_numpy(tokens),
                                        tm.router.detach()), dim=-1)
    top2 = np.sort(np.asarray(jprobs), axis=-1)[..., -2:]
    print(f"{name}: smallest top-1 margin {float((top2[..., 1] - top2[..., 0]).min()):.3e}")
    if kw.get("routing") == "experts":
        gs = tokens.shape[1]
        cap = min(gs, max(1, int(-(-gs * tm.capacity_factor // E))))
        _, jidx = jax.lax.top_k(jnp.transpose(jprobs, (0, 2, 1)), cap)
        _, tidx = torch.sort(tprobs.transpose(1, 2), dim=-1, descending=True, stable=True)
        np.testing.assert_array_equal(tidx[..., :cap].numpy(), np.asarray(jidx))
    else:
        jidx, jdispatch = _jax_routing(jprobs, tm.top_k, tm.capacity(tokens.shape[1]))
        tdispatch, _, tidx, _ = tm.route(tprobs)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        np.testing.assert_array_equal(tdispatch.numpy(), jdispatch)
        if name == "drops":
            assert tdispatch.sum() < tokens.shape[0] * tokens.shape[1]  # some dropped

    # Output, sowed losses, gradients.
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, st = jm.apply({"params": p}, x, mutable=["losses"])
        aux, z = jax_collect(st["losses"])
        return jnp.sum(y * w) + aux + z, (y, aux, z)

    (_, (jy, jaux, jz)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    losses = {}
    y = tm(xt, losses=losses)
    aux, z = collect_moe_losses(losses)
    total = (y * torch.from_numpy(w)).sum() + aux + z
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(total, list(tm.parameters()) + [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(z.detach()), float(jz), atol=1e-5, rtol=0)
    _close_grads(to_flax_params(dict(zip(names, grads[:-1]))), _flat(jg))
    _close_grads({"x": grads[-1].numpy()}, {"x": np.asarray(jgx)})


@pytest.fixture(scope="module")
def lm_pair():
    jlm = JaxMoELM(**LM)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tlm = load_flax_params(MoETransformerLM(**LM, device="cpu"), params["params"])
    return jlm, params, tlm


def test_moe_lm_forward_losses_and_gradients(lm_pair):
    jlm, params, tlm = lm_pair
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 48, (2, 12)).astype(np.int32)
    tgt = rng.integers(0, 48, (2, 12)).astype(np.int32)
    jlogits = jax.jit(lambda p: jlm.apply(p, tok, train=False))(params)
    np.testing.assert_allclose(tlm(tok, train=False).detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)

    def jloss(p):
        ce, st = jlm.apply({"params": p}, tok, train=False, targets=tgt, mutable=["losses"])
        aux, z = jax_collect(st["losses"])
        return jnp.mean(ce) + 1e-2 * aux + 1e-3 * z, (ce, st["losses"])

    (_, (jce, jlosses)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params["params"])
    losses = {}
    ce = tlm(tok, targets=torch.from_numpy(tgt), losses=losses)
    aux, z = collect_moe_losses(losses)
    jaux, jz = jax_collect(jlosses)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce), atol=1e-5, rtol=0)
    np.testing.assert_allclose([float(aux.detach()), float(z.detach())],
                               [float(jaux), float(jz)], atol=1e-5)
    # The collection nests as flax's does, one entry per layer and loss.
    assert {k.rsplit("/", 1)[0] for k in _flat(jlosses)} == set(_flat_keys(losses))
    total = ce.mean() + 1e-2 * aux + 1e-3 * z
    names = [n for n, _ in tlm.named_parameters()]
    grads = torch.autograd.grad(total, list(tlm.parameters()))
    _close_grads(to_flax_params(dict(zip(names, grads))), _flat(jg))


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_keys(v, path)
        else:
            yield path


def test_moe_lm_greedy_generate_token_for_token(lm_pair):
    jlm, params, tlm = lm_pair
    assert tlm.batched_prefill_safe is False
    prompt = np.random.default_rng(7).integers(0, 48, (3, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jlm, params, jnp.asarray(prompt), 10))
    got = generate(tlm, prompt, 10).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(generate(tlm, prompt, 10, prefill="scan").numpy(), got)


def test_expert_choice_lm_warns_as_jax():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        MoETransformerLM(**LM, routing="experts", device="cpu")
        JaxMoELM(**LM, routing="experts").init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 4), jnp.int32), train=False)
    messages = [str(w.message) for w in caught if "expert-choice" in str(w.message)]
    assert len(messages) >= 2 and len(set(messages)) == 1
