"""The port's TransformerLM against the JAX package's: weights converted
from the JAX params, the same numpy tokens through both, f32 logits within
atol 1e-4 (the two frameworks sum in different orders), for the causal
forward and for cached decoding at several positions, with naive and
flash attention."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.generate import _decode_twin
from fluxmpi_tpu.models.generate import prefill_cache as jax_prefill_cache
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params, prefill_kv
from fluxmpi_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

ATOL = 1e-4
CFG = dict(vocab_size=97, max_len=64, num_layers=2, d_model=32, num_heads=4,
           d_ff=64)


def _pair(attention="naive", ln_eps=1e-6, seed=0):
    jlm = JaxLM(**CFG, attention=attention, ln_eps=ln_eps)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
                      train=False)
    tlm = TransformerLM(**CFG, attention=attention, ln_eps=ln_eps, device="cpu")
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return jlm, params, tlm


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_logits_match_jax(attention):
    jlm, params, tlm = _pair(attention)
    toks = _tokens(1, 2, 24)
    want = np.asarray(jlm.apply(params, jnp.asarray(toks), train=False))
    got = tlm(torch.from_numpy(toks)).detach().numpy()
    assert got.shape == want.shape == (2, 24, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_decode_at_several_positions_matches_jax_decode_twin(attention):
    """One batched port decode call with a different position per row
    against the JAX decode twin run once per position."""
    jlm, params, tlm = _pair(attention, seed=1)
    total = 40
    positions = np.array([1, 7, 16, 33])
    b = len(positions)
    toks = _tokens(2, b, total)
    k, v, _ = prefill_kv(tlm, torch.from_numpy(toks[:, : positions.max()]))
    shape = tlm.cache_shape(b, total)
    k_cache, v_cache = torch.zeros(shape), torch.zeros(shape)
    for i, p in enumerate(positions):
        k_cache[:, i, :p] = k[:, i, :p]
        v_cache[:, i, :p] = v[:, i, :p]
    feed = toks[np.arange(b), positions]
    got = tlm(torch.from_numpy(feed)[:, None], pos_offset=torch.from_numpy(positions),
              kv_cache=(k_cache, v_cache)).numpy()[:, 0]

    twin = _decode_twin(jlm)
    for i, p in enumerate(positions):
        cache, _ = jax_prefill_cache(jlm, params, jnp.asarray(toks[:, :p]), total)
        logits, mut = twin.apply(
            {"params": params["params"], "cache": cache},
            jnp.asarray(toks[:, p:p + 1]), train=False, pos_offset=int(p),
            mutable=["cache"])
        np.testing.assert_allclose(got[i], np.asarray(logits)[i, -1], atol=ATOL, rtol=0)
        written = np.asarray(
            mut["cache"]["encoder"]["block_0"]["attn"]["cached_key"])[i, p]
        np.testing.assert_allclose(k_cache[0, i, p].numpy(), written, atol=ATOL, rtol=0)


def test_ln_eps_threads_through_every_layer_norm():
    jlm, params, tlm = _pair(ln_eps=1e-5, seed=2)
    eps = {m.eps for m in tlm.modules() if isinstance(m, tt.LayerNorm)}
    assert eps == {1e-5}
    toks = _tokens(3, 1, 12)
    want = np.asarray(jlm.apply(params, jnp.asarray(toks), train=False))
    np.testing.assert_allclose(tlm(torch.from_numpy(toks)).detach().numpy(), want,
                               atol=ATOL, rtol=0)


def test_gelu_is_flax_tanh_form():
    block = tt.EncoderBlock(8, 2, 16, 0.0, torch.float32, ln_eps=1e-6, device="cpu",
                            generator=torch.Generator())
    with torch.no_grad():
        for m in (block.ln1, block.ln2):
            m.scale.fill_(1.0)
        block.ff1.kernel.copy_(torch.eye(8, 16))
        block.ff2.kernel.copy_(torch.eye(16, 8))
        for p in (block.attn.out.kernel, block.attn.out.bias):
            p.zero_()
    # With zero attention output and identity FF kernels, the block adds
    # gelu(ln2(x)) to x: read the activation off the residual.
    h = torch.linspace(-3.0, 3.0, 8).reshape(1, 1, 8)
    with torch.no_grad():
        y = block(h, train=False)
    ln = torch.nn.functional.layer_norm(h, (8,), eps=1e-6)
    act = (y - h).numpy()
    flax_act = np.asarray(fnn.gelu(jnp.asarray(ln.numpy())))
    np.testing.assert_allclose(act, flax_act, atol=1e-6, rtol=0)
    exact = torch.nn.functional.gelu(ln).numpy()
    assert np.abs(exact - flax_act).max() > 1e-4  # the pin is meaningful


def test_head_is_tied_to_the_embedding():
    jlm, params, tlm = _pair(seed=3)
    names = {n for n, _ in tlm.named_parameters()}
    assert not any("head" in n for n in names)
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tlm.parameters()) == n_jax
    toks = torch.from_numpy(_tokens(4, 1, 8))
    before = tlm(toks)
    with torch.no_grad():
        tlm.embed.embedding[5] += 1.0  # moves the logit of token 5 everywhere
    after = tlm(toks)
    moved = (after - before).abs().amax(dim=(0, 1))
    assert moved[5] > 10 * moved[torch.arange(97) != 5].max()


def test_convert_rejects_missing_extra_and_misshaped_leaves():
    _, params, tlm = _pair(seed=4)
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    del bad["params"]["encoder"]["block_1"]["ff2"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tlm, bad)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["params"]["encoder"]["block_1"]["head"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="unexpected"):
        load_flax_params(tlm, bad)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["params"]["pos_embed"] = np.zeros((32, 32), np.float32)
    with pytest.raises(ValueError, match="mis-shaped"):
        load_flax_params(tlm, bad)


def test_attention_switch_resolves_and_validates():
    lm = TransformerLM(**CFG, attention="auto", device="cpu")
    assert lm.attention_mode() == "naive"  # flash only on CUDA
    assert lm.attention_mode("flash") == "flash"
    with pytest.raises(ValueError, match="attention must be"):
        TransformerLM(**CFG, attention="dense", device="cpu")
    with pytest.raises(ValueError, match="one token per row"):
        lm(torch.zeros((1, 2), dtype=torch.long), pos_offset=0,
           kv_cache=(torch.zeros(lm.cache_shape(1, 8)),) * 2)
