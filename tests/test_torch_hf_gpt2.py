"""``lm_from_gpt2`` in the port: a plain object with ``.config`` and
``.state_dict()`` converts without ``transformers``; a tiny random
``GPT2LMHeadModel`` converts to logits equal to HF's forward (1e-5) and to
the JAX package's import (1e-4), greedy tokens equal to both, and the
drift guard, the refused configs and the dropout rule behave as the JAX
package's (``tests/test_hf_import.py``)."""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluxmpi_tpu.models import generate as jax_generate
from fluxmpi_tpu.models import lm_from_gpt2 as jax_lm_from_gpt2
from fluxmpi_tpu_torch.models import generate, lm_from_gpt2, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.serving import InferenceEngine

torch.set_num_threads(1)

GPT2_KEYS = dict(vocab_size=96, n_positions=32, n_embd=48, n_layer=2, n_head=4,
                 n_inner=None, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new")


def _state_dict(cfg, seed=0):
    """A GPT-2 state dict under HF's key names and layouts (Conv1D
    ``[in, out]``), random from a seeded generator, LN scales off 1."""
    g = torch.Generator().manual_seed(seed)
    d, v, p = cfg.n_embd, cfg.vocab_size, cfg.n_positions

    def rnd(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    sd = {"transformer.wte.weight": rnd(v, d), "transformer.wpe.weight": rnd(p, d),
          "transformer.ln_f.weight": 1 + rnd(d, std=0.1),
          "transformer.ln_f.bias": rnd(d)}
    for i in range(cfg.n_layer):
        h = f"transformer.h.{i}"
        sd.update({
            f"{h}.ln_1.weight": 1 + rnd(d, std=0.1), f"{h}.ln_1.bias": rnd(d),
            f"{h}.attn.c_attn.weight": rnd(d, 3 * d), f"{h}.attn.c_attn.bias": rnd(3 * d),
            f"{h}.attn.c_proj.weight": rnd(d, d), f"{h}.attn.c_proj.bias": rnd(d),
            f"{h}.ln_2.weight": 1 + rnd(d, std=0.1), f"{h}.ln_2.bias": rnd(d),
            f"{h}.mlp.c_fc.weight": rnd(d, 4 * d), f"{h}.mlp.c_fc.bias": rnd(4 * d),
            f"{h}.mlp.c_proj.weight": rnd(4 * d, d), f"{h}.mlp.c_proj.bias": rnd(d),
        })
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def _plain(pdrop=0.0, **over):
    cfg = SimpleNamespace(**{**GPT2_KEYS, **over}, resid_pdrop=pdrop, embd_pdrop=pdrop,
                          attn_pdrop=pdrop)
    sd = _state_dict(cfg)
    return SimpleNamespace(config=cfg, state_dict=lambda: sd)


def _tokens(b=3, s=17, vocab=96):
    return np.random.default_rng(0).integers(0, vocab, (b, s))


def test_plain_object_converts_and_matches_jax():
    """No ``transformers``: the converted tree equals the JAX package's
    leaf for leaf, the model holds it, and the logits agree within 1e-4."""
    hf = _plain()
    model, variables = lm_from_gpt2(hf, device="cpu")
    jmodel, jvars = jax_lm_from_gpt2(hf)
    assert (model.num_layers, model.d_model, model.num_heads, model.d_ff) == (2, 48, 4, 192)
    assert model.ln_eps == 1e-5 and model.dropout == 0.0
    mine = to_flax_params(model)
    ref = {k.replace(".", "/"): v for k, v in _flat(jvars["params"]).items()}
    assert set(mine) == set(ref) == {k.replace(".", "/") for k in _flat(variables["params"])}
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    toks = _tokens()
    with torch.no_grad():
        got = model(torch.from_numpy(toks), train=False).numpy()
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(toks.astype(np.int32)), train=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_variables_load_into_a_bf16_model():
    from fluxmpi_tpu_torch.models import TransformerLM

    model, variables = lm_from_gpt2(_plain(), device="cpu")
    bf16 = TransformerLM(vocab_size=96, max_len=32, num_layers=2, d_model=48,
                         num_heads=4, d_ff=192, ln_eps=1e-5, dtype=torch.bfloat16,
                         device="cpu")
    load_flax_params(bf16, variables)
    for (n, a), (_, b) in zip(model.named_parameters(), bf16.named_parameters()):
        assert torch.equal(a, b), n


def test_drift_guard_and_refused_knobs():
    hf = _plain()
    sd = dict(hf.state_dict())
    sd["transformer.wpe.weight"] = torch.zeros((7, 48))
    bad = SimpleNamespace(config=hf.config, state_dict=lambda: sd)
    with pytest.raises(ValueError, match="does not match"):
        lm_from_gpt2(bad, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        jax_lm_from_gpt2(bad)
    for knob, value in (("activation_function", "relu"),
                        ("scale_attn_by_inverse_layer_idx", True),
                        ("reorder_and_upcast_attn", True),
                        ("tie_word_embeddings", False)):
        hf = _plain(**{knob: value})
        with pytest.raises(ValueError, match=knob) as port:
            lm_from_gpt2(hf, device="cpu")
        with pytest.raises(ValueError, match=knob) as ref:
            jax_lm_from_gpt2(hf)
        assert str(port.value) == str(ref.value)


def test_dropout_rule_and_serving_with_dropout():
    """Stock pdrops (0.1) convert to ``dropout=0.1``; pdrops that differ
    warn as JAX's does; inference (generate, the engine) runs at 0.1 and
    equals the dropout-free conversion's tokens."""
    model, _ = lm_from_gpt2(_plain(pdrop=0.1), device="cpu")
    assert model.dropout == 0.1
    ref, _ = lm_from_gpt2(_plain(), device="cpu")
    prompt = _tokens(2, 6)
    out = generate(model, prompt, 8)
    assert torch.equal(out, generate(ref, prompt, 8))
    eng = InferenceEngine(model, slots=2, block_size=8)
    reqs = [eng.submit(p, 8) for p in prompt]
    eng.run()
    for req, row in zip(reqs, out[:, 6:].numpy()):
        assert req.tokens == row.tolist()
    eng.close()
    hf = _plain(pdrop=0.1)
    hf.config.attn_pdrop = 0.0
    with pytest.warns(UserWarning, match="attn_pdrop=0.0") as port:
        lm_from_gpt2(hf, device="cpu")
    with pytest.warns(UserWarning, match="attn_pdrop=0.0") as ref_w:
        jax_lm_from_gpt2(hf)
    assert str(port[0].message) == str(ref_w[0].message)


# ---------------------------------------------------------------------------
# With transformers (skipped where it is not installed)
# ---------------------------------------------------------------------------


def _tiny_gpt2(seed=0):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=32, n_embd=48, n_layer=2,
                                  n_head=4, resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    torch.manual_seed(seed)
    hf = transformers.GPT2LMHeadModel(cfg)
    hf.eval()
    return hf


def test_hf_logits_match_torch_and_jax():
    """HF's own forward is the oracle (1e-5); the JAX import within 1e-4."""
    hf = _tiny_gpt2()
    model, _ = lm_from_gpt2(hf, device="cpu")
    jmodel, jvars = jax_lm_from_gpt2(hf)
    assert model.ln_eps == hf.config.layer_norm_epsilon
    toks = _tokens()
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.numpy()
        got = model(torch.from_numpy(toks), train=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jgot = np.asarray(jmodel.apply(jvars, jnp.asarray(toks.astype(np.int32)), train=False))
    np.testing.assert_allclose(got, jgot, atol=1e-4, rtol=0)


def test_hf_generate_tokens_match():
    hf = _tiny_gpt2(seed=1)
    model, _ = lm_from_gpt2(hf, device="cpu")
    jmodel, jvars = jax_lm_from_gpt2(hf)
    prompt = np.asarray([[5, 11, 42, 7]], np.int64)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt), max_new_tokens=6, do_sample=False,
                           pad_token_id=0).numpy()
    got = generate(model, prompt, 6).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jax_generate(jmodel, jvars, jnp.asarray(prompt.astype(np.int32)), 6))
    np.testing.assert_array_equal(got, jgot)


def test_hf_drift_guard_and_unsupported_configs():
    transformers = pytest.importorskip("transformers")
    hf = _tiny_gpt2()
    bad = dict(hf.state_dict())
    bad["transformer.wpe.weight"] = torch.zeros((7, 48))

    class Wrapper:
        config = hf.config

        @staticmethod
        def state_dict():
            return bad

    with pytest.raises(ValueError, match="does not match"):
        lm_from_gpt2(Wrapper(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        relu = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=64, n_positions=16, n_embd=32, n_layer=1, n_head=2,
            activation_function="relu"))
        inv = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=64, n_positions=16, n_embd=32, n_layer=1, n_head=2,
            scale_attn_by_inverse_layer_idx=True))
    with pytest.raises(ValueError, match="activation_function"):
        lm_from_gpt2(relu, device="cpu")
    with pytest.raises(ValueError, match="scale_attn_by_inverse_layer_idx"):
        lm_from_gpt2(inv, device="cpu")
