"""The port's ``generate`` (greedy and sampled, batched and scan prefill)
and ``beam_search`` against the JAX package's, on the same weights
(converted from JAX params, f32, CPU): greedy tokens equal, the filtered
distributions' supports equal to the kept set JAX's rule gives and the
frequencies within a chi-square bound, scan and batched sampled runs bit
for bit within the port, JAX's validation errors, beam tokens equal and
scores within 1e-5, and the JAX package's own beam-search oracles
(beam 1 is greedy, the exhaustive beam is the global optimum, eos is
absorbing)."""

from itertools import product

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.stats import chi2

from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.generate import beam_search as jax_beam_search
from fluxmpi_tpu.models.generate import generate as jax_generate
from fluxmpi_tpu_torch.models import TransformerLM, beam_search, generate, load_flax_params

torch.set_num_threads(1)

VOCAB = 97
CFG = dict(vocab_size=VOCAB, max_len=64, num_layers=2, d_model=32, num_heads=4,
           d_ff=64)


def _convert(jlm, params, **kw):
    tlm = TransformerLM(**{**CFG, **kw}, device="cpu")
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return tlm


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(**CFG)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                      train=False)
    return jlm, params, _convert(jlm, params)


def _prompt(seed, b, plen):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, plen)).astype(np.int32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("prefill", ["batched", "scan", "auto"])
def test_greedy_tokens_match_jax(pair, prefill, with_eos):
    """Tokens equal, exactly (f32 on both sides; eos from a free run so it
    fires)."""
    jlm, params, tlm = pair
    prompt = _prompt(4, 3, 7)
    eos = None
    if with_eos:
        free = generate(tlm, prompt, 12)[0, 7:].numpy()
        eos = int(free[3])
    want = np.asarray(jax_generate(jlm, params, jnp.asarray(prompt), 12,
                                   eos_token=eos, prefill=prefill))
    got = generate(tlm, prompt, 12, eos_token=eos, prefill=prefill).numpy()
    np.testing.assert_array_equal(got, want)
    if with_eos:
        row = got[0, 7:]
        assert np.all(row[np.flatnonzero(row == eos)[0]:] == eos)


def test_inference_ignores_the_training_dropout_rate(pair):
    """Inference runs ``train=False`` as in JAX: a model built with
    ``dropout=0.1`` (what ``lm_from_gpt2`` gives for stock GPT-2)
    generates and serves the dropout-free tokens, and JAX's own tokens."""
    from fluxmpi_tpu_torch.serving import InferenceEngine

    jlm, params, tlm = pair
    dlm = _convert(jlm, params, dropout=0.1)
    prompt = _prompt(2, 2, 6)
    want = np.asarray(jax_generate(JaxLM(**CFG, dropout=0.1), params,
                                   jnp.asarray(prompt), 8))
    got = generate(dlm, prompt, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, generate(tlm, prompt, 8))
    eng = InferenceEngine(dlm, slots=2, block_size=8)
    reqs = [eng.submit(p, 8) for p in prompt]
    eng.run()
    assert [r.tokens for r in reqs] == got[:, 6:].tolist()
    eng.close()


# ---------------------------------------------------------------------------
# Sampling filters against JAX's rule
# ---------------------------------------------------------------------------


def _kept_probs(logits, temperature, top_k, top_p):
    """JAX's filter rule in numpy (float64): the k-filter on the raw
    logits, then the nucleus on the scaled ones (kept: the descending
    prefix whose exclusive cumulative probability is < top_p)."""
    x = logits.astype(np.float64)
    if top_k is not None and top_k < len(x):
        x = np.where(x < np.sort(x)[::-1][top_k - 1], -np.inf, x)
    x = x / temperature
    if top_p is not None and top_p < 1.0:
        srt = np.sort(x)[::-1]
        p = np.exp(srt - srt.max())
        p /= p.sum()
        keep = (np.cumsum(p) - p) < top_p
        x = np.where(x < srt[keep].min(), -np.inf, x)
    p = np.exp(x - x.max())
    return p / p.sum()


FILTERS = [dict(temperature=0.7), dict(temperature=0.7, top_k=5),
           dict(temperature=0.7, top_p=0.8),
           dict(temperature=0.7, top_k=5, top_p=0.8)]


@pytest.mark.parametrize("filt", FILTERS, ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()))
def test_filtered_draws_match_jax_rule(pair, filt):
    """512 copies of one prompt, one new token: each package's drawn set
    lies inside JAX's kept set and holds every kept token of probability
    >= 0.02 (expected count >= 10), and each package's frequencies pass a
    chi-square test against the filtered softmax at p = 1e-3 (bins with
    expected count >= 5, the rest pooled). Fixed seeds."""
    jlm, params, tlm = pair
    prompt = np.repeat(_prompt(9, 1, 6), 512, axis=0)
    logits = np.asarray(jlm.apply(params, jnp.asarray(prompt[:1]), train=False))[0, -1]
    probs = _kept_probs(logits, filt["temperature"], filt.get("top_k"),
                        filt.get("top_p"))
    kept = set(np.flatnonzero(probs > 0).tolist())
    if "top_k" in filt or "top_p" in filt:
        assert len(kept) < VOCAB
    jax_draw = np.asarray(jax_generate(jlm, params, jnp.asarray(prompt), 1,
                                       rng=jax.random.PRNGKey(3), **filt))[:, -1]
    port_draw = generate(tlm, prompt, 1, rng=_gen(3), **filt)[:, -1].numpy()
    expected = probs * 512
    big = expected >= 5
    for draw in (jax_draw, port_draw):
        drawn = set(np.unique(draw).tolist())
        assert drawn <= kept
        assert {t for t in kept if probs[t] >= 0.02} <= drawn
        counts = np.bincount(draw, minlength=VOCAB)
        obs = np.append(counts[big], counts[~big].sum())
        exp = np.append(expected[big], expected[~big].sum())
        if exp[-1] == 0:
            obs, exp = obs[:-1], exp[:-1]
        stat = ((obs - exp) ** 2 / exp).sum()
        assert stat < chi2.ppf(1 - 1e-3, len(obs) - 1), (stat, obs, exp)


def test_degenerate_filters(pair):
    """``top_k=1`` and ``top_p=1e-6`` keep the argmax alone: greedy.
    ``top_p=1.0`` filters nothing: bit-identical to no filter under the
    same generator."""
    _, _, tlm = pair
    prompt = _prompt(5, 4, 5)
    greedy = generate(tlm, prompt, 10)
    for filt in (dict(top_k=1), dict(top_p=1e-6)):
        got = generate(tlm, prompt, 10, temperature=0.9, rng=_gen(1), **filt)
        assert torch.equal(got, greedy), filt
    plain = generate(tlm, prompt, 10, temperature=0.9, rng=_gen(2))
    full = generate(tlm, prompt, 10, temperature=0.9, top_p=1.0, rng=_gen(2))
    assert torch.equal(plain, full)
    assert not torch.equal(plain, greedy)


@pytest.mark.parametrize("filt", [dict(temperature=1.0), dict(temperature=0.8, top_k=7),
                                  dict(temperature=1.2, top_p=0.9)],
                         ids=["t1", "topk", "topp"])
def test_scan_equals_batched_when_sampling(pair, filt):
    """Equal seeds, both prefill paths: the same tokens, bit for bit (the
    batched path advances the generator by the scan's prompt-tick draws);
    another seed draws other tokens."""
    _, _, tlm = pair
    prompt = _prompt(6, 3, 9)
    scan = generate(tlm, prompt, 12, rng=_gen(7), prefill="scan", **filt)
    batched = generate(tlm, prompt, 12, rng=_gen(7), prefill="batched", **filt)
    assert torch.equal(scan, batched)
    assert torch.equal(scan[:, :9], torch.from_numpy(prompt).long())
    other = generate(tlm, prompt, 12, rng=_gen(8), prefill="batched", **filt)
    assert not torch.equal(other, batched)


BAD_ARGS = [
    (dict(max_new_tokens=100), "max_len"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(temperature=1.0), "rng"),
    (dict(temperature=-1.0), "temperature"),
    (dict(temperature=1.0, top_k=0, rng=True), "top_k"),
    (dict(temperature=1.0, top_p=0.0, rng=True), "top_p"),
    (dict(temperature=1.0, top_p=1.5, rng=True), "top_p"),
    (dict(eos_token=VOCAB), "vocabulary"),
    (dict(prefill="chunked"), "prefill"),
]


@pytest.mark.parametrize("kwargs,match", BAD_ARGS, ids=[m for _, m in BAD_ARGS])
def test_validation_errors_match_jax(pair, kwargs, match):
    """Each bad argument raises ``ValueError`` naming it, in both
    packages, with the same message."""
    jlm, params, tlm = pair
    kw = dict(kwargs)
    n = kw.pop("max_new_tokens", 4)
    rng = kw.pop("rng", None)
    prompt = _prompt(0, 1, 4)
    with pytest.raises(ValueError, match=match) as jerr:
        jax_generate(jlm, params, jnp.asarray(prompt), n,
                     rng=jax.random.PRNGKey(0) if rng else None, **kw)
    with pytest.raises(ValueError, match=match) as terr:
        generate(tlm, prompt, n, rng=_gen() if rng else None, **kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_matches_jax(pair, beam, alpha, with_eos):
    """Tokens equal and scores within 1e-5 absolute (f32 log-softmax sums
    over 10 ticks)."""
    jlm, params, tlm = pair
    prompt = _prompt(11, 2, 6)
    eos = int(generate(tlm, prompt, 10)[0, 8]) if with_eos else None
    want_t, want_s = jax_beam_search(jlm, params, jnp.asarray(prompt), 10,
                                     beam_size=beam, length_penalty=alpha,
                                     eos_token=eos)
    got_t, got_s = beam_search(tlm, prompt, 10, beam_size=beam,
                               length_penalty=alpha, eos_token=eos)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_s.dtype == torch.float32 and got_s.shape == (2,)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)


def _small(vocab, max_len, seed, d_model=16, num_heads=2, d_ff=32, num_layers=1):
    cfg = dict(vocab_size=vocab, max_len=max_len, num_layers=num_layers,
               d_model=d_model, num_heads=num_heads, d_ff=d_ff)
    jlm = JaxLM(**cfg)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2), jnp.int32), train=False)
    tlm = TransformerLM(**cfg, device="cpu")
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return tlm


def test_beam_search_beam1_matches_greedy():
    tlm = _small(32, 24, 0, d_model=32, num_heads=4, d_ff=64, num_layers=2)
    prompt = np.random.default_rng(3).integers(0, 32, (2, 5)).astype(np.int32)
    greedy = generate(tlm, prompt, 7)
    toks, scores = beam_search(tlm, prompt, 7, beam_size=1)
    assert toks.shape == (2, 12) and scores.shape == (2,)
    assert torch.equal(toks, greedy)
    assert torch.isfinite(scores).all()


def test_beam_search_finds_global_optimum():
    """beam = vocab ** new makes the search exhaustive: it must equal the
    argmax over every continuation scored by teacher-forced
    log-likelihood through the full causal forward (no cache)."""
    vocab, plen, new = 6, 2, 3
    tlm = _small(vocab, 8, 2)
    prompt = np.random.default_rng(7).integers(0, vocab, (2, plen)).astype(np.int32)
    best_toks, best_scores = beam_search(tlm, prompt, new, beam_size=vocab ** new)
    conts = np.array(list(product(range(vocab), repeat=new)), np.int64)
    n = len(conts)
    for row in range(2):
        seqs = np.concatenate([np.tile(prompt[row], (n, 1)), conts], axis=1)
        with torch.no_grad():
            logp = torch.log_softmax(tlm(torch.from_numpy(seqs), train=False), -1).numpy()
        scores = np.zeros(n)
        for t in range(plen - 1, plen + new - 1):
            scores += logp[np.arange(n), t, seqs[:, t + 1]]
        k = int(np.argmax(scores))
        np.testing.assert_allclose(float(best_scores[row]), scores[k], atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(best_toks[row, plen:].numpy(), conts[k])


def test_beam_search_eos_absorbing_and_validation():
    vocab = 4
    tlm = _small(vocab, 12, 0)
    prompt = np.asarray([[1, 2], [0, 3]], np.int32)
    for eos in range(vocab):
        toks, scores = beam_search(tlm, prompt, 6, beam_size=3, eos_token=eos,
                                   length_penalty=0.6)
        gen = toks[:, 2:].numpy()
        assert torch.isfinite(scores).all()
        for row in gen:
            hits = np.flatnonzero(row == eos)
            if hits.size:
                assert np.all(row[hits[0]:] == eos)
        # The score is the teacher-forced rescoring of the returned
        # sequence, penalised at its finish length.
        hits = np.flatnonzero(gen[0] == eos)
        flen = int(hits[0]) + 1 if hits.size else 6
        seq = toks[0:1, :2 + flen]
        with torch.no_grad():
            logp = torch.log_softmax(tlm(seq, train=False), -1).numpy()
        raw = sum(logp[0, t, int(seq[0, t + 1])] for t in range(1, 1 + flen))
        lp = ((5.0 + flen) / 6.0) ** 0.6
        np.testing.assert_allclose(float(scores[0]), raw / lp, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(tlm, prompt, 4, beam_size=0)
    with pytest.raises(ValueError, match="max_len"):
        beam_search(tlm, prompt, 100, beam_size=2)
    with pytest.raises(ValueError, match="vocabulary"):
        beam_search(tlm, prompt, 4, beam_size=2, eos_token=vocab)
