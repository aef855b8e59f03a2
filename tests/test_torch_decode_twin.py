"""The decode twin (``decode=True`` with flax's cache, ``_decode_twin``,
``cache_template``, ``_sized_cache``, ``layer_index``, ``prefill_cache``)
against the JAX package's, on the CPU, from the same numpy inputs and
converted weights:

- ``cache_template``'s paths, shapes and dtypes equal JAX's, for
  ``TransformerLM`` and ``MoETransformerLM`` in f32 and bf16, and for a
  12-layer LM (``block_10`` sorts after ``block_2``);
- the twin decodes 10 positions from a zero cache, teacher-forced; at
  every position its logits and every cache leaf (``cached_key``,
  ``cached_value``, ``cache_index``) equal JAX's twin under
  ``mutable=["cache"]``, with ``attention="naive"`` and ``"flash"`` (JAX's
  kernels in interpret mode, as its own CPU tests run them), and for the
  MoE LM;
- ``EncoderBlock`` and ``TransformerEncoder`` built with ``decode=True``
  against flax's decode, tick by tick;
- ``prefill_cache`` against JAX's ``prefill_cache`` (every leaf and the
  last logits);
- ``layer_index``'s order and its error text, an ``attention_fn`` ignored
  at decode, the twin sharing the model's storage, ``targets=`` refused as
  in JAX, and the cache carried in and out of flax's tree
  (``load_flax_cache``, ``to_flax_cache``).

Tolerances (f32 both sides, summed in other orders): logits atol 1e-4 (as
``tests/test_torch_transformer.py``); cache leaves and block outputs atol
1e-5; ``cache_index`` exact.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import MoETransformerLM as JaxMoE
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.transformer import EncoderBlock as JaxBlock
from fluxmpi_tpu.models.transformer import TransformerEncoder as JaxEncoder
from fluxmpi_tpu_torch.models import (EncoderBlock, MoETransformerLM, TransformerEncoder,
                                      TransformerLM, load_flax_cache, load_flax_params,
                                      to_flax_cache)
from fluxmpi_tpu_torch.models.generate import (_decode_twin, _sized_cache, cache_template,
                                               layer_index, prefill_cache)

torch.set_num_threads(1)
jgen = importlib.import_module("fluxmpi_tpu.models.generate")

ATOL, LEAF_ATOL = 1e-4, 1e-5
CFG = dict(vocab_size=61, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
KINDS = {"lm": (JaxLM, TransformerLM, {}), "moe": (JaxMoE, MoETransformerLM,
                                                   dict(num_experts=4))}


def _flat(tree):
    return {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(kind="lm", attention="naive", seed=0, **over):
    """A JAX model, its params moved off their init, and the port's with
    them."""
    jcls, tcls, extra = KINDS[kind]
    cfg = {**CFG, **extra, **over}
    jlm = jcls(**cfg, attention=attention)
    params = {"params": jax.jit(lambda: jlm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32), train=False))()["params"]}
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    tlm = tcls(**cfg, attention=attention, device="cpu")
    load_flax_params(tlm, params)
    return jlm, params, tlm


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _assert_cache(got: dict, want, step):
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    got = _flat(to_flax_cache(got))
    assert set(got) == set(want), step
    for k, w in want.items():
        if k.endswith("cache_index"):
            assert got[k].dtype == np.int32 and int(got[k]) == int(w), (step, k)
        else:
            np.testing.assert_allclose(got[k], w, atol=LEAF_ATOL, rtol=0,
                                       err_msg=f"{step} {k}")


@pytest.mark.parametrize("kind,dtype,layers", [("lm", "f32", 2), ("lm", "bf16", 2),
                                               ("moe", "f32", 2), ("moe", "bf16", 2),
                                               ("lm", "f32", 12)])
def test_cache_template_equals_jax(kind, dtype, layers):
    jcls, tcls, extra = KINDS[kind]
    jdt, tdt = DTYPES[dtype]
    cfg = {**CFG, **extra, "num_layers": layers}
    jtwin = jgen._decode_twin(jcls(**cfg, dtype=jdt))
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _flat(jgen.cache_template(jtwin, 3, 16)).items()}
    twin = _decode_twin(tcls(**cfg, dtype=tdt, device="cpu"))
    tmpl = cache_template(twin, 3, 16)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in tmpl.items()}
    assert got == want
    assert all(t.device.type == "meta" for t in tmpl.values())
    keys = sorted(tmpl, key=layer_index)
    assert [layer_index(k) for k in keys] == sorted(layer_index(k) for k in tmpl)
    if layers == 12:
        assert keys.index("encoder.block_10.attn.cached_key") > keys.index(
            "encoder.block_2.attn.cached_key")


@pytest.mark.parametrize("kind,attention", [("lm", "naive"), ("lm", "flash"),
                                            ("moe", "naive")])
def test_twin_decodes_like_jax_twin_at_every_position(kind, attention):
    jlm, params, tlm = _pair(kind, attention, seed=1)
    b, total, n = 3, 16, 10
    toks = _tokens(2, b, n)
    jtwin = jgen._decode_twin(jlm)
    apply = jax.jit(lambda c, t, p: jtwin.apply({"params": params["params"], "cache": c}, t,
                                                train=False, pos_offset=p, mutable=["cache"]))
    jcache = jgen._sized_cache(jtwin, b, total)
    twin = _decode_twin(tlm)
    cache = _sized_cache(twin, b, total)
    assert all(t.device.type == "cpu" and not t.any() for t in cache.values())
    for p in range(n):
        want, mut = apply(jcache, jnp.asarray(toks[:, p:p + 1]), jnp.asarray(p))
        jcache = mut["cache"]
        got, out = twin(torch.from_numpy(toks[:, p:p + 1]), train=False, pos_offset=p,
                        cache=cache)
        assert out is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"position {p}")
        _assert_cache(cache, jcache, p)


def _jax_block_decode(jmod, params, x, total):
    cache = jmod.init(jax.random.PRNGKey(0), jnp.zeros((x.shape[0], total, x.shape[2])),
                      train=False)["cache"]
    apply = jax.jit(lambda c, xt: jmod.apply({"params": params, "cache": c}, xt, train=False,
                                             mutable=["cache"]))
    outs, caches = [], []
    for t in range(x.shape[1]):
        y, mut = apply(cache, jnp.asarray(x[:, t:t + 1]))
        cache = mut["cache"]
        outs.append(np.asarray(y))
        caches.append(cache)
    return outs, caches


@pytest.mark.parametrize("which", ["block", "encoder"])
@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_block_and_encoder_decode_like_flax(which, attention):
    d, heads, total = 32, 4, 12
    x = np.random.default_rng(3).normal(size=(2, 6, d)).astype(np.float32)
    if which == "block":
        kw = dict(d_model=d, num_heads=heads, d_ff=64, dropout=0.0, dtype=jnp.float32,
                  attention=attention)
        train_mod = JaxBlock(**kw)
        jmod = JaxBlock(**kw, decode=True)
        tmod = EncoderBlock(d, heads, 64, 0.0, torch.float32, None, True, attention,
                            device="cpu")
    else:
        kw = dict(num_layers=2, d_model=d, num_heads=heads, d_ff=64, attention=attention)
        train_mod, jmod = JaxEncoder(**kw), JaxEncoder(**kw, decode=True)
        tmod = TransformerEncoder(**kw, decode=True, device="cpu")
    params = jax.jit(lambda: train_mod.init(jax.random.PRNGKey(4), jnp.asarray(x),
                                            train=False))()["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    load_flax_params(tmod, params)
    outs, caches = _jax_block_decode(jmod, params, x, total)
    cache = _sized_cache(tmod, 2, total)
    for t, (want, jcache) in enumerate(zip(outs, caches)):
        got, cache = tmod(torch.from_numpy(x[:, t:t + 1]), train=False, cache=cache)
        np.testing.assert_allclose(got.numpy(), want, atol=LEAF_ATOL, rtol=0,
                                   err_msg=f"position {t}")
        _assert_cache(cache, jcache, t)


@pytest.mark.parametrize("kind", ["lm", "moe"])
def test_prefill_cache_equals_jax(kind):
    jlm, params, tlm = _pair(kind, seed=6)
    prompt = _tokens(7, 3, 9)
    jcache, jlast = jax.jit(lambda p, t: jgen.prefill_cache(jlm, p, t, 20))(
        params, jnp.asarray(prompt))
    cache, last = prefill_cache(tlm, torch.from_numpy(prompt), 20)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL, rtol=0)
    _assert_cache(cache, jcache, "prefill")
    # The next tick from it: the twin and JAX's twin agree.
    nxt = _tokens(8, 3, 1)
    want, _ = jax.jit(lambda c, t: jgen._decode_twin(jlm).apply(
        {"params": params["params"], "cache": c}, t, train=False, pos_offset=9,
        mutable=["cache"]))(jcache, jnp.asarray(nxt))
    got, _ = _decode_twin(tlm)(torch.from_numpy(nxt), train=False, pos_offset=9, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_layer_index_orders_blocks_and_raises_jax_text():
    keys = ["encoder.block_10.attn.cached_key", "encoder.block_2.attn.cached_key",
            "encoder.block_0.attn.cache_index"]
    assert sorted(keys, key=layer_index) == [keys[2], keys[1], keys[0]]
    assert layer_index(("encoder", "block_7", "attn")) == 7
    entries = tuple(jax.tree_util.DictKey(k) for k in ("encoder", "block_3", "attn"))
    assert layer_index(entries) == jgen.layer_index(entries) == 3
    bad = ("encoder", "ln_out", "scale")
    with pytest.raises(ValueError) as want:
        jgen.layer_index(tuple(jax.tree_util.DictKey(k) for k in bad))
    for path in (bad, "encoder.ln_out.scale"):
        with pytest.raises(ValueError) as got:
            layer_index(path)
        assert str(got.value) == str(want.value)


def test_attention_fn_is_ignored_at_decode():
    """Built with ``decode=True`` and an ``attention_fn``, the LM decodes
    through the dense single-query attend, as JAX's does; the twin of a
    model with one drops it."""
    def boom(*args, **kwargs):
        raise AssertionError("attention_fn ran at decode")

    _, params, tlm = _pair(seed=9)
    with_fn = TransformerLM(**CFG, attention_fn=boom, decode=True, device="cpu")
    load_flax_params(with_fn, params)
    plain = _decode_twin(tlm)
    toks = _tokens(10, 2, 4)
    ca, cb = _sized_cache(plain, 2, 8), _sized_cache(plain, 2, 8)
    for p in range(4):
        a, ca = plain(torch.from_numpy(toks[:, p:p + 1]), train=False, pos_offset=p, cache=ca)
        b, cb = with_fn(torch.from_numpy(toks[:, p:p + 1]), train=False, pos_offset=p,
                        cache=cb)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fn_model = TransformerLM(**CFG, attention_fn=boom, dropout=0.1, device="cpu")
    twin = _decode_twin(fn_model)
    assert twin.attention_fn is None and twin.dropout == 0.0 and twin.decode
    assert fn_model.attention_fn is boom and not fn_model.decode
    assert all(b.attention_fn is None and b.mode == "naive" and b.attn.dropout_rate == 0.0
               for b in twin.encoder.children() if isinstance(b, EncoderBlock))


def test_twin_shares_the_models_storage_and_refuses_training_paths():
    _, _, tlm = _pair(seed=11)
    twin = _decode_twin(tlm)
    assert type(twin) is TransformerLM and twin is not tlm
    own = dict(tlm.named_parameters())
    for name, p in twin.named_parameters():
        assert p is own[name]
    with torch.no_grad():
        tlm.encoder.block_0.ff1.kernel.add_(1.0)
    assert torch.equal(twin.encoder.block_0.ff1.kernel, tlm.encoder.block_0.ff1.kernel)
    cache = _sized_cache(twin, 1, 4)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="decode=True is inference"):
        twin(tok, targets=tok, cache=cache)
    with pytest.raises(ValueError, match="Autoregressive cache shape error"):
        twin(torch.zeros((1, 2), dtype=torch.long), train=False, cache=cache)
    with pytest.raises(ValueError, match="decode=True"):
        tlm(tok, cache=cache)
    (h, table), _ = twin(tok, train=False, hidden=True, cache=cache)
    assert h.shape == (1, 1, CFG["d_model"]) and table is tlm.embed.embedding
    assert int(cache["encoder.block_1.attn.cache_index"]) == 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flax_cache_round_trip(dtype):
    jdt, tdt = DTYPES[dtype]
    jlm = JaxLM(**CFG, dtype=jdt)
    jtwin = jgen._decode_twin(jlm)
    rng = np.random.default_rng(12)
    tree = jax.tree_util.tree_map(
        lambda s: np.asarray(jnp.asarray(rng.normal(size=s.shape), s.dtype))
        if s.ndim else np.asarray(5, np.int32), jgen.cache_template(jtwin, 2, 8))
    twin = _decode_twin(TransformerLM(**CFG, dtype=tdt, device="cpu"))
    cache = load_flax_cache(twin, {"cache": tree})
    assert {k: (v.dtype, tuple(v.shape)) for k, v in cache.items()} == {
        k: (v.dtype, tuple(v.shape)) for k, v in cache_template(twin, 2, 8).items()}
    back = _flat(to_flax_cache(cache))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], np.asarray(v, back[k].dtype))
    with pytest.raises(ValueError, match="cache trees differ"):
        load_flax_cache(twin, {"encoder": {"block_0": tree["encoder"]["block_0"]}})
