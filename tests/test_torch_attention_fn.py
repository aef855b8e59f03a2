"""The port's ``flash_attention_fn`` against the JAX package's on the CPU:
the same numpy q/k/v and flax boolean masks through both (JAX's kernels in
Pallas interpret mode, the port's plain versions), for trailing padding,
contiguous packed documents, causal with padding and causal with packing:
the same recovered segment ids (exactly), outputs within atol 1e-5 and
q/k/v gradients within atol 1e-5 (f32 sums in other orders; values and
gradients are O(1)); unrepresentable masks raise the same ``ValueError``;
``bias`` raises; dense dropout (JAX's flax fallback) is the dense
attend with the generator's draw, kernel dropout equals
``flash_attention`` with the drawn seed; while a
CUDA graph is captured (simulated here) an unrepresentable mask
NaN-poisons its rows instead of raising and kernel dropout is refused; and
``TransformerLM(attention_fn=flash_attention_fn(causal=True))`` against
the JAX LM built the same way (logits and every gradient, atol 1e-4 and
``max|diff| / max|g| <= 1e-4`` per leaf; the key biases, whose gradient
is zero in exact arithmetic, against the largest gradient).
"""

import importlib
import re

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params, to_flax_params
from fluxmpi_tpu_torch.models._layers import dot_product_attention
from fluxmpi_tpu_torch.ops import flash_attention as port_flash
from fluxmpi_tpu_torch.ops import flash_attention_fn

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

B, S, H, D = 3, 16, 2, 8
ATOL = 1e-5


def _qkv(seed=0, b=B, s=S, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _padding(lengths, s=S):
    valid = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return np.asarray(fnn.make_attention_mask(valid, valid, dtype=jnp.bool_))


def _packed(docs, s=S):
    """Contiguous documents per row (``docs``: lengths per row; the rest
    is padding, segment 0)."""
    seg = np.zeros((len(docs), s), np.int32)
    for r, lens in enumerate(docs):
        start = 0
        for i, n in enumerate(lens):
            seg[r, start:start + n] = i + 1
            start += n
    same = np.asarray(fnn.make_attention_mask(seg, seg, jnp.equal, dtype=jnp.bool_))
    live = np.asarray(fnn.make_attention_mask(seg > 0, seg > 0, dtype=jnp.bool_))
    return same & live


def _causal(mask):
    causal = fnn.make_causal_mask(np.zeros(mask.shape[::3]), dtype=jnp.bool_)
    return np.asarray(fnn.combine_masks(mask, causal, dtype=jnp.bool_))


MASKS = {
    "padding": (lambda: _padding([16, 11, 5]), False),
    "packed": (lambda: _packed([[5, 7, 4], [16], [3, 3, 6]]), False),
    "causal_padding": (lambda: _causal(_padding([16, 9, 2])), True),
    "causal_packed": (lambda: _causal(_packed([[4, 12], [6, 6, 2], [16]])), True),
}


@pytest.mark.parametrize("kind", sorted(MASKS))
def test_segment_ids_equal_jax(kind):
    make, causal = MASKS[kind]
    mask = make()
    want = jfa._segments_from_attention_mask(jnp.asarray(mask), B, S, S, causal)
    got = tfa._segments_from_attention_mask(torch.from_numpy(mask), B, S, S, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(tfa._mask_fidelity(torch.from_numpy(mask), *got, causal).all())


@pytest.mark.parametrize("kind", sorted(MASKS))
def test_output_and_gradients_match_jax(kind):
    make, causal = MASKS[kind]
    mask = make()
    q, k, v = _qkv(1)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    jfn = jfa.flash_attention_fn(causal=causal)

    def jloss(q, k, v):
        return jnp.sum(jfn(q, k, v, mask=jnp.asarray(mask)) * g)

    want_out = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=jnp.asarray(mask)))
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_fn(causal=causal)(tq, tk, tv, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=0)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=name)


def _unrepresentable():
    sparse = np.ones((B, 1, S, S), bool)
    sparse[1, 0, 3, 7] = False            # one hole: not a segment pattern
    heads = np.ones((B, H, S, S), bool)
    heads[2, 1, :, 12:] = False           # padding on one head only
    causal = np.asarray(fnn.make_causal_mask(np.zeros((B, S)), dtype=jnp.bool_))
    return {"sparse": (sparse, False), "head_varying": (heads, False),
            "causal_without_flag": (causal, False)}


@pytest.mark.parametrize("kind", ["sparse", "head_varying", "causal_without_flag"])
def test_unrepresentable_mask_raises_as_jax(kind):
    mask, causal = _unrepresentable()[kind]
    q, k, v = _qkv(3)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention_fn(causal=causal)(*map(jnp.asarray, (q, k, v)),
                                               mask=jnp.asarray(mask))
    with pytest.raises(ValueError) as terr:
        flash_attention_fn(causal=causal)(*map(torch.from_numpy, (q, k, v)),
                                          mask=torch.from_numpy(mask))
    assert str(terr.value) == str(jerr.value)
    assert re.search(r"batch rows \[", str(terr.value))


def test_bias_raises():
    q, k, v = map(torch.from_numpy, _qkv(4))
    with pytest.raises(ValueError, match="bias"):
        flash_attention_fn()(q, k, v, bias=torch.zeros(B, H, S, S))
    with pytest.raises(ValueError, match="bias"):
        jfa.flash_attention_fn()(*map(jnp.asarray, _qkv(4)), bias=jnp.zeros((B, H, S, S)))


def test_dense_dropout_is_refused_and_kernel_dropout_uses_the_drawn_seed():
    """``dropout_impl="dense"`` (the default) runs the dense attend in f32
    with the same generator's draw (its law against flax's:
    ``tests/test_torch_vit_dropout.py``); ``"kernel"`` drops in the kernels
    with the drawn seed."""
    q, k, v = map(torch.from_numpy, _qkv(5))
    drop = dict(dropout_rate=0.25, deterministic=False)
    dense = flash_attention_fn(causal=True)(
        q, k, v, dropout_rng=torch.Generator().manual_seed(0), **drop)
    mask = torch.ones(S, S, dtype=torch.bool).tril()[None, None]
    want = dot_product_attention(q, k, v, mask=mask, dtype=torch.float32,
                                 dropout_rng=torch.Generator().manual_seed(0), **drop)
    assert torch.equal(dense, want.to(q.dtype))
    assert not torch.equal(dense, dot_product_attention(q, k, v, mask=mask).to(q.dtype))
    with pytest.raises(ValueError, match="dropout_rng"):
        flash_attention_fn(dropout_impl="kernel")(q, k, v, **drop)
    with pytest.raises(ValueError, match="dropout_impl"):
        flash_attention_fn(dropout_impl="other")
    # deterministic (flax's eval) or rate 0: no dropout, no draw.
    plain = port_flash(q, k, v)
    assert torch.equal(flash_attention_fn()(q, k, v, dropout_rate=0.25), plain)
    got = flash_attention_fn(dropout_impl="kernel")(
        q, k, v, dropout_rng=torch.Generator().manual_seed(7), **drop)
    seed = tfa._draw_dropout_seed(torch.Generator().manual_seed(7))
    want = port_flash(q, k, v, dropout_rate=0.25, dropout_seed=seed)
    assert torch.equal(got, want) and not torch.equal(got, plain)


def test_under_capture_unrepresentable_masks_poison_their_rows(monkeypatch):
    """While a CUDA graph is being captured no device value may be read on
    the host: the fidelity check then NaN-poisons the batch rows whose
    mask the segment ids do not rebuild (the JAX package's traced-mask
    rule), keeps the others, and kernel dropout draws its seed on the
    generator's device with no host read, as outside a capture."""
    monkeypatch.setattr(tfa, "_capturing", lambda device: True)
    mask, _ = _unrepresentable()["sparse"]
    mask = mask & _padding([16, 16, 10])
    q, k, v = map(torch.from_numpy, _qkv(6))
    out = flash_attention_fn()(q, k, v, mask=torch.from_numpy(mask))
    assert torch.isnan(out[1]).all() and not torch.isnan(out[[0, 2]]).any()
    good = np.ones_like(mask)
    good[:] = _padding([16, 16, 10])
    ref = flash_attention_fn()(q, k, v, mask=torch.from_numpy(good))
    torch.testing.assert_close(out[[0, 2]], ref[[0, 2]], rtol=0, atol=0)
    unchecked = flash_attention_fn(mask_check=False)(q, k, v, mask=torch.from_numpy(mask))
    assert not torch.isnan(unchecked).any()
    monkeypatch.setattr(torch.Tensor, "item", _no_host_read)
    got = flash_attention_fn(dropout_impl="kernel")(
        q, k, v, dropout_rate=0.1, deterministic=False,
        dropout_rng=torch.Generator().manual_seed(0))
    monkeypatch.undo()
    seed = tfa._draw_dropout_seed(torch.Generator().manual_seed(0))
    assert torch.equal(got, port_flash(q, k, v, dropout_rate=0.1, dropout_seed=seed))


def _no_host_read(self):
    raise AssertionError("a device value was read on the host")


def test_fidelity_check_runs_in_query_chunks():
    """A sequence longer than one chunk of query rows: the check compares
    every chunk (a hole in the second chunk is found)."""
    s = tfa._FIDELITY_CHUNK + 40
    valid = np.arange(s)[None, :] < np.array([[s], [s - 100]])
    mask = torch.from_numpy(np.array(fnn.make_attention_mask(valid, valid,
                                                             dtype=jnp.bool_)))
    seg = tfa._segments_from_attention_mask(mask, 2, s, s, False)
    assert bool(tfa._mask_fidelity(mask, *seg, False).all())
    mask[0, 0, s - 3, 5] = False
    assert tfa._mask_fidelity(mask, *seg, False).tolist() == [False, True]


def test_integer_masks_read_as_flax_reads_them():
    mask = _padding([16, 11, 5]).astype(np.int32) * 3
    q, k, v = map(torch.from_numpy, _qkv(8))
    got = flash_attention_fn()(q, k, v, mask=torch.from_numpy(mask))
    want = flash_attention_fn()(q, k, v, mask=torch.from_numpy(mask > 0))
    assert torch.equal(got, want)


LM_CFG = dict(vocab_size=61, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)


def test_lm_with_flash_attention_fn_matches_jax():
    """``TransformerLM(attention_fn=flash_attention_fn(causal=True))``: the
    training forward reaches the function with flax's causal mask (its
    segment ids all 1), in JAX as in the port."""
    jlm = JaxLM(**LM_CFG, attention_fn=jfa.flash_attention_fn(causal=True))
    toks = np.random.default_rng(9).integers(0, LM_CFG["vocab_size"], (2, 20)).astype(np.int32)
    params = jax.jit(lambda t: jlm.init(jax.random.PRNGKey(0), t, train=False))(
        jnp.asarray(toks))
    params = jax.tree_util.tree_map(np.asarray, params)
    tlm = TransformerLM(**LM_CFG, attention_fn=flash_attention_fn(causal=True), device="cpu")
    load_flax_params(tlm, params)
    calls = []
    inner = tlm.encoder.block_0.attention_fn

    def spy(query, key, value, bias=None, mask=None, **kwargs):
        calls.append((mask is not None, sorted(kwargs)))
        return inner(query, key, value, bias=bias, mask=mask, **kwargs)

    tlm.encoder.block_0.attention_fn = spy

    w = np.random.default_rng(10).normal(size=(2, 20, LM_CFG["vocab_size"])).astype(np.float32)

    def jloss(p):
        return jnp.sum(jlm.apply(p, jnp.asarray(toks), train=True) * w)

    want_logits = np.asarray(jlm.apply(params, jnp.asarray(toks), train=True))
    want_grads = jax.grad(jloss)(params)
    logits = tlm(torch.from_numpy(toks))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-4, rtol=0)
    assert calls == [(True, [])]  # flax's keyword filter: **kwargs gets the mask alone
    names = [n for n, _ in tlm.named_parameters()]
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                [p for _, p in tlm.named_parameters()])
    want = _flat(want_grads["params"])
    got = to_flax_params(dict(zip(names, grads)))
    assert set(got) == set(want)
    top = max(np.abs(a).max() for a in want.values())
    for k in want:
        # A key bias's gradient is zero in exact arithmetic (it shifts a
        # query row's scores alike): both sides hold rounding only.
        scale = top if k.endswith("key/bias") else np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k
    with pytest.raises(ValueError, match="conflicts"):
        TransformerLM(**LM_CFG, attention="flash", attention_fn=flash_attention_fn(True),
                      device="cpu")


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
