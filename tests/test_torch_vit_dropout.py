"""ViT's dropouts and ``flash_attention_fn(dropout_impl="dense")`` in the
port, held to flax's law on the CPU (flax's random stream cannot be
reproduced outside JAX, so the port draws its own masks):

- the embeddings' dropout (flax's ``nn.Dropout``): the keep fraction
  within a 5-sigma binomial bound of ``1 - rate``, every element drawn
  alone, kept values divided by ``keep_prob`` exactly, in flax's output
  too;
- the ViT trained with ``dropout=0.1``: the embeddings and every layer's
  dense attend drop, the same generator state draws the same logits and
  gradients, another seed other ones, and ``train=False`` equals a
  ``dropout=0.0`` model and the JAX ViT within the zoo tests' 1e-4;
- the dense fallback of ``flash_attention_fn``: flax's dense attend with
  causality folded into the mask; with ``broadcast_dropout`` (the default)
  one ``[sq, sk]`` mask shared by every batch row and head, else one per
  row and head; the keep fraction, the ``1 / keep_prob`` scaling and the
  same draws from the same generator; JAX's dense fallback shares its
  mask the same way.
"""

import importlib

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import ViT as JaxViT
from fluxmpi_tpu_torch.models import ViT, load_flax_params
from fluxmpi_tpu_torch.models import _layers
from fluxmpi_tpu_torch.models import vit as vit_module
from fluxmpi_tpu_torch.ops import flash_attention_fn

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")

torch.set_num_threads(1)

RATE = 0.1
VIT = dict(num_classes=5, patch=8, num_layers=2, d_model=32, num_heads=4, d_ff=64)


def _within_five_sigma(kept: int, n: int, p: float) -> bool:
    return abs(kept - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def test_embedding_dropout_keeps_flax_law():
    x = torch.ones(4, 17, 32)
    out = vit_module._dropout(x, RATE, torch.Generator().manual_seed(0))
    keep = out != 0
    assert _within_five_sigma(int(keep.sum()), keep.numel(), 1 - RATE)
    # Kept values are x / keep_prob, in x's dtype; every element drawn alone.
    scale = torch.tensor(1.0) / torch.tensor(1 - RATE)
    assert torch.equal(out[keep], scale.expand(int(keep.sum())))
    assert not bool((keep == keep[:1]).all()) and not bool((keep == keep[:, :1]).all())
    again = vit_module._dropout(x, RATE, torch.Generator().manual_seed(0))
    assert torch.equal(again, out)
    other = vit_module._dropout(x, RATE, torch.Generator().manual_seed(1))
    assert not torch.equal(other, out)
    flax_out = np.asarray(fnn.Dropout(RATE, deterministic=False).apply(
        {}, jnp.ones((4, 17, 32)), rngs={"dropout": jax.random.PRNGKey(0)}))
    fkeep = flax_out != 0
    assert _within_five_sigma(int(fkeep.sum()), fkeep.size, 1 - RATE)
    np.testing.assert_allclose(flax_out[fkeep], 1 / (1 - RATE), rtol=1e-6)


def _pair():
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32)
    jm = JaxViT(**VIT, dropout=RATE)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x, train=False))
    tm = ViT(**VIT, dropout=RATE, image_size=16, device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm, x


def test_vit_eval_equals_jax_and_the_dropout_free_model():
    jm, params, tm, x = _pair()
    plain = ViT(**VIT, image_size=16, device="cpu")
    load_flax_params(plain, params)
    got = tm(torch.from_numpy(x), train=False)
    assert torch.equal(got, plain(torch.from_numpy(x), train=False))
    want = np.asarray(jm.apply(params, x, train=False))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


def test_vit_training_drops_the_embeddings_and_every_dense_attend(monkeypatch):
    _, _, tm, x = _pair()
    shapes = []
    keep_fn = _layers.dense_dropout_keep

    def recording(seed, q_pos, k_pos, keep_prob, bh=0):
        shapes.append((len(q_pos), len(k_pos), keep_prob))
        return keep_fn(seed, q_pos, k_pos, keep_prob, bh)

    monkeypatch.setattr(_layers, "dense_dropout_keep", recording)
    tokens = (16 // VIT["patch"]) ** 2 + 1
    runs = []
    for seed in (3, 3, 4):
        out = tm(torch.from_numpy(x), dropout_rng=torch.Generator().manual_seed(seed))
        grads = torch.autograd.grad(out.sum(), list(tm.parameters()))
        runs.append((out, grads))
    assert shapes == [(tokens, tokens, 1 - RATE)] * VIT["num_layers"] * 3
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert not torch.equal(runs[0][0], runs[2][0])
    assert all(bool(torch.isfinite(g).all()) for g in runs[0][1])
    assert not torch.equal(runs[0][0], tm(torch.from_numpy(x), train=False))


def _weights(fn, b=3, s=48, h=4, d=8, seed=0):
    """The attention weights ``fn`` applies: with V = identity the output
    is the (dropped) weight matrix, ``[b, h, sq, sk]``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    eye = np.ascontiguousarray(np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None],
                                               (b, s, h, s)))
    return np.transpose(np.asarray(fn(q, k, eye)), (0, 2, 1, 3))


def _port(seed, **kw):
    def fn(q, k, v):
        return flash_attention_fn(causal=True)(
            *map(torch.from_numpy, (q, k, v)), dropout_rate=RATE, deterministic=False,
            dropout_rng=torch.Generator().manual_seed(seed), **kw)
    return fn


def test_dense_fallback_of_flash_attention_fn_keeps_flax_law():
    dropped = _weights(_port(0))
    live = np.tril(np.ones(dropped.shape[-2:], bool))
    plain = _weights(lambda q, k, v: _layers.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(live), dtype=torch.float32))
    keep = dropped != 0
    # One [sq, sk] mask for every batch row and head; causal pairs only.
    assert (keep == keep[:1, :1]).all() and not keep[0, 0][~live].any()
    n = int(live.sum())
    assert _within_five_sigma(int(keep[0, 0].sum()), n, 1 - RATE)
    # The kept weights are the dense softmax's divided by keep_prob.
    np.testing.assert_allclose(dropped[keep], plain[keep] / (1 - RATE), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_weights(_port(0)), dropped)
    assert not np.array_equal(_weights(_port(1)), dropped)
    # broadcast_dropout=False: one mask per batch row and head.
    per_row = _weights(_port(0, broadcast_dropout=False)) != 0
    assert not (per_row == per_row[:1, :1]).all()
    assert _within_five_sigma(int(per_row[..., live].sum()), per_row[..., live].size, 1 - RATE)
    # JAX's dense fallback (flax's attend) shares its mask the same way.
    jw = _weights(lambda q, k, v: jfa.flash_attention_fn(causal=True)(
        *map(jnp.asarray, (q, k, v)), dropout_rate=RATE, deterministic=False,
        dropout_rng=jax.random.PRNGKey(0)))
    jkeep = jw != 0
    assert (jkeep == jkeep[:1, :1]).all()
    assert _within_five_sigma(int(jkeep[0, 0].sum()), n, 1 - RATE)


def test_dense_fallback_needs_a_generator():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="dropout_rng"):
        flash_attention_fn()(q, q, q, dropout_rate=RATE, deterministic=False)
