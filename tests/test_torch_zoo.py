"""The port's standalone encoder, ViT, DDPM UNet, DDPM/DDIM and EMA
against the JAX package's, on the CPU, from the same numpy inputs and
weights (carried across by ``load_flax_params``), in f32; JAX's flash
kernels run in Pallas interpret mode, the port's plain versions.

Tolerances (f32 both sides, sums in other orders): outputs atol 1e-5
(encoder, blocks), 1e-4 (ViT logits, UNet output); every gradient leaf
``max|diff| <= 1e-4 * max|g|`` (the attention key biases, zero in exact
arithmetic, against the largest gradient); GroupNorm alone atol 5e-5
(its test says why); schedules and embeddings atol
1e-6 (``cos``/``exp`` of the same f32 arguments); the EMA in bf16 params
atol 1e-6 of its f32 accumulator. The UNet runs at ``bench.py``'s
``_bench_unet`` CPU configuration (side 8, base 8, mults (1, 2), attention
at 4, groups 4) and, like the blocks, at weights moved off their init by
0.1·N(0, 1), so that the zero-initialised ``conv2``, attention ``out`` and
``conv_out`` kernels pass gradients (asserted nonzero at the attention).
``ddpm_loss`` (loss atol 1e-5, gradients as above) and ``ddim_sample``
take JAX's random draws (their draw helpers patched); the sampler is held
to atol 1e-5 where the model predicts 0 and to the conditioning its test
derives elsewhere. One ViT ``make_train_step`` update in a 2-rank gloo
world equals the JAX step on 2 of its CPU devices (loss atol 1e-5,
gradients as above, read off an sgd update).
"""

import importlib
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from fluxmpi_tpu.models import TransformerEncoder as JaxEncoder
from fluxmpi_tpu.models import UNet as JaxUNet
from fluxmpi_tpu.models import ViT as JaxViT
from fluxmpi_tpu.models import cosine_beta_schedule as jax_cosine
from fluxmpi_tpu.models import ddim_sample as jax_ddim
from fluxmpi_tpu.models import ddpm_loss as jax_ddpm_loss
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel.train import replicate, shard_batch
from fluxmpi_tpu.utils import ema_init as jax_ema_init
from fluxmpi_tpu.utils import ema_params as jax_ema_params
from fluxmpi_tpu.utils import ema_update as jax_ema_update
from fluxmpi_tpu_torch.models import (TransformerEncoder, UNet, ViT, cosine_beta_schedule,
                                      ddim_sample, ddpm_loss, load_flax_params,
                                      to_flax_params)
from fluxmpi_tpu_torch.models._layers import GroupNorm, _Init
from fluxmpi_tpu_torch.ops import flash_attention_fn
from fluxmpi_tpu_torch.utils import ema_init, ema_params, ema_update

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
junet = importlib.import_module("fluxmpi_tpu.models.unet")
tunet = importlib.import_module("fluxmpi_tpu_torch.models.unet")

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

GRAD_RTOL = 1e-4


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, a in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


def _shared_params(tm, seed):
    """The port module's parameters moved off their init by 0.1·N(0, 1)
    (so that zero-initialised kernels pass gradients), copied into it by
    ``load_flax_params`` and returned as the flax tree ``{"params": ...}``
    for the JAX module (its parameter tree has the same paths)."""
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in to_flax_params(tm).items()}
    params = {"params": _nest(flat)}
    load_flax_params(tm, params)
    return params


def _jax_out_and_grads(apply, params, w, *args):
    """JAX's output of ``apply(params, *args)`` and the gradients of
    ``sum(out * w)``, jitted as one program (``args`` traced: a mask
    passed here reaches ``flash_attention_fn`` as a traced mask)."""
    def f(p, *a):
        out = apply(p, *a)
        return jnp.sum(out * w), out

    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params, *args)
    return np.asarray(out), _flat(g["params"])


def _assert_grads(got: dict, want: dict):
    """Per leaf ``max|diff| <= GRAD_RTOL * max|g|``; key biases against the
    largest gradient."""
    assert set(got) == set(want)
    top = max(np.abs(a).max() for a in want.values())
    for k, w in want.items():
        scale = top if k.endswith("key/bias") else np.abs(w).max()
        err = np.abs(got[k] - w).max()
        assert err <= GRAD_RTOL * scale + 1e-12, (k, err, scale)


def _port_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return to_flax_params(dict(zip(names, grads)))


# ---- the standalone encoder ----

ENC = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64)


def _encoder_mask(kind, b, s):
    if kind is None:
        return None
    lengths = np.array([s, s - 5])[:b]
    valid = np.arange(s)[None] < lengths[:, None]
    return np.asarray(fnn.make_attention_mask(valid, valid, dtype=jnp.bool_))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", [None, "padding"])
@pytest.mark.parametrize("attention", ["naive", "flash", "attention_fn"])
def test_encoder_matches_jax(attention, mask, causal):
    """Output and every gradient; ``attention_causal`` folds causality into
    the flash kernels only (the dense attend follows the mask), in JAX as in
    the port."""
    b, s = 2, 12
    kw = dict(ENC, attention_causal=causal)
    if attention == "attention_fn":
        jm = JaxEncoder(**kw, attention_fn=jfa.flash_attention_fn())
        tm_kw = dict(attention_fn=flash_attention_fn())
    else:
        jm = JaxEncoder(**kw, attention=attention)
        tm_kw = dict(attention=attention)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, s, ENC["d_model"])).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    m = _encoder_mask(mask, b, s)
    jmask = None if m is None else jnp.asarray(m)
    tm = TransformerEncoder(**kw, **tm_kw, device="cpu")
    params = _shared_params(tm, 1)
    want, want_g = _jax_out_and_grads(
        lambda p, x, m: jm.apply(p, x, train=True, mask=m), params, w, x, jmask)
    out = tm(torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m.copy()))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=0)
    _assert_grads(_port_grads(tm, (out * torch.from_numpy(w)).sum()), want_g)


def test_encoder_refuses_flash_beside_attention_fn_and_decode():
    """``attention="flash"`` beside an ``attention_fn`` raises; ``decode=True``
    (refused until the decode twin was ported) builds an encoder that
    decodes one position through flax's cache and bypasses its
    ``attention_fn``, as JAX's does."""
    from fluxmpi_tpu_torch.models.generate import _sized_cache

    with pytest.raises(ValueError, match="conflicts"):
        TransformerEncoder(**ENC, attention="flash", attention_fn=flash_attention_fn(),
                           device="cpu")
    enc = TransformerEncoder(**ENC, decode=True, attention_fn=flash_attention_fn(),
                             device="cpu")
    plain = TransformerEncoder(**ENC, decode=True, device="cpu")
    x = torch.randn((2, 1, ENC["d_model"]), generator=torch.Generator().manual_seed(0))
    got, cache = enc(x, train=False, cache=_sized_cache(enc, 2, 4))
    want, _ = plain(x, train=False, cache=_sized_cache(plain, 2, 4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(cache["block_0.attn.cache_index"]) == 1


# ---- ViT ----

VIT = dict(num_classes=5, patch=8, num_layers=2, d_model=32, num_heads=4, d_ff=64)


@pytest.mark.parametrize("flash", [False, True])
def test_vit_logits_and_every_gradient_match_jax(flash):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 24, 24, 3)).astype(np.float32)
    w = rng.normal(size=(3, VIT["num_classes"])).astype(np.float32)
    jm = JaxViT(**VIT, attention_fn=jfa.flash_attention_fn() if flash else None)
    tm = ViT(**VIT, attention_fn=flash_attention_fn() if flash else None, image_size=24,
             device="cpu")
    params = _shared_params(tm, 4)  # a live CLS token
    want, want_g = _jax_out_and_grads(lambda p, x: jm.apply(p, x, train=True), params, w, x)
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (3, VIT["num_classes"])
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4, rtol=0)
    _assert_grads(_port_grads(tm, (logits * torch.from_numpy(w)).sum()), want_g)


def test_vit_refuses_wrong_images_and_dropout():
    """Wrong image sizes are refused; training with dropout needs a
    dropout generator, as flax needs a "dropout" rng, and then drops (its
    law: ``tests/test_torch_vit_dropout.py``)."""
    tm = ViT(**VIT, image_size=24, device="cpu")
    with pytest.raises(ValueError, match="built for 24x24"):
        tm(torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="must divide"):
        ViT(**VIT, image_size=20, device="cpu")
    drop = ViT(**dict(VIT, dropout=0.1), image_size=24, device="cpu")
    x = torch.ones(1, 24, 24, 3)
    with pytest.raises(ValueError, match="dropout_rng"):
        drop(x)
    eval_out = drop(x, train=False)
    trained = drop(x, dropout_rng=torch.Generator().manual_seed(0))
    assert trained.shape == eval_out.shape and not torch.equal(trained, eval_out)


# ---- GroupNorm, the UNet's parts, the schedule ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4, 12])
def test_group_norm_matches_flax(groups, dtype):
    """Groups are contiguous channel runs (flax groups NHWC's last axis),
    also on a ``channels_last`` NCHW view; statistics and output in f32.
    The inputs sit around 3, so the fast variance ``E[x^2] - E[x]^2``
    cancels ~10 against ~9 and each side's sum order moves it by up to
    ~1e-6 relative of 10: outputs (|y| < 5) agree within atol 5e-5."""
    rng = np.random.default_rng(5)
    x = (3.0 + rng.normal(size=(2, 5, 6, 12))).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    scale, bias = rng.normal(size=12).astype(np.float32), rng.normal(size=12).astype(np.float32)
    gn = fnn.GroupNorm(groups, dtype=jnp.float32)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}}, jx))
    port = GroupNorm(groups, 12, init=_Init("cpu", torch.Generator()))
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(dtype)
    got = port(tx.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW view
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want,
                               atol=5e-5, rtol=0)
    if groups not in (1, 12):
        # torch.nn's GroupNorm over the same NCHW tensor groups the same
        # channel runs: the layout question is only the view's.
        ref = F.group_norm(tx.permute(0, 3, 1, 2).float(), groups, port.scale, port.bias,
                           1e-6)
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)


@pytest.mark.parametrize("dim", [8, 9])
def test_timestep_embedding_and_schedule_match_jax(dim):
    t = np.array([0, 1, 17, 500, 999], np.int32)
    np.testing.assert_allclose(
        tunet.timestep_embedding(torch.from_numpy(t), dim).numpy(),
        np.asarray(junet.timestep_embedding(jnp.asarray(t), dim)), atol=1e-6, rtol=0)
    for T in (10, 1000):
        np.testing.assert_allclose(cosine_beta_schedule(T, device="cpu").numpy(),
                                   np.asarray(jax_cosine(T)), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tunet._alpha_bars(cosine_beta_schedule(T, device="cpu")),
                                   np.asarray(junet._alpha_bars(jax_cosine(T))),
                                   atol=1e-6, rtol=0)


def _block_pair(kind, flash):
    c = 8
    if kind == "res":
        jm = junet.ResBlock(16, 4, jnp.float32)
        tm = tunet.ResBlock(c, 16, 4, torch.float32, temb_features=12,
                            init=_Init("cpu", torch.Generator().manual_seed(0)))
        args = (np.random.default_rng(6).normal(size=(2, 4, 4, c)).astype(np.float32),
                np.random.default_rng(7).normal(size=(2, 12)).astype(np.float32))
    else:
        jm = junet.AttnBlock(4, 4, jnp.float32, jfa.flash_attention_fn() if flash else None)
        tm = tunet.AttnBlock(16, 4, 4, torch.float32, flash_attention_fn() if flash else None,
                             init=_Init("cpu", torch.Generator().manual_seed(0)))
        args = (np.random.default_rng(6).normal(size=(2, 4, 4, 16)).astype(np.float32),)
    return jm, tm, args


@pytest.mark.parametrize("kind,flash", [("res", False), ("attn", False), ("attn", True)])
def test_unet_blocks_match_jax(kind, flash):
    jm, tm, args = _block_pair(kind, flash)
    params = _shared_params(tm, 9)
    c_out = 16
    out_w = np.random.default_rng(10).normal(size=(2, 4, 4, c_out)).astype(np.float32)
    want, want_g = _jax_out_and_grads(jm.apply, params, out_w, *args)
    targs = [torch.from_numpy(args[0]).permute(0, 3, 1, 2)] + \
        [torch.from_numpy(a) for a in args[1:]]
    out = tm(*targs).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=0)
    _assert_grads(_port_grads(tm, (out * torch.from_numpy(out_w)).sum()), want_g)


# ---- the whole UNet at _bench_unet's CPU configuration ----

UNET = dict(out_channels=3, base_channels=8, channel_mults=(1, 2), blocks_per_stage=2,
            attn_resolutions=(4,), groups=4)


@pytest.fixture(scope="module")
def unet_params():
    return _shared_params(UNet(**UNET, image_size=8, device="cpu"), 12)


@pytest.mark.parametrize("flash", [False, True])
def test_unet_output_and_every_gradient_match_jax(unet_params, flash):
    jm = JaxUNet(**UNET, attention_fn=jfa.flash_attention_fn() if flash else None)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 870], np.int32)
    w = rng.normal(size=x.shape).astype(np.float32)
    want, want_g = _jax_out_and_grads(jm.apply, unet_params, w, x, t)
    tm = UNet(**UNET, attention_fn=flash_attention_fn() if flash else None, image_size=8,
              device="cpu")
    load_flax_params(tm, unet_params)
    out = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4, rtol=0)
    got_g = _port_grads(tm, (out * torch.from_numpy(w)).sum())
    _assert_grads(got_g, want_g)
    attn = [k for k in got_g if "/attn/" in k and k.endswith("kernel")]
    assert len(attn) == 4 * 6 and all(np.abs(got_g[k]).max() > 0 for k in attn)


def test_unet_structure_and_zero_inits():
    """The attention blocks sit where JAX puts them (two down, the middle,
    three up at side 4), the concatenations pop the skips in reverse, and
    the seeded model predicts 0."""
    tm = UNet(**UNET, image_size=8, device="cpu")
    names = {n for n, m in tm.named_modules() if isinstance(m, tunet.AttnBlock)}
    assert names == {"down1_attn0", "down1_attn1", "mid_attn", "up1_attn0", "up1_attn1",
                     "up1_attn2"}
    out = tm(torch.randn(2, 8, 8, 3), torch.tensor([1, 2]))
    assert torch.equal(out, torch.zeros_like(out))
    with pytest.raises(ValueError, match="built for 8x8"):
        tm(torch.zeros(1, 16, 16, 3), torch.tensor([0]))


# ---- DDPM and DDIM with JAX's draws ----

@pytest.mark.parametrize("pred_type", ["eps", "v"])
def test_ddpm_loss_matches_jax_with_its_draws(unet_params, pred_type, monkeypatch):
    jm = JaxUNet(**UNET)
    tm = UNet(**UNET, image_size=8, device="cpu")
    load_flax_params(tm, unet_params)
    batch = np.random.default_rng(14).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    betas = jax_cosine(1000)
    key = jax.random.PRNGKey(15)
    t_rng, eps_rng = jax.random.split(key)
    draws = (torch.from_numpy(np.asarray(jax.random.randint(t_rng, (2,), 0, 1000))).long(),
             torch.from_numpy(np.asarray(jax.random.normal(eps_rng, batch.shape, jnp.float32))))
    monkeypatch.setattr(tunet, "_ddpm_draws", lambda *a: draws)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_ddpm_loss(jm, p, jnp.asarray(batch), key, betas, pred_type=pred_type)))(
        unet_params)
    params = dict(tm.named_parameters())
    loss = ddpm_loss(tm, params, torch.from_numpy(batch), torch.Generator(),
                     cosine_beta_schedule(1000, device="cpu"), pred_type=pred_type)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    _assert_grads(_port_grads(tm, loss), _flat(want_g["params"]))


def test_ddpm_loss_draws_afresh_and_checks_its_generator():
    tm = UNet(**UNET, image_size=8, device="cpu")
    params = dict(tm.named_parameters())
    batch = torch.zeros(2, 8, 8, 3)
    betas = cosine_beta_schedule(100, device="cpu")
    gen = torch.Generator().manual_seed(0)
    t1, e1 = tunet._ddpm_draws(gen, 2, 100, batch.shape, batch.device)
    t2, e2 = tunet._ddpm_draws(gen, 2, 100, batch.shape, batch.device)
    assert not torch.equal(e1, e2) and t1.dtype == torch.int64
    assert 0 <= int(t1.min()) and int(t1.max()) < 100
    ddpm_loss(tm, params, batch, gen, betas)
    with pytest.raises(ValueError, match="pred_type"):
        ddpm_loss(tm, params, batch, gen, betas, pred_type="x0")
    with pytest.raises(ValueError, match="draws on"):
        tunet._check_generator(types.SimpleNamespace(device=torch.device("cuda", 0)),
                               batch.device)


@pytest.mark.parametrize("num_steps", [1, 20])
@pytest.mark.parametrize("weights", ["seeded", "perturbed"])
def test_ddim_sample_matches_jax_with_its_draws(unet_params, weights, num_steps,
                                                monkeypatch):
    """At the seeded weights the UNet predicts 0 exactly on both sides, so
    the sampler's own arithmetic is held to atol 1e-5. At the perturbed
    weights the first step divides the model's output by
    ``sqrt(alpha_bar[T-1])`` (4.9e-4 at T = 100) wherever the x0 estimate
    is not clipped, so the outputs' ~1e-6 difference may grow ~2000-fold:
    atol ``1e-6 / sqrt(alpha_bar[T-1])`` (2.0e-3)."""
    jm = JaxUNet(**UNET)
    tm = UNet(**UNET, image_size=8, device="cpu")
    params = unet_params
    if weights == "seeded":
        params = {"params": _nest(to_flax_params(tm))}
    load_flax_params(tm, params)
    betas = jax_cosine(100)
    key = jax.random.PRNGKey(16)
    _, x_rng = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(x_rng, (2, 8, 8, 3), jnp.float32))
    monkeypatch.setattr(tunet, "_ddim_noise", lambda *a: torch.from_numpy(x0.copy()))
    want = np.asarray(jax.jit(lambda p: jax_ddim(jm, p, key, shape=(2, 8, 8, 3), betas=betas,
                                                 num_steps=num_steps))(params))
    tbetas = cosine_beta_schedule(100, device="cpu")
    got = ddim_sample(tm, dict(tm.named_parameters()), torch.Generator(), shape=(2, 8, 8, 3),
                      betas=tbetas, num_steps=num_steps)
    atol = 1e-5 if weights == "seeded" else \
        1e-6 / float(tunet._alpha_bars(tbetas)[-1].sqrt())
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    assert np.isfinite(got.numpy()).all() and np.abs(got.numpy()).max() <= 1.0 + 1e-5
    for n in (1, 5, 20, 50, 100):
        ts_port = torch.linspace(99, 0, n, dtype=torch.float32).round().long().numpy()
        ts_jax = np.asarray(jnp.linspace(99, 0, n).round().astype(jnp.int32))
        np.testing.assert_array_equal(ts_port, ts_jax)
    with pytest.raises(ValueError, match="num_steps"):
        ddim_sample(tm, {}, torch.Generator(), shape=(1, 8, 8, 3), betas=tbetas, num_steps=0)


# ---- EMA ----

def test_ema_matches_jax_over_five_updates_with_bf16_params():
    rng = np.random.default_rng(17)
    shapes = {"a": (3, 4), "b": (5,)}
    seq = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
           for _ in range(5)]
    jstate = jax_ema_init({k: jnp.asarray(v, jnp.bfloat16) for k, v in seq[0].items()}, 0.9)
    tstate = ema_init({k: torch.from_numpy(v).bfloat16() for k, v in seq[0].items()}, 0.9)
    assert all(m.dtype == torch.float32 for m in tstate.mean.values())
    with pytest.raises(ValueError, match="before any"):
        ema_params(tstate)
    for p in seq:
        jstate = jax_ema_update(jstate, {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()})
        tstate = ema_update(tstate, {k: torch.from_numpy(v).bfloat16() for k, v in p.items()})
    assert int(tstate.count) == int(jstate.count) == 5
    want, got = jax_ema_params(jstate), ema_params(tstate)
    for k in shapes:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="decay"):
        ema_init({"a": torch.zeros(1)}, 1.0)


# ---- one ViT update in a 2-rank gloo world against JAX on 2 devices ----

VIT_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    torch.set_num_threads(1)
    rank, world, store, out, data = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import ViT, load_flax_params
    from fluxmpi_tpu_torch.ops import flash_attention_fn
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    fm.init(device="cpu")
    d = dict(np.load(data))
    model = ViT(num_classes=5, patch=8, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                attention_fn=flash_attention_fn(), image_size=24, device="cpu")
    load_flax_params(model, {k[len("params/"):]: v for k, v in d.items()
                             if k.startswith("params/")})
    share = len(d["x"]) // world
    x = torch.from_numpy(d["x"][rank * share:(rank + 1) * share])
    y = torch.from_numpy(d["y"][rank * share:(rank + 1) * share]).long()

    def loss_fn(params, ms, batch):
        return F.cross_entropy(model(batch[0]), batch[1]), ms

    opt = optim.sgd(float(d["lr"]))
    state, loss = make_train_step(loss_fn, opt)(TrainState.create(model, opt), (x, y))
    np.savez(out, loss=float(loss), **{k: v.detach().numpy() for k, v in
                                       model.named_parameters()})
    fm.shutdown()
    dist.destroy_process_group()
''')


def test_vit_train_step_in_a_two_rank_world_matches_jax(world, tmp_path):
    lr = 0.5
    rng = np.random.default_rng(18)
    x = rng.normal(size=(4, 24, 24, 3)).astype(np.float32)
    y = rng.integers(0, 5, 4).astype(np.int32)
    jm = JaxViT(**VIT, attention_fn=jfa.flash_attention_fn())
    params = _shared_params(ViT(**VIT, image_size=24, device="cpu"), 20)
    flat = _flat(params["params"])
    np.savez(tmp_path / "data.npz", x=x, y=y, lr=lr,
             **{f"params/{k}": v for k, v in flat.items()})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = []
    for r in range(2):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", VIT_WORKER, str(r), "2", str(tmp_path / "store"),
             str(tmp_path / f"rank{r}.npz"), str(tmp_path / "data.npz")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=240)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = "\n".join((tmp_path / f"rank{r}.log").read_text() for r in range(2))
    assert all(p.returncode == 0 for p, _ in procs), logs

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def loss_fn(p, ms, b):
        logits = jm.apply(p, b[0], train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean(), ms

    opt = optax.sgd(lr)
    step = jax_make_train_step(loss_fn, opt, mesh=mesh, donate=False)
    state = replicate(JaxTrainState.create(params, opt), mesh)
    state, loss = step(state, shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh))
    want_g = {k: (a - b) / lr for (k, a), b in zip(
        flat.items(), _flat(state.params["params"]).values())}
    for r in range(2):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(float(res["loss"]), float(loss), atol=1e-5, rtol=0)
        got_g = {k: (v - res[k.replace("/", ".")]) / lr for k, v in flat.items()}
        # sgd's (p - p') / lr carries the parameters' f32 rounding (|p| ~ 1
        # here, ulp 1.2e-7 / 0.5): held at 4e-7 absolute beside the rtol.
        top = max(np.abs(a).max() for a in want_g.values())
        for k, w in want_g.items():
            scale = top if k.endswith("key/bias") else np.abs(w).max()
            assert np.abs(got_g[k] - w).max() <= GRAD_RTOL * scale + 4e-7, k
