"""Random draws over the global batch at world > 1 (ROADMAP C.32).

The JAX package's default ``style="auto"`` step is one jitted program over
the global batch, so its random draws are the global batch's: a key draws
one value per global row whatever the device count. The tests hold the
JAX package to that (each function at one and at two CPU devices) and the
port to the same rule:

- the counter-based keep masks of ``dropout_keep_reference`` and
  ``dense_dropout_keep`` keyed by :func:`hash_rows` (a share's first row
  ``b0``, first head ``h0``, the whole batch's ``heads``) equal JAX's
  ``_dropout_keep`` over the whole batch's grid, bit for bit;
- the flash attention's plain versions with dropout on each half of a
  batch (split by rows, or by heads as a tensor-parallel worker holds
  them) against JAX's ``flash_attention(interpret=True)`` on the whole
  batch, outputs and gradients within 2e-5 in f32;
- ``flash_attention_fn(dropout_impl="kernel")`` under a batch share and a
  head block (``_batch_parallel.heads``) drops what the whole call drops;
- in 1- and 2-rank gloo worlds of ``tests/_torch_zoo_world_worker.py``
  (``draws``), two updates of a tiny DDPM UNet, a tiny MoE layer with
  router noise (default grouping, ``n_groups=3``, and behind a ring
  attention under ``sp=2``, where each rank holds a sequence block of
  every row) and a tiny ViT with dropout (kernel-path and dense per-row
  masks): every draw of world 2, its ranks' blocks put together, equals
  world 1's bit for bit, and the losses and parameters agree within 2e-5.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import flax.linen as fnn

from fluxmpi_tpu.models import MoEMLP as JaxMoEMLP
from fluxmpi_tpu.models import ViT as JaxViT
from fluxmpi_tpu.models import cosine_beta_schedule as jax_cosine
from fluxmpi_tpu.models import ddpm_loss as jax_ddpm_loss
from fluxmpi_tpu_torch import _batch_parallel
from fluxmpi_tpu_torch.models._layers import dense_dropout_keep

from _torch_worlds import join_world, start_world

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)
WORKER = __import__("pathlib").Path(__file__).resolve().parent / "_torch_zoo_world_worker.py"
ATOL = 2e-5
SEED = 0x1E3779B9
CASES = ("unet", "moe", "moe_groups3", "moe_sp", "vit_kernel", "vit_dense")
DRAWS = {"unet": ("tsteps", "eps"), "moe": ("noise",), "moe_groups3": ("noise",),
         "moe_sp": ("noise",),
         "vit_kernel": ("embed_keep", "attn_keep"), "vit_dense": ("embed_keep", "attn_keep")}


# ---- the keep masks over the whole batch's grid ----

@pytest.mark.parametrize("b0,h0,heads", [(0, 0, None), (3, 0, None), (2, 2, 6), (5, 4, 8)])
def test_keep_masks_key_rows_of_the_whole_batch(b0, h0, heads):
    b, h, sq, sk, keep = 2, 2, 8, 12, 0.7
    total = h if heads is None else heads
    rows = tfa.hash_rows(b, h, b0=b0, h0=h0, heads=heads)
    assert rows.tolist() == [[(b0 + i) * total + h0 + j for j in range(h)] for i in range(b)]
    q_pos, k_pos = torch.arange(sq), torch.arange(sk)
    got = tfa.dropout_keep_reference(SEED, rows[:, :, None, None], q_pos[:, None],
                                     k_pos[None, :], keep)
    dense = dense_dropout_keep(SEED, q_pos, k_pos, keep, bh=rows.reshape(-1))
    whole = (np.arange(b0 + b)[:, None] * total + np.arange(total)[None, :])[b0:, h0:h0 + h]
    want = np.asarray(jfa._dropout_keep(
        SEED, jnp.asarray(whole, jnp.uint32)[:, :, None, None],
        jnp.arange(sq, dtype=jnp.int32)[:, None], jnp.arange(sk, dtype=jnp.int32)[None, :],
        keep))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dense.reshape(b, h, sq, sk).numpy(), want)
    with pytest.raises(ValueError, match="do not lie"):
        tfa.hash_rows(b, h, h0=total - 1, heads=total)


# ---- flash attention with dropout: a share against the whole batch ----

def _qkv(b=4, s=16, h=4, d=8):
    rng = np.random.default_rng(3)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4)]


def _jax_flash(q, k, v, g, mesh=None, spec=None):
    """JAX's out and q/k/v gradients of ``sum(out * g)`` (dropout 0.5,
    interpret mode), jitted over arrays placed by ``spec`` on ``mesh``."""
    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, dropout_rate=0.5, dropout_seed=SEED,
                                  interpret=True)
        return jnp.sum(out * g), out

    args = [jnp.asarray(a) for a in (q, k, v)]
    if mesh is not None:
        args = [jax.device_put(a, NamedSharding(mesh, spec)) for a in args]
    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("split", ["rows", "heads"])
def test_flash_dropout_on_each_half_matches_jax_whole_batch(world, split):
    q, k, v, g = _qkv()
    want = _jax_flash(q, k, v, g)
    # JAX's own answer does not depend on the device count.
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    spec = P("x") if split == "rows" else P(None, None, "x")
    for a, b in zip(_jax_flash(q, k, v, g, mesh, spec), want):
        np.testing.assert_array_equal(a, b)
    axis = 0 if split == "rows" else 2
    n = q.shape[axis] // 2
    for j in range(2):
        part = [torch.from_numpy(np.take(a, range(j * n, (j + 1) * n), axis=axis))
                .requires_grad_(True) for a in (q, k, v)]
        rows = (j * n, 0, None) if split == "rows" else (0, j * n, q.shape[2])
        out, _ = tfa._attend(*part, False, None, None, 0.5, SEED, rows)
        gpart = torch.from_numpy(np.take(g, range(j * n, (j + 1) * n), axis=axis))
        grads = torch.autograd.grad((out * gpart).sum(), part)
        for got, w in zip((out, *grads), want):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.take(w, range(j * n, (j + 1) * n), axis=axis),
                                       atol=ATOL, rtol=0)


def test_flash_attention_fn_keys_the_batch_share_and_the_head_block():
    """Under the step's batch axes (a stand-in holding rows 2..3 of 4) and
    a head block (heads 2..3 of 4) the kernel-path dropout drops what the
    whole call drops there; without them, what a call on the share alone
    drops."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv())
    fn = tfa.flash_attention_fn(dropout_impl="kernel")

    def call(q, k, v):
        return fn(q, k, v, dropout_rng=torch.Generator().manual_seed(5), dropout_rate=0.5,
                  deterministic=False)

    whole = call(q, k, v)
    share = (q[2:, :, 2:], k[2:, :, 2:], v[2:, :, 2:])
    with _batch_parallel.active(types.SimpleNamespace(index=1, size=2)), \
            _batch_parallel.heads(2, 4):
        assert _batch_parallel.place(2, 2) == (2, 2, 4)
        got = call(*share)
    torch.testing.assert_close(got, whole[2:, :, 2:], atol=1e-6, rtol=0)
    assert not torch.allclose(call(*share), whole[2:, :, 2:], atol=1e-3)


# ---- JAX's draws do not depend on the device count ----

def _on(n, *arrays):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    return [jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp"))) for a in arrays]


VIT = dict(num_classes=5, patch=8, num_layers=1, d_model=16, num_heads=2, d_ff=32)


class _TimedDense(fnn.Module):
    """A model for ``ddpm_loss`` that compiles in a moment: its draws are
    what the test reads."""

    @fnn.compact
    def __call__(self, x, t):
        return fnn.Dense(3)(x) * (1.0 + t[:, None, None, None] / 100.0)


@pytest.mark.parametrize("kind", ["ddpm", "moe", "vit"])
def test_jax_draws_are_the_global_batchs(world, kind):
    """The DDPM loss's timesteps and noise, the router noise and ViT's
    dropout under ``jax.jit``: the same values with the batch on one CPU
    device and sharded over two; each half drawn alone with the same key
    (what the port's workers drew before C.32) differs."""
    key = jax.random.PRNGKey(15)
    rng = np.random.default_rng(4)
    if kind == "ddpm":
        model = _TimedDense()
        x = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((4,), jnp.int32))
        betas = jax_cosine(100)

        def f(x):
            return jax_ddpm_loss(model, params, x, key, betas)
    elif kind == "moe":
        model = JaxMoEMLP(num_experts=4, d_ff=16, router_noise=1.0)
        x = rng.normal(size=(4, 6, 8)).astype(np.float32)
        params = model.init({"params": jax.random.PRNGKey(0), "router": key}, jnp.asarray(x))

        def f(x):
            return jnp.mean(model.apply(params, x, rngs={"router": key}) ** 2)
    else:
        model = JaxViT(**VIT, dropout=0.5)
        x = rng.normal(size=(4, 24, 24, 3)).astype(np.float32)
        params = model.init({"params": jax.random.PRNGKey(0), "dropout": key},
                            jnp.asarray(x))

        def f(x):
            return jnp.mean(model.apply(params, x, rngs={"dropout": key}) ** 2)

    one = float(jax.jit(f)(*_on(1, x)))
    two = float(jax.jit(f)(*_on(2, x)))
    np.testing.assert_allclose(two, one, rtol=1e-6, atol=0)
    halves = np.mean([float(jax.jit(f)(jnp.asarray(x[i:i + 2]))) for i in (0, 2)])
    assert abs(halves - one) > 1e-3 * abs(one)


# ---- the port's worlds: world 2 draws what world 1 draws ----

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    started = {n: start_world("draws", tmp_path_factory.mktemp(f"draws{n}"), n, "-",
                              worker=WORKER) for n in (1, 2)}
    return {n: join_world(*w) for n, w in started.items()}


@pytest.mark.parametrize("case", CASES)
def test_world_two_draws_what_world_one_draws(worlds, case):
    (one,), two = worlds[1], worlds[2]
    for name in DRAWS[case]:
        calls = int(one[f"{case}/{name}_calls"])
        assert calls >= 2 and all(int(r[f"{case}/{name}_calls"]) == calls for r in two)
        for i in range(calls):
            key = f"{case}/{name}{i}"
            if case == "moe_sp":  # [rows x sequence block, experts] a rank
                glued = np.concatenate([r[key].reshape(4, -1, r[key].shape[-1])
                                        for r in two], axis=1).reshape(one[key].shape)
            else:
                glued = np.concatenate([r[key] for r in two])
            np.testing.assert_array_equal(glued, one[key], err_msg=key)
    for r in two:
        for u in range(2):
            np.testing.assert_allclose(r[f"{case}/loss{u}"], one[f"{case}/loss{u}"],
                                       atol=ATOL, rtol=0)
        params = [k for k in one if k.startswith(f"{case}/param/")]
        assert params
        for k in params:
            np.testing.assert_allclose(r[k], one[k], atol=ATOL, rtol=0, err_msg=k)
