"""The port's vision models against the JAX package's, on the CPU: the
Conv+BN ``CNN`` and ``ResNet`` (ResNet-50's own structure: stages 3, 4, 6,
3 of bottleneck blocks, at ``num_filters`` 4), from the same numpy inputs
and converted weights (``load_flax_variables``). Compared in f32: the
training forward's logits and loss, every gradient leaf, the new
``batch_stats``, and the eval forward's logits; a ``ResNet18`` forward; a
bf16 ``CNN`` within its rounding budget; and the two places where flax and
``torch.nn`` part ways (``padding="SAME"`` at stride 2, and BatchNorm's
running variance), each with the ``torch.nn`` spelling shown to miss.

Tolerances (f32 both sides, sums in other orders): logits and losses
atol 1e-4 (CNN 2e-5), gradients ``max|diff| / max|g| <= 1e-3`` per leaf
(CNN 1e-4), statistics atol 1e-5. The ResNet cases run at 64x64: at 32x32
the last stage is 1x1, so a batch of 2 leaves each BatchNorm channel 2
values, where ``E[x^2] - E[x]^2`` cancels and two correct f32
implementations part by up to 14% in a gradient (the same comparison in
f64 agrees to 1.5e-7); at 64x64 the last stage normalizes 8 values per
channel, and the stem still pads (2, 3).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
import flax.linen as fnn

from fluxmpi_tpu.models import CNN as JaxCNN
from fluxmpi_tpu.models import ResNet as JaxResNet
from fluxmpi_tpu.models import ResNet18 as JaxResNet18
from fluxmpi_tpu_torch.models import (CNN, ResNet, ResNet18, load_flax_variables,
                                      to_flax_params, to_flax_variables)
from fluxmpi_tpu_torch.models._layers import (BatchNorm, Conv, StatsContext,
                                              max_pool, same_pads)
from fluxmpi_tpu_torch.models.transformer import _Init

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _variables(jax_model, x, seed=0):
    """flax variables with every parameter moved off its init (BatchNorm's
    zero-initialised scales would zero most gradients)."""
    @jax.jit
    def make(x):
        v = jax_model.init(jax.random.PRNGKey(seed), x, train=False)
        leaves, spec = jax.tree_util.tree_flatten(v["params"])
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        params = jax.tree_util.tree_unflatten(
            spec, [a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
        return {"params": params, "batch_stats": v["batch_stats"]}

    return jax.tree_util.tree_map(np.asarray, make(jnp.asarray(x)))


def _jax_train(jax_model, variables, x, y):
    @jax.jit
    def loss_fn(p):
        logits, upd = jax_model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                      x, train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean()
        evals = jax_model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                x, train=False)
        return loss, (logits, upd["batch_stats"], evals)

    (loss, (logits, stats, evals)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return dict(loss=float(loss), logits=np.asarray(logits, np.float32),
                grads=_flat(grads), stats=_flat(stats),
                eval=np.asarray(evals, np.float32))


def _port_train(model, variables, x, y):
    model, state = load_flax_variables(model, variables)
    logits, new = model(torch.from_numpy(x), state, train=True)
    loss = F.cross_entropy(logits.float(), torch.from_numpy(y).long())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    with torch.no_grad():
        evals = model(torch.from_numpy(x), state, train=False)
    return dict(loss=float(loss.detach()), logits=logits.detach().float().numpy(),
                grads=to_flax_params(dict(zip(names, grads))),
                stats=to_flax_variables(model, new)["batch_stats"],
                eval=evals.float().numpy())


def _compare(port, ref, *, atol, grad_rtol, stats_atol=1e-5):
    assert abs(port["loss"] - ref["loss"]) <= atol
    np.testing.assert_allclose(port["logits"], ref["logits"], atol=atol, rtol=0)
    np.testing.assert_allclose(port["eval"], ref["eval"], atol=atol, rtol=0)
    assert set(port["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        err = np.abs(port["grads"][k] - g).max() / np.abs(g).max()
        assert err <= grad_rtol, (k, err)
    assert set(port["stats"]) == set(ref["stats"])
    for k, s in ref["stats"].items():
        np.testing.assert_allclose(port["stats"][k], s, atol=stats_atol, rtol=0,
                                   err_msg=k)


def _data(n, hw, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def test_cnn_matches_jax_f32():
    x, y = _data(2, 32)
    jm = JaxCNN(num_classes=10, channels=(8, 16, 16))
    v = _variables(jm, x)
    ref = _jax_train(jm, v, jnp.asarray(x), jnp.asarray(y))
    port = _port_train(CNN(10, (8, 16, 16), device="cpu"), v, x, y)
    _compare(port, ref, atol=2e-5, grad_rtol=1e-4)


def test_resnet50_structure_matches_jax_f32():
    x, y = _data(2, 64)
    jm = JaxResNet(stage_sizes=(3, 4, 6, 3), num_classes=10, num_filters=4)
    v = _variables(jm, x)
    ref = _jax_train(jm, v, jnp.asarray(x), jnp.asarray(y))
    model = ResNet((3, 4, 6, 3), num_classes=10, num_filters=4, device="cpu")
    assert len(ref["grads"]) == len(list(model.parameters())) == 161
    port = _port_train(model, v, x, y)
    _compare(port, ref, atol=1e-4, grad_rtol=1e-3)
    # Stage 0's first bottleneck projects at stride 1 (16 -> 4 x 4 channels),
    # the other stages' first blocks at stride 2, and no other block does.
    projected = sorted(k.split("/")[0] for k in ref["grads"] if "conv_proj" in k)
    assert projected == [f"stage{i}_block0" for i in range(4)]


def test_resnet18_forward_matches_jax():
    x, _ = _data(2, 64)
    jm = JaxResNet18(num_classes=10, num_filters=4)
    v = _variables(jm, x)
    (logits, upd), evals = jax.jit(lambda v, x: (
        jm.apply(v, x, train=True, mutable=["batch_stats"]), jm.apply(v, x, train=False)))(
        v, jnp.asarray(x))
    model, state = load_flax_variables(ResNet18(num_classes=10, num_filters=4,
                                                device="cpu"), v)
    with torch.no_grad():
        got, new = model(torch.from_numpy(x), state, train=True)
        got_eval = model(torch.from_numpy(x), state, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(evals), atol=1e-4, rtol=0)
    ref_stats = _flat(upd["batch_stats"])
    got_stats = to_flax_variables(model, new)["batch_stats"]
    assert set(got_stats) == set(ref_stats)
    for k, s in ref_stats.items():
        np.testing.assert_allclose(got_stats[k], s, atol=1e-5, rtol=0, err_msg=k)


def test_bf16_cnn_within_its_rounding_budget():
    """bf16 compute with f32 parameters and statistics, both sides. The
    forward rounds to bf16 at 12 points on the way to the logits (per
    block: the conv's input, kernel and output, the BatchNorm output; then
    the pooled mean), each at most 2**-8 relative: the logits, the loss
    and the new statistics must agree within 12 x 2**-8 of their largest
    magnitude. The backward at this size is another matter: BatchNorm's
    input gradient is a difference of nearly equal terms, and the JAX
    package's own bf16 gradients stand up to ~30% of a leaf's largest
    magnitude from its f32 ones (XLA on the CPU also drops some of the
    declared roundings). The budget for each of the port's bf16 gradient
    leaves, against the f32 gradients, is twice the JAX package's worst
    leaf."""
    x, y = _data(2, 16)
    budget = 12 * 2.0 ** -8
    channels = (8, 16, 16)
    jm = JaxCNN(num_classes=10, channels=channels, dtype=jnp.bfloat16)
    v = _variables(jm, x)
    ref = _jax_train(jm, v, jnp.asarray(x), jnp.asarray(y))
    f32 = _port_train(CNN(10, channels, device="cpu"), v, x, y)
    port = _port_train(CNN(10, channels, dtype=torch.bfloat16, device="cpu"), v, x, y)
    for key in ("logits", "eval"):
        scale = np.abs(ref[key]).max()
        assert np.abs(port[key] - ref[key]).max() <= budget * scale, key
    assert abs(port["loss"] - ref["loss"]) <= budget * ref["loss"]
    for k, s in ref["stats"].items():
        assert np.abs(port["stats"][k] - s).max() <= budget * max(np.abs(s).max(), 1.0), k

    def worst(grads):
        return max(np.abs(grads[k] - g).max() / np.abs(g).max()
                   for k, g in f32["grads"].items())

    assert worst(port["grads"]) <= 2 * worst(ref["grads"])


@pytest.mark.parametrize("hw", [32, 224])
def test_same_padding_is_flax_and_not_symmetric(hw):
    """The 7x7/2 stem pads (2, 3) on 32 and 224, and a 3x3/2 conv (0, 1):
    flax's ``"SAME"``. ``nn.Conv2d(padding=k // 2)`` pads symmetrically,
    which gives the same shape and other values."""
    assert same_pads((hw, hw), (7, 7), (2, 2)) == [(2, 3), (2, 3)]
    assert same_pads((56, 56), (3, 3), (2, 2)) == [(0, 1), (0, 1)]
    assert same_pads((112, 112), (3, 3), (2, 2)) == [(0, 1), (0, 1)]
    x = np.random.default_rng(0).normal(size=(1, hw, hw, 3)).astype(np.float32)
    conv = fnn.Conv(8, (7, 7), (2, 2), padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(v, jnp.asarray(x)))
    port = Conv(3, 8, (7, 7), (2, 2), init=_Init("cpu", torch.Generator()))
    with torch.no_grad():
        port.kernel.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"])))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        w = port.kernel.permute(3, 2, 0, 1)
        symmetric = F.conv2d(xt, w, stride=2, padding=3).permute(0, 2, 3, 1).numpy()
    assert got.shape == symmetric.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert np.abs(symmetric - ref).max() > 0.1
    # The 3x3/2 max pool pads (0, 1) with -inf.
    y = x[:, : hw // 2, : hw // 2]
    pooled = np.asarray(fnn.max_pool(jnp.asarray(y), (3, 3), (2, 2), padding="SAME"))
    with torch.no_grad():
        yt = torch.from_numpy(y).permute(0, 3, 1, 2)
        got_pool = max_pool(yt, (3, 3), (2, 2), "SAME").permute(0, 2, 3, 1).numpy()
        sym_pool = F.max_pool2d(yt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_pool, pooled)
    assert sym_pool.shape == pooled.shape and not np.array_equal(sym_pool, pooled)


def test_batchnorm_running_statistics_are_flax_and_not_torch():
    """flax keeps ``0.9 * old + 0.1 * batch`` with the biased batch
    variance (``E[x^2] - E[x]^2``); ``torch.nn.BatchNorm2d(momentum=0.1)``
    stores the unbiased one, n / (n - 1) times larger."""
    x = np.random.default_rng(1).normal(1.0, 2.0, size=(2, 3, 3, 4)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(4, init=_Init("cpu", torch.Generator()))
    port.path = "bn"
    ctx = StatsContext({"bn.mean": torch.zeros(4), "bn.var": torch.ones(4)}, True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = port(xt, ctx).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ctx.new["bn.mean"].numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ctx.new["bn.var"].numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6, rtol=0)
    tbn = torch.nn.BatchNorm2d(4, momentum=0.1, eps=1e-5)
    with torch.no_grad():
        tbn(xt)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    assert np.abs(tbn.running_var.numpy()
                  - np.asarray(upd["batch_stats"]["var"])).max() > 1e-2


def test_variables_round_trip_and_refuse_a_mismatch():
    x, _ = _data(1, 16)
    jm = JaxCNN(num_classes=10, channels=(4, 8))
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(x)))
    model, state = load_flax_variables(CNN(10, (4, 8), device="cpu"), v)
    assert set(state) == set(model.init_batch_stats()) == {
        "bn_0.mean", "bn_0.var", "bn_1.mean", "bn_1.var"}
    back = to_flax_variables(model, state)
    for coll in ("params", "batch_stats"):
        ref = _flat(v[coll])
        assert set(back[coll]) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(back[coll][k], ref[k])
    # Conv kernels keep flax's HWIO layout.
    assert tuple(model.conv_1.kernel.shape) == (3, 3, 4, 8)
    bad = {"params": v["params"], "batch_stats": {"bn_0": v["batch_stats"]["bn_0"]}}
    with pytest.raises(ValueError, match="batch_stats differ"):
        load_flax_variables(CNN(10, (4, 8), device="cpu"), bad)
