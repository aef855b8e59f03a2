"""The port's chunked fused unembed + cross-entropy against the JAX
package's (``fluxmpi_tpu.ops.unembed_cross_entropy``): per-token losses
and the gradients of the hidden states and the table, from the same numpy
inputs and cotangent, with chunks that do not divide the vocab and with
label smoothing.

Tolerance: f32 on both sides; logsumexp and matmul sums over up to 37
logits of O(1) terms in different orders, atol 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.ops import unembed_cross_entropy as jax_ce
from fluxmpi_tpu_torch.ops import (unembed_cross_entropy,
                                   unembed_cross_entropy_reference)

torch.set_num_threads(1)

ATOL = 2e-5
VOCAB, D = 37, 16


def _inputs(seed, lead=(3, 5)):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((*lead, D)).astype(np.float32)
    w = (rng.standard_normal((VOCAB, D)) / 4).astype(np.float32)
    t = rng.integers(0, VOCAB, lead).astype(np.int32)
    g = rng.standard_normal(lead).astype(np.float32)
    return h, w, t, g


@pytest.mark.parametrize("chunk", [10, 37, 64, 8192])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_loss_and_grads_match_jax(chunk, eps):
    h, w, t, g = _inputs(chunk + int(eps * 10))

    def jloss(h, w):
        return jnp.sum(jax_ce(h, w, jnp.asarray(t), chunk=chunk,
                              label_smoothing=eps) * g)

    want = np.asarray(jax_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                             chunk=chunk, label_smoothing=eps))
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    got = unembed_cross_entropy(th, tw, torch.from_numpy(t), chunk=chunk,
                                label_smoothing=eps)
    (got * torch.from_numpy(g)).sum().backward()
    assert got.shape == (3, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=ATOL, rtol=0)


@pytest.mark.parametrize("eps", [0.0, 0.2])
def test_matches_the_full_logits_reference(eps):
    h, w, t, g = _inputs(11, lead=(4, 6))
    out = []
    for fn, kw in ((unembed_cross_entropy, dict(chunk=8)),
                   (unembed_cross_entropy_reference, {})):
        th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
        loss = fn(th, tw, torch.from_numpy(t), label_smoothing=eps, **kw)
        (loss * torch.from_numpy(g)).sum().backward()
        out.append((loss.detach().numpy(), th.grad.numpy(), tw.grad.numpy()))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_validation():
    h = torch.zeros(2, 3, D)
    w = torch.zeros(VOCAB, D)
    with pytest.raises(ValueError, match="targets shape"):
        unembed_cross_entropy(h, w, torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="hidden dim"):
        unembed_cross_entropy(torch.zeros(2, 3, 8), w, torch.zeros(2, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="chunk must be"):
        unembed_cross_entropy(h, w, torch.zeros(2, 3, dtype=torch.long), chunk=0)
    with pytest.raises(ValueError, match="label_smoothing"):
        unembed_cross_entropy(h, w, torch.zeros(2, 3, dtype=torch.long),
                              label_smoothing=1.0)
