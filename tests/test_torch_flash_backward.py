"""The port's flash-attention backward (its plain PyTorch path, which the
autograd function takes for CPU tensors) against ``jax.grad`` through the
JAX package's Pallas kernels in interpret mode: the same numpy inputs and
cotangents (``dO`` and ``dlse``) through both.

Tolerance: f32 on both sides, only the summation order differs; the
gradients are sums of up to 48 products of O(1) terms, atol 2e-5.

Also: the dropout keep mask equals the JAX package's ``_dropout_keep`` bit
for bit, the formula backward equals autograd of the forward reference,
and the CUDA wrappers' guard under a fake CUDA device (nothing reroutes to
the plain versions)."""

import contextlib
import ctypes
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL = 2e-5


def _segments(kind, b, sq, sk):
    if kind is None:
        return None
    if kind == "packed":
        seg = np.ones((b, sq), np.int32)
        seg[:, 10:22] = 2
        seg[:, 22:] = 3
        seg[1, 28:] = 0  # trailing pad in one row
        return seg
    if kind == "no_key_row":
        # Query row 3 of batch 0 carries a segment no key has; batch 1's
        # keys are all padding: rows with no attendable key.
        qseg = np.ones((b, sq), np.int32)
        qseg[0, 3] = 7
        kseg = np.ones((b, sk), np.int32)
        kseg[1] = 0
        return qseg, kseg
    raise ValueError(kind)


CASES = {
    "causal": dict(sq=32, sk=32, h=4, hkv=4, causal=True),
    "noncausal": dict(sq=32, sk=32, h=4, hkv=4),
    "window": dict(sq=32, sk=32, h=4, hkv=4, causal=True, window=8),
    "band": dict(sq=32, sk=32, h=4, hkv=4, window=-3),
    "segments": dict(sq=32, sk=32, h=4, hkv=4, causal=True, seg="packed"),
    "gqa": dict(sq=32, sk=32, h=4, hkv=2, causal=True),
    "mqa_cross": dict(sq=16, sk=48, h=4, hkv=1),
    "no_key_row": dict(sq=16, sk=16, h=2, hkv=2, causal=True, seg="no_key_row"),
    "dropout": dict(sq=32, sk=32, h=4, hkv=2, causal=True, dropout_rate=0.25,
                    dropout_seed=7),
}


def _inputs(case, seed, b=2, d=16):
    c = dict(case)
    sq, sk, h, hkv = c.pop("sq"), c.pop("sk"), c.pop("h"), c.pop("hkv")
    seg = _segments(c.pop("seg", None), b, sq, sk)
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d))]
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32)
    return c, seg, arrs, dlse


def _jax_grads(c, seg, q, k, v, g, dlse):
    jseg = None if seg is None else (
        tuple(jnp.asarray(s) for s in seg) if isinstance(seg, tuple)
        else jnp.asarray(seg))

    def loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(q, k, v, segment_ids=jseg, **c)
        return jnp.sum(out * g) + jnp.sum(lse * dlse)

    return [np.asarray(x) for x in
            jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _torch_grads(c, seg, q, k, v, g, dlse):
    tseg = None if seg is None else (
        tuple(torch.from_numpy(s) for s in seg) if isinstance(seg, tuple)
        else torch.from_numpy(seg))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, segment_ids=tseg, **c)
    out.backward(torch.from_numpy(g), retain_graph=True)
    lse.backward(torch.from_numpy(dlse))
    return [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_grad_with_lse_cotangent(name):
    c, seg, (q, k, v, g), dlse = _inputs(CASES[name], seed=len(name))
    want = _jax_grads(c, seg, q, k, v, g, dlse)
    got = _torch_grads(c, seg, q, k, v, g, dlse)
    for w, x, label in zip(want, got, "qkv"):
        assert x.shape == w.shape, label
        assert np.all(np.isfinite(x)), label
        np.testing.assert_allclose(x, w, atol=ATOL, rtol=0, err_msg=f"d{label}")


def test_backward_with_zero_lse_cotangent_matches_jax():
    """Only ``out`` used (``dlse`` absent on the torch side, zero on the
    JAX side): the path a model's attention takes."""
    c, seg, (q, k, v, g), _ = _inputs(CASES["gqa"], seed=3)
    want = _jax_grads(c, seg, q, k, v, g, np.zeros((2, 4, 32), np.float32))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv, **c).backward(torch.from_numpy(g))
    for w, x in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=ATOL, rtol=0)


def test_no_key_rows_have_zero_query_gradient():
    c, seg, (q, k, v, g), dlse = _inputs(CASES["no_key_row"], seed=4)
    dq, _, _ = _torch_grads(c, seg, q, k, v, g, dlse)
    assert np.all(dq[0, 3] == 0) and np.all(dq[1] == 0)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_mask_matches_jax_bit_for_bit(seed, rate):
    bh = np.arange(24, dtype=np.uint32)[:, None, None]
    q_pos = np.arange(70, dtype=np.int32)[None, :, None]
    k_pos = np.arange(90, dtype=np.int32)[None, None, :]
    want = np.asarray(jfa._dropout_keep(
        jnp.uint32(seed), jnp.asarray(bh), jnp.asarray(q_pos),
        jnp.asarray(k_pos), 1.0 - rate))
    got = tfa.dropout_keep_reference(
        seed, torch.from_numpy(bh.astype(np.int64)),
        torch.from_numpy(q_pos.astype(np.int64)),
        torch.from_numpy(k_pos.astype(np.int64)), 1.0 - rate).numpy()
    assert got.shape == want.shape == (24, 70, 90)
    assert np.array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.01


def test_dropout_threshold_is_the_hosts_double_precision_value():
    assert tfa.dropout_threshold(0.9) == min(int(0.9 * 4294967296.0), 4294967295)
    assert tfa.dropout_threshold(1.0) == 4294967295


def test_dropout_forward_matches_jax():
    c, seg, (q, k, v, _), _ = _inputs(CASES["dropout"], seed=5)
    jo, jl = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)), **c)
    to, tl = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), **c)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["causal", "band", "segments", "gqa", "dropout"])
def test_formula_backward_equals_autograd_of_forward_reference(name):
    """``flash_attention_bwd_reference`` is written out as formulas; it
    equals autograd through ``flash_attention_reference``."""
    c, seg, (q, k, v, g), dlse = _inputs(CASES[name], seed=9)
    opts = dict(causal=c.get("causal", False), window=c.get("window"),
                dropout_rate=c.get("dropout_rate", 0.0), seed=c.get("dropout_seed", 0))
    qseg = kseg = None
    if seg is not None:
        qseg = kseg = torch.from_numpy(seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, q_seg=qseg, kv_seg=kseg, **opts)
    tg, tdl = torch.from_numpy(g), torch.from_numpy(dlse)
    ((out * tg).sum() + (lse * tdl).sum()).backward()
    dterm = (tg * out.detach()).sum(-1).permute(0, 2, 1) - tdl
    got = tfa.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), tg, lse.detach(), dterm,
        q_seg=qseg, kv_seg=kseg, **opts)
    for x, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(x.numpy(), w.numpy(), atol=ATOL, rtol=0)


def test_dropout_needs_a_seed_and_a_rate_below_one():
    x = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(x, x, x, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"in \[0, 1\)"):
        tfa.flash_attention(x, x, x, dropout_rate=1.0, dropout_seed=1)


# ---------------------------------------------------------------------------
# The CUDA wrappers' guard, under a fake CUDA device
# ---------------------------------------------------------------------------


class _FakeLib:
    def __init__(self):
        self.calls = []
        # The uint32 at each call's dropout seed address, read at the call.
        self.seeds = []

    def __getattr__(self, name):
        if not name.startswith("flash_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            self.seeds.append(ctypes.c_uint32.from_address(args[-8]).value
                              if args[-9] else None)
            return 0

        return entry


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor, the loader returns a fake
    library, and the plain versions explode if anything reroutes to
    them."""
    from fluxmpi_tpu_torch.ops import _build

    lib = _FakeLib()
    monkeypatch.setattr(tfa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())

    def explode(*a, **k):
        raise AssertionError("rerouted to the plain version")

    monkeypatch.setattr(tfa, "flash_attention_reference", explode)
    monkeypatch.setattr(tfa, "flash_attention_bwd_reference", explode)
    return lib


def test_backward_launches_both_kernels_and_counts(fake_cuda):
    q = torch.zeros((2, 8, 4, 32), requires_grad=True)
    k = torch.zeros((2, 8, 2, 32), requires_grad=True)
    v = torch.zeros((2, 8, 2, 32), requires_grad=True)
    before = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True, window=5,
                                            dropout_rate=0.1, dropout_seed=2**32 + 3)
    (out.sum() + lse.sum()).backward()
    after = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert [name for name, _ in fake_cuda.calls] == ["flash_fwd", "flash_bwd_dq",
                                                     "flash_bwd_dkv"]
    # The C entries' trailing arguments: b sq sk h hkv d, causal has_window
    # window, dropout, the seed's device address, threshold, keep_prob, the
    # dropout hash's rows b0 h0 hg (a whole batch of one call: 0, 0, h),
    # dtype, stream. The three kernels read one seed buffer (the forward's,
    # saved for the backward), holding the seed's low 32 bits.
    for name, args in fake_cuda.calls:
        assert args[-18:-12] == (2, 8, 8, 4, 2, 32)
        assert args[-12:-9] == (1, 1, 5)
        assert args[-9] == 1 and args[-7:-5] == (tfa.dropout_threshold(0.9),
                                                 pytest.approx(0.9))
        assert args[-5:-2] == (0, 0, 4)
        assert args[-2:] == (0, 0)
    assert len({args[-8] for _, args in fake_cuda.calls}) == 1
    assert fake_cuda.seeds == [3, 3, 3]
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_backward_wrappers_reject_bad_inputs(fake_cuda):
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="dout must match"):
        tfa.flash_bwd_dq(q, q, q, None, None, torch.zeros(1, 8, 2, 8), lse, lse)
    with pytest.raises(ValueError, match=r"f32 \[b, h, sq\]"):
        tfa.flash_bwd_dkv(q, q, q, None, None, q, torch.zeros(1, 2, 4), lse)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        x = q.double()
        tfa.flash_bwd_dq(x, x, x, None, None, x, lse, lse)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_bwd_dkv(q.transpose(1, 2), q, q, None, None, q, lse, lse)
    seg = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_bwd_dq(q, q, q, seg, None, q, lse, lse)
    with pytest.raises(ValueError, match=r"q_seg \[b, sq\]"):
        tfa.flash_bwd_dkv(q, q, q, seg, torch.ones((1, 7), dtype=torch.int32), q, lse, lse)
    assert fake_cuda.calls == []
