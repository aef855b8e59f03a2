"""The port's flash attention (its plain PyTorch path, which the CUDA
wrapper takes for CPU tensors) against the JAX package's Pallas kernel in
interpret mode: the same numpy inputs through both, f32, atol 1e-5.

Also: the guard of the CUDA wrapper under a fake CUDA device (bad dtype and
head dim raise, and nothing reroutes to the plain version)."""

import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# The packages re-export the function under the module's name.
jfa = importlib.import_module("fluxmpi_tpu.ops.flash_attention")
tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL = 1e-5  # f32 on both sides; only the summation order differs


def _qkv(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _segments(kind, b, sq, sk, rng):
    if kind is None:
        return None
    if kind == "packed":
        seg = np.ones((b, sq), np.int32)
        seg[:, 10:22] = 2
        seg[:, 22:] = 3
        seg[1, 28:] = 0  # trailing pad in one row
        return seg
    if kind == "padding":
        lens = [sq, sq - 9]
        return (np.arange(sq)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    if kind == "cross":
        return (np.ones((b, sq), np.int32),
                (np.arange(sk)[None] < np.asarray([sk, 20])[:, None]).astype(np.int32))
    raise ValueError(kind)


CASES = {
    "noncausal": dict(sq=32, sk=32, h=4, hkv=4),
    "causal": dict(sq=32, sk=32, h=4, hkv=4, causal=True),
    "packed": dict(sq=32, sk=32, h=4, hkv=4, causal=True, seg="packed"),
    "padding": dict(sq=32, sk=32, h=4, hkv=4, seg="padding"),
    "window": dict(sq=32, sk=32, h=4, hkv=4, causal=True, window=8),
    "gqa_kv1": dict(sq=32, sk=32, h=4, hkv=1, causal=True),
    "gqa_kv2": dict(sq=32, sk=32, h=4, hkv=2),
    "cross": dict(sq=16, sk=48, h=4, hkv=4, seg="cross"),
    "cross_causal": dict(sq=16, sk=48, h=4, hkv=2, causal=True),
}


def _run_both(case, seed=0, b=2, d=16, with_lse=True):
    c = dict(case)
    sq, sk, h, hkv = c.pop("sq"), c.pop("sk"), c.pop("h"), c.pop("hkv")
    seg = _segments(c.pop("seg", None), b, sq, sk, np.random.default_rng(seed))
    q, k, v = _qkv(seed, b, sq, sk, h, hkv, d)
    jseg = None if seg is None else (
        tuple(jnp.asarray(s) for s in seg) if isinstance(seg, tuple)
        else jnp.asarray(seg))
    tseg = None if seg is None else (
        tuple(torch.from_numpy(s) for s in seg) if isinstance(seg, tuple)
        else torch.from_numpy(seg))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if with_lse:
        jo, jl = jfa.flash_attention_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=jseg, **c)
        to, tl = tfa.flash_attention_with_lse(tq, tk, tv, segment_ids=tseg, **c)
        return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())
    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             segment_ids=jseg, **c)
    to = tfa.flash_attention(tq, tk, tv, segment_ids=tseg, **c)
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_with_lse_matches_jax(name):
    (jo, jl), (to, tl) = _run_both(CASES[name])
    assert to.dtype == np.float32 and tl.dtype == np.float32
    assert tl.shape == jl.shape
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["causal", "packed", "gqa_kv1", "cross"])
def test_flash_attention_matches_jax(name):
    jo, to = _run_both(CASES[name], seed=3, with_lse=False)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [4, -2])
def test_band_only_window_matches_jax(window):
    """causal=False with a window: the band ``q_pos - k_pos < window``
    alone (window <= 0 leaves some rows with no key at all)."""
    case = dict(sq=32, sk=32, h=4, hkv=4, causal=False, window=window)
    (jo, jl), (to, tl) = _run_both(case, seed=5)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


def test_decode_shape_with_garbage_past_prefix_matches_jax():
    """The serving decode call: one query row per batch row against a
    cache whose positions past each row's prefix hold large garbage."""
    b, sk, h, d = 3, 64, 4, 16
    q, k, v = _qkv(11, b, 1, sk, h, h, d)
    lens = np.array([1, 37, 64])
    dead = np.arange(sk)[None] >= lens[:, None]
    rng = np.random.default_rng(12)
    k[dead] = rng.uniform(-1e4, 1e4, k[dead].shape)
    v[dead] = rng.uniform(-1e4, 1e4, v[dead].shape)
    qseg = np.ones((b, 1), np.int32)
    kseg = (~dead).astype(np.int32)
    jo, jl = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=(jnp.asarray(qseg), jnp.asarray(kseg)))
    to, tl = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)),
        segment_ids=(torch.from_numpy(qseg), torch.from_numpy(kseg)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert np.abs(to.numpy()).max() < 10  # no garbage leaked into a row


def test_row_with_no_attendable_key_is_zero_with_lse_floor():
    b, s, h, d = 2, 16, 2, 8
    q, k, v = _qkv(2, b, s, s, h, h, d)
    qseg = np.ones((b, s), np.int32)
    qseg[0, 3] = 7  # no key carries segment 7
    kseg = np.ones((b, s), np.int32)
    kseg[1] = 0     # row 1: every key is padding
    seg_t = (torch.from_numpy(qseg), torch.from_numpy(kseg))
    to, tl = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), segment_ids=seg_t)
    jo, jl = jfa.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)),
        segment_ids=(jnp.asarray(qseg), jnp.asarray(kseg)))
    for o, lse in ((to.numpy(), tl.numpy()), (np.asarray(jo), np.asarray(jl))):
        assert np.all(o[0, 3] == 0) and np.all(o[1] == 0)
        assert np.all(lse[0, :, 3] == -1e30) and np.all(lse[1] == -1e30)
        assert np.all(np.isfinite(o))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)


def test_output_keeps_input_dtype_and_validation():
    q = torch.zeros((1, 8, 2, 8), dtype=torch.bfloat16)
    out, lse = tfa.flash_attention_with_lse(q, q, q, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (1, 2, 8)
    with pytest.raises(ValueError, match="requires causal=True"):
        tfa.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="multiple of the kv head"):
        tfa.flash_attention(torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 2, 8),
                            torch.zeros(1, 8, 2, 8))
    with pytest.raises(ValueError, match="requires q/k sequence lengths"):
        tfa.flash_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 8, 2, 8),
                            torch.zeros(1, 8, 2, 8),
                            segment_ids=torch.ones(1, 4, dtype=torch.int32))
    assert tfa.padding_to_segment_ids(torch.tensor([[True, False]])).tolist() == [[1, 0]]


# ---------------------------------------------------------------------------
# The CUDA wrapper's guard, under a fake CUDA device
# ---------------------------------------------------------------------------


class _FakeLib:
    def __init__(self):
        self.calls = 0
        self.devices = []

    def flash_fwd(self, *args):
        self.calls += 1
        return 0


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor, the loader returns a fake
    library, and the plain version explodes if anything reroutes to it."""
    from fluxmpi_tpu_torch.ops import _build

    lib = _FakeLib()
    monkeypatch.setattr(tfa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())

    @contextlib.contextmanager
    def _device(device):
        lib.devices.append(torch.device(device))
        yield

    monkeypatch.setattr(torch.cuda, "device", _device)

    def explode(*a, **k):
        raise AssertionError("rerouted to the plain version")

    monkeypatch.setattr(tfa, "flash_attention_reference", explode)
    return lib


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_wrapper_rejects_unsupported_dtype(fake_cuda, dtype):
    x = torch.zeros((1, 8, 2, 16), dtype=dtype)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        tfa.flash_attention(x, x, x, causal=True)
    assert fake_cuda.calls == 0


def test_cuda_wrapper_rejects_head_dim_above_128(fake_cuda):
    x = torch.zeros((1, 8, 2, 160))
    with pytest.raises(ValueError, match="head_dim <= 128"):
        tfa.flash_attention(x, x, x, causal=True)
    assert fake_cuda.calls == 0


def test_cuda_wrapper_launches_and_counts(fake_cuda):
    x = torch.zeros((1, 8, 2, 64))
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_attention_with_lse(x, x, x, causal=True)
    assert fake_cuda.calls == 1 and tfa.flash_fwd.launches == before + 1
    assert fake_cuda.devices == [x.device]  # launched under the inputs' device
    assert out.shape == x.shape and lse.shape == (1, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(x.transpose(1, 2), x, x)
    assert fake_cuda.calls == 1
