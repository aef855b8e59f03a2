"""The port's CUDA kernel on the card: ``flash_fwd`` against its plain
PyTorch version, and the engine's flash streams against ``generate()``.

Marked ``cuda``: each test skips where CUDA is absent. On a machine with a
card (this file imports no JAX, so the JAX-pinning conftest can be left
out)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

# f32: both sides accumulate in f32, in different orders. bf16: one
# rounding of the f32 output to bf16 (2**-7 at magnitude < 2).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=1, sq=130, sk=130, h=4, hkv=4, d=64, causal=True),
    dict(b=2, sq=1, sk=300, h=4, hkv=2, d=128, seg="prefix"),
    dict(b=2, sq=70, sk=90, h=6, hkv=3, d=40, causal=True, window=17),
    dict(b=2, sq=64, sk=64, h=2, hkv=2, d=32, window=-3),
])
def test_flash_fwd_matches_plain_version(device, dtype, case):
    c = dict(case)
    b, sq, sk, h, hkv, d = (c.pop(n) for n in ("b", "sq", "sk", "h", "hkv", "d"))
    seg = c.pop("seg", None)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=gen).to(dtype).to(device)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    qseg = kseg = None
    if seg == "prefix":
        lens = torch.tensor([37, 300])
        qseg = torch.ones(b, sq, dtype=torch.int32, device=device)
        kseg = (torch.arange(sk)[None] < lens[:, None]).to(torch.int32).to(device)
        k[kseg == 0] = 1e4
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, qseg, kseg, **c)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, q_seg=qseg, kv_seg=kseg, **c)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_row_bits_independent_of_cache_length_and_prefill(device):
    """A decode row gives the same bits whatever the cache length past its
    prefix (garbage there included) and the same bits as that position
    inside a causal prefill: the property that keeps engine streams equal
    to generate()."""
    b, h, d, s = 1, 12, 64, 200
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(device) for _ in range(3))
    prefill, _ = fa.flash_fwd(q, k, v, causal=True)
    q_seg = torch.ones(b, 1, dtype=torch.int32, device=device)
    for pos in (0, 31, 32, 63, 64, 127, 150, 199):
        for total in (pos + 1, 256, 1024):
            kc = torch.full((b, total, h, d), 7e3, device=device)
            vc = torch.full((b, total, h, d), -7e3, device=device)
            kc[:, : pos + 1] = k[:, : pos + 1]
            vc[:, : pos + 1] = v[:, : pos + 1]
            kv_seg = (torch.arange(total, device=device)[None] <= pos).to(torch.int32)
            row, _ = fa.flash_fwd(q[:, pos:pos + 1].contiguous(), kc, vc, q_seg, kv_seg)
            assert torch.equal(row[:, 0], prefill[:, pos]), (pos, total)


def test_engine_flash_streams_equal_generate_on_card(device):
    from fluxmpi_tpu_torch.models import TransformerLM, generate
    from fluxmpi_tpu_torch.serving import InferenceEngine

    lm = TransformerLM(vocab_size=97, max_len=128, num_layers=2, d_model=64,
                       num_heads=4, d_ff=128, attention="flash", device=device)
    eng = InferenceEngine(lm, slots=3, block_size=16)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 97, p), n)
            for p, n in ((5, 9), (40, 20), (70, 3), (1, 30))]
    before = fa.flash_fwd.launches
    summary = eng.run()
    assert fa.flash_fwd.launches - before >= 2 * (eng.prefills + summary["decode_steps"])
    for r in reqs:
        ref = generate(lm, r.prompt[None], r.max_new_tokens)[0, len(r.prompt):]
        assert r.tokens == ref.tolist()
