"""The port's CUDA kernels on the card: ``flash_fwd``, ``flash_bwd_dq``
and ``flash_bwd_dkv`` against their plain PyTorch versions (dropout keep
masks bit for bit), autograd through the kernels, the engine's flash
streams against ``generate()``, a bf16-compute training update through
the kernels against the plain versions, an async checkpoint save that the
next in-place updates cannot change, a fused training window captured as
one CUDA graph against the pipelined run bit for bit (with and without
remat) and with a loss_fn whose host-side state the graph fixes at
capture, BatchNorm's statistics carried by a captured window (with the
step's statistics all-reduce and a sync-BN model at world 1 over NCCL), a
ResNet on the card against the CPU, the kernels at the zoo's shapes (ViT's
197 tokens, the UNet's head dim 128), ``flash_attention_fn``'s mask inside
a captured graph, a DDPM window whose CUDA generator draws afresh on every
replay, the dropout seed read from device memory (a tensor seed against
the int seed, fresh masks in every replay of a captured graph), the
model stats computed inside a captured window (the same stats as the
pipelined run's, every parameter bit for bit, a capture as a compile
event), a ``torch.profiler`` capture beside a captured window, on a
machine with two or more cards one data-parallel step over NCCL against
the single-process step, and on four cards the layout autotuner's search
over dp x fsdp x tp with its winner trained against pure dp.

Marked ``cuda``: each test skips where CUDA is absent. On a machine with a
card (this file imports no JAX, so the JAX-pinning conftest can be left
out)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

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
    dict(b=1, sq=50, sk=70, h=2, hkv=1, d=33, causal=True),
    # Grids large enough for blocks of several row groups.
    dict(b=2, sq=1024, sk=1024, h=12, hkv=4, d=64, causal=True),
    dict(b=2, sq=768, sk=768, h=12, hkv=12, d=128, causal=True, window=100),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_row_bits_independent_of_cache_length_and_prefill(device, dtype, d):
    """A decode row gives the same bits whatever the cache length past its
    prefix (garbage there included) and the same bits as that position
    inside a causal prefill, and a causal prefill's rows give the same bits
    whatever its length: exact, shorter, or padded to a bucket with garbage
    past the prompt. The property that keeps engine streams equal to
    generate(). The long prefills run blocks of several row groups, the
    short ones and the decode rows blocks of one."""
    b, h, s, bucket = 2, 12, 700, 768
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dtype).to(device)
               for _ in range(3))
    prefill, _ = fa.flash_fwd(q, k, v, causal=True)
    padded = [torch.full((b, bucket, h, d), fill, dtype=dtype, device=device)
              for fill in (3.0, 7e3, -7e3)]
    for buf, x in zip(padded, (q, k, v)):
        buf[:, :s] = x
    rows, _ = fa.flash_fwd(*padded, causal=True)
    assert torch.equal(rows[:, :s], prefill)
    for n in (1, 17, 130):
        rows, _ = fa.flash_fwd(q[:, :n].contiguous(), k[:, :n].contiguous(),
                               v[:, :n].contiguous(), causal=True)
        assert torch.equal(rows, prefill[:, :n]), n
    q_seg = torch.ones(b, 1, dtype=torch.int32, device=device)
    for pos in (0, 31, 32, 63, 64, 127, 150, 199, 511, 699):
        for total in (pos + 1, max(pos + 1, 256), 1024):
            kc = torch.full((b, total, h, d), 7e3, dtype=dtype, device=device)
            vc = torch.full((b, total, h, d), -7e3, dtype=dtype, device=device)
            kc[:, : pos + 1] = k[:, : pos + 1]
            vc[:, : pos + 1] = v[:, : pos + 1]
            kv_seg = (torch.arange(total, device=device)[None] <= pos).to(torch.int32)
            kv_seg = kv_seg.expand(b, total).contiguous()
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


# Gradients: both sides start from the same inputs, lse and dterm, and sum
# in f32 in different orders; errors are relative to the output's largest
# magnitude. bf16: one rounding of the f32 result (2**-7 relative).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7 + 1e-4}


def _bwd_inputs(device, dtype, b, sq, sk, h, hkv, d, seg=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(*s, generator=gen).to(dtype).to(device)
                  for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                            (b, sq, h, d)))
    qseg = kseg = None
    if seg == "packed":
        qseg = torch.ones(b, sq, dtype=torch.int32)
        qseg[:, sq // 3:] = 2
        qseg[:, 2 * sq // 3:] = 3
        qseg[-1, -sq // 5:] = 0  # trailing padding
        qseg[0, 5] = 9           # a query row whose segment no key carries
        kseg = qseg.clone()
        kseg[0, 5] = 1
        qseg, kseg = qseg.to(device), kseg.to(device)
    return q, k, v, g, qseg, kseg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=2, sq=130, sk=130, h=4, hkv=4, d=64, causal=True),
    dict(b=2, sq=96, sk=96, h=6, hkv=2, d=40, causal=True, window=17),
    dict(b=1, sq=64, sk=80, h=2, hkv=1, d=128, window=-3),
    dict(b=2, sq=100, sk=100, h=4, hkv=2, d=64, causal=True, seg="packed"),
    dict(b=2, sq=64, sk=64, h=4, hkv=4, d=32, causal=True, dropout_rate=0.1, seed=7),
    dict(b=1, sq=50, sk=70, h=2, hkv=1, d=33, causal=True),
    # Grids large enough for blocks of several row groups.
    dict(b=2, sq=1024, sk=1024, h=12, hkv=12, d=64, causal=True),
    dict(b=2, sq=704, sk=704, h=12, hkv=4, d=40, causal=True, seg="packed"),
    dict(b=2, sq=768, sk=768, h=12, hkv=6, d=128, causal=True, dropout_rate=0.1, seed=3),
    # The dK/dV kernel's block shapes: grouped-query heads (group 6) at
    # s >= 1024 in blocks of one and of four key-row groups, a band
    # (window without causal), odd d with sk != sq (unaligned rows), and
    # d = 32 with packed segments, each large enough for four row groups.
    dict(b=1, sq=1024, sk=1024, h=12, hkv=2, d=64, causal=True, dropout_rate=0.1, seed=11),
    dict(b=5, sq=1024, sk=1024, h=24, hkv=4, d=64, causal=True),
    dict(b=2, sq=768, sk=768, h=12, hkv=12, d=64, window=100),
    dict(b=2, sq=900, sk=1100, h=12, hkv=12, d=33, causal=True, window=300),
    dict(b=2, sq=1024, sk=1024, h=12, hkv=12, d=32, causal=True, seg="packed"),
])
def test_flash_bwd_kernels_match_plain_version(device, dtype, case):
    c = dict(case)
    dims = [c.pop(n) for n in ("b", "sq", "sk", "h", "hkv", "d")]
    q, k, v, g, qseg, kseg = _bwd_inputs(device, dtype, *dims, seg=c.pop("seg", None))
    out, lse = fa.flash_fwd(q, k, v, qseg, kseg, **c)
    dlse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(3)).to(device)
    dterm = ((g.float() * out.float()).sum(-1).permute(0, 2, 1) - dlse).contiguous()
    n_dq, n_dkv = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    dq = fa.flash_bwd_dq(q, k, v, qseg, kseg, g, lse, dterm, **c)
    dk, dv = fa.flash_bwd_dkv(q, k, v, qseg, kseg, g, lse, dterm, **c)
    want = fa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, q_seg=qseg,
                                            kv_seg=kseg, **c)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * ref.float().abs().max().item() + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv", [12, 2])
def test_flash_bwd_dkv_is_deterministic(device, dtype, hkv):
    """Each dK/dV row has one writer and its partials are summed in a fixed
    order: launches on the same inputs give the same bits (h_kv = 12 runs
    blocks of four key-row groups, the grouped h_kv = 2 blocks of one)."""
    q, k, v, g, _, _ = _bwd_inputs(device, dtype, 2, 1024, 1024, 12, hkv, 64, seed=4)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, causal=True)
    for _ in range(3):
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, causal=True)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.isfinite(dk.float()).all() and dk.abs().max() > 0


def test_bf16_kernels_add_nothing_to_the_output_rounding(device):
    """The bf16 kernels form P.V, dS.K, P^T.dO and dS^T.Q from f32 P and dS
    split into a bf16 hi and lo part, as the JAX package forms them from
    f32 ``p`` and ``ds``. At the training shape each bf16 output's error
    against the plain version in f32 on the same (bf16) inputs,
    ||got - ref||, is the bf16 rounding of the output itself,
    ||bf16(ref) - ref||, within 1/16 of it. The two add in quadrature, so
    this holds the kernel's error before the rounding under 0.36 of the
    rounding's (~3e-4 of ||ref||): far above f32 and split-bf16 operands
    (~1e-5), far below a single bf16 product of the rounded P or dS (its
    ratio is ~1.4: a numpy emulation at s = 1024, d = 64 gives 1.34-1.46
    for all four products, and exactly 1 for the split)."""
    b, s, h, d = 8, 1024, 12, 64
    gen = torch.Generator().manual_seed(2)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to(torch.bfloat16).to(device)
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, None, None, g, lse, dterm, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, causal=True)
    f = [t.float() for t in (q, k, v, g)]
    want = (fa.flash_attention_reference(*f[:3], causal=True)[0],
            *fa.flash_attention_bwd_reference(*f, lse, dterm, causal=True))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and ref.dtype == torch.float32
        rounding = (ref.to(torch.bfloat16).float() - ref).norm().item()
        err = (got.float() - ref).norm().item()
        assert 0 < err <= (1 + 2 ** -4) * rounding, (name, err / rounding)


def test_dropout_masks_equal_reference_bit_for_bit(device):
    """Each kernel's keep mask read off its output: with q = 0 every live
    probability is equal and nonzero, and identity matrices as V (forward),
    K (dQ) and dO (dV) copy the dropped probabilities into the output, so
    an entry is nonzero iff the kernel kept it."""
    b, h, s, d, rate, seed = 2, 12, 128, 128, 0.1, 12345
    eye = torch.eye(s, device=device).expand(b, h, s, d).permute(0, 2, 1, 3).contiguous()
    zeros = torch.zeros(b, s, h, d, device=device)
    keep = fa.dropout_keep_reference(
        seed, torch.arange(b * h, device=device).reshape(b, h, 1, 1),
        torch.arange(s, device=device).reshape(1, 1, s, 1),
        torch.arange(s, device=device).reshape(1, 1, 1, s), 1 - rate)
    assert 0.85 < keep.float().mean().item() < 0.95
    opts = dict(dropout_rate=rate, seed=seed)
    out, _ = fa.flash_fwd(zeros, zeros, eye, **opts)            # O[q, c=k] = p_drop
    assert torch.equal(out.permute(0, 2, 1, 3) != 0, keep)
    lse = torch.zeros(b, h, s, device=device)                   # p = exp(0) = 1
    dterm = torch.zeros(b, h, s, device=device)
    ones = torch.zeros(b, s, h, d, device=device)
    ones[..., 0] = 1.0                                          # dp = dO . v = 1
    dq = fa.flash_bwd_dq(zeros, eye, ones, None, None, ones, lse, dterm, **opts)
    assert torch.equal(dq.permute(0, 2, 1, 3) != 0, keep)       # dQ[q, c=k] = ds
    _, dv = fa.flash_bwd_dkv(zeros, zeros, zeros, None, None, eye, lse, dterm, **opts)
    assert torch.equal(dv.permute(0, 2, 3, 1) != 0, keep)       # dV[k, c=q] = p_drop


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_read_a_device_seed_as_the_int_seed(device, dtype):
    """The kernels read the dropout seed from device memory: a seed tensor
    on the card (a uint32 value above 2**31 included, as an int64 and as
    the int32 bit pattern) gives the outputs of the same int seed, bit for
    bit, in all three kernels."""
    gen = torch.Generator().manual_seed(8)
    b, s, h, hkv, d = 2, 192, 6, 3, 64
    q, g = (torch.randn(b, s, h, d, generator=gen).to(dtype).to(device) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen).to(dtype).to(device) for _ in range(2))
    seed = 0xF00DBEEF

    def run(seed):
        opts = dict(causal=True, dropout_rate=0.15, seed=seed)
        out, lse = fa.flash_fwd(q, k, v, **opts)
        dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, None, None, g, lse, dterm, **opts)
        return (out, lse, dq, *fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, **opts))

    want = run(seed)
    for as_tensor in (torch.tensor(seed, device=device),
                      torch.tensor([seed - 2 ** 32], dtype=torch.int32, device=device)):
        got = run(as_tensor)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(run(seed + 1)[0], want[0])


def test_captured_dropout_draws_a_fresh_mask_on_every_replay(device):
    """``flash_attention`` with a seed drawn on the card from a registered
    CUDA generator, captured once as a CUDA graph: two replays drop two
    different masks, and each replay's output and gradients equal an eager
    call at the seed that replay drew."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen).to(device).requires_grad_()
               for _ in range(3))
    rng = torch.Generator(device=device).manual_seed(3)
    seed = torch.zeros((), dtype=torch.int64, device=device)

    def call():
        drawn = torch.randint(0, 2 ** 32, (), generator=rng, dtype=torch.int64,
                              device=device)
        seed.copy_(drawn)
        out = fa.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                 dropout_seed=drawn)
        return (out, *torch.autograd.grad(out.square().sum(), (q, k, v)))

    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        call()  # warm-up on the capture stream
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(rng)
    with torch.cuda.graph(graph, stream=stream):
        static = call()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        drawn = int(seed.item())
        got = [t.clone() for t in static]
        out = fa.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                 dropout_seed=drawn)
        want = (out, *torch.autograd.grad(out.square().sum(), (q, k, v)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        replays.append((drawn, got[0]))
    assert replays[0][0] != replays[1][0]
    assert not torch.equal(replays[0][1], replays[1][1])


def test_autograd_runs_the_three_kernels(device):
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 70, 4, 32, generator=gen).to(device).requires_grad_()
               for _ in range(3))
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    (out.square().sum() + lse.sum()).backward()
    after = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    q2, k2, v2 = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    o2, l2 = fa.flash_attention_with_lse(q2, k2, v2, causal=True)
    (o2.square().sum() + l2.sum()).backward()
    for got, ref in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        assert (got.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _small_bf16_lm(device, seed=3):
    from fluxmpi_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=211, max_len=128, num_layers=2, d_model=128,
                         num_heads=2, d_ff=256, attention="flash",
                         dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(seed))


def test_bf16_training_update_through_the_kernels_matches_plain_versions(device):
    """One bf16-compute update's gradients (f32 masters) through the three
    kernels against the same update through their plain versions. Both
    sides round in bf16 and differ only in the attention's roundings: at
    most about 2**-8 per attention crossed forward and back (2 x 2 layers),
    per leaf ||diff|| / ||g|| (a bias's gradient sums many tokens' terms
    that mostly cancel, so one element's error says little of the leaf);
    key biases (zero in exact arithmetic) against the model's largest
    gradient norm. ``scripts/bf16_grad_bound.py`` reads this ratio beside
    kernels made wrong on purpose."""
    lm = _small_bf16_lm(device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 211, (4, 128), generator=gen).to(device)
    y = torch.randint(0, 211, (4, 128), generator=gen).to(device)
    params = list(lm.parameters())
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    g_kernel = torch.autograd.grad(lm(x, targets=y).mean(), params)
    after = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    saved = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    ref, bwd = fa.flash_attention_reference, fa.flash_attention_bwd_reference
    try:
        fa.flash_fwd = lambda q, k, v, qs=None, ks=None, **o: ref(q, k, v, q_seg=qs,
                                                                  kv_seg=ks, **o)
        fa.flash_bwd_dq = lambda q, k, v, qs, ks, g, lse, dt, **o: bwd(
            q, k, v, g, lse, dt, q_seg=qs, kv_seg=ks, **o)[0]
        fa.flash_bwd_dkv = lambda q, k, v, qs, ks, g, lse, dt, **o: bwd(
            q, k, v, g, lse, dt, q_seg=qs, kv_seg=ks, **o)[1:]
        g_plain = torch.autograd.grad(lm(x, targets=y).mean(), params)
    finally:
        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = saved
    tol = 2 ** -8 * 2 * 2
    top = max(b.norm().item() for b in g_plain)
    for (name, _), a, b in zip(lm.named_parameters(), g_kernel, g_plain):
        assert a.dtype == torch.float32
        scale = top if name.endswith("attn.key.bias") else b.norm().item()
        assert (a - b).norm().item() <= tol * scale, name


def test_async_save_while_updates_run_in_place_keeps_the_saved_bytes(device, tmp_path):
    """An async save's snapshot is taken before the next updates, queued on
    the same stream, change the parameters and moments in place: the
    restored bytes equal a copy taken at the saved step."""
    from fluxmpi_tpu_torch import faults, optim
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
    from fluxmpi_tpu_torch.utils import CheckpointManager

    lm = _small_bf16_lm(device, seed=4)
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, 211, (4, 128), generator=gen).to(device),
                torch.randint(0, 211, (4, 128), generator=gen).to(device))
               for _ in range(4)]
    opt = optim.adamw(1e-3)
    step = make_train_step(lambda p, ms, b: (lm(b[0], targets=b[1]).mean(), ms), opt,
                           grad_reduce=None)
    state = TrainState.create(lm, opt)
    state, _ = step(state, batches[0])

    def leaves(st):
        out = dict(st.params)
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in st.opt_state[m].items()})
        return out

    mgr = CheckpointManager(str(tmp_path / "run"))
    with faults.scope("ckpt.async_write@step=1:delay=0.5"):
        mgr.save(1, {"state": state})      # returns before the write
        copy = {k: v.detach().clone() for k, v in leaves(state).items()}
        for batch in batches[1:]:          # in place, while the writer waits
            state, _ = step(state, batch)
        mgr.wait_until_finished()
    torch.cuda.synchronize()
    assert all(not torch.equal(leaves(state)[k], copy[k]) for k in state.params)
    _, back = mgr.restore({"state": state})
    assert back["state"].step == 1
    for k, v in leaves(back["state"]).items():
        assert v.device == device and torch.equal(v, copy[k]), k
    mgr.close()


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_fused_window_graph_is_bit_identical_to_eager(device, remat):
    """train_loop(fuse="window") on the card: the first window of the width
    runs eagerly, the second captures the window (gathers, forward and
    backward through the three kernels, the NCCL gradient all-reduce of a
    world of one, adamw) as one CUDA graph, and every window replays it.
    Every parameter, moment, count and flush loss equals the pipelined
    run's bit for bit; the kernels' launches are the eager window's plus
    the replays' (the counters' rise during capture launched nothing), and
    the device's own counts agree on both paths."""
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 211, (32, 129), generator=gen).numpy()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    fm.init()
    try:
        def run(fuse):
            lm = _small_bf16_lm(device, seed=6)
            opt = optim.adamw(1e-3)
            step = make_train_step(
                lambda p, ms, b: (lm(b[0], targets=b[1]).mean(), ms), opt,
                remat=remat)
            loader = fm.DistributedDataLoader(
                fm.ArrayDataset((tokens[:, :-1], tokens[:, 1:])), 4, shuffle=True)
            before = [f.launches for f in kernels]
            fa.device_launches(device, reset=True)
            state, summary = train_loop(step, TrainState.create(lm, opt), loader,
                                        epochs=2, flush_every=4, fuse=fuse)
            on_device = list(fa.device_launches(device).values())
            counted = [f.launches - b for f, b in zip(kernels, before)]
            return state, summary, counted, step, on_device

        ref, s_ref, n_ref, _, dev_ref = run(False)
        got, s_got, n_got, step, dev_got = run("window")
    finally:
        fm.shutdown()
    assert (s_got["fused_window"], s_got["dispatches"], s_ref["dispatches"]) == (4, 4, 16)
    (prog,) = step.__fluxmpi_window_cache__.values()
    assert prog.graph is not None and prog.replays == 3
    per_update = 2 * (2 if remat else 1)  # two layers; remat runs the forward twice
    assert prog.captured_launches == {"flash_fwd": 4 * per_update,
                                      "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    assert n_ref == [16 * per_update, 32, 32]
    # The counters rose by one captured copy, which launched nothing; the
    # graph launched its copy on each of the 3 replays.
    assert prog.capture_counted == prog.captured_launches
    assert prog.replayed_launches == {k: 3 * n for k, n in prog.captured_launches.items()}
    launched = [n - prog.capture_counted[f.__name__] + prog.replayed_launches[f.__name__]
                for n, f in zip(n_got, kernels)]
    assert launched == n_ref
    assert dev_ref == dev_got == n_ref
    assert got.step == ref.step == 16
    flush = lambda s: [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])  # noqa: E731
                       for f in s["flushes"]]
    assert flush(s_got) == flush(s_ref) and len(s_ref["flushes"]) == 4
    for name in ref.params:
        assert torch.equal(got.params[name], ref.params[name]), name
        for m in ("mu", "nu"):
            assert torch.equal(got.opt_state[m][name], ref.opt_state[m][name]), (m, name)
    assert torch.equal(got.opt_state["count"], ref.opt_state["count"])


def test_fused_window_graph_carries_the_model_state(device):
    """A step whose loss_fn returns a new model state (a tensor updated from
    the batch): the replayed windows carry it from window to window as the
    eager updates do."""
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    x = np.random.default_rng(0).uniform(-2, 2, (64, 1)).astype(np.float32)

    def run(fuse):
        model = MLP(features=(16, 1), device=device)

        def loss_fn(p, ms, b):
            return ((model(b[0]) - b[1]) ** 2).mean(), ms + b[0].sum()

        opt = optim.adam(1e-3)
        state = TrainState.create(model, opt,
                                  model_state=torch.zeros((), device=device))
        loader = fm.DistributedDataLoader(fm.ArrayDataset((x, x ** 2)), 8,
                                          shuffle=True, device=device)
        return train_loop(make_train_step(loss_fn, opt, grad_reduce=None), state,
                          loader, epochs=3, flush_every=4, fuse=fuse)

    ref, _ = run(False)
    got, summary = run("window")
    assert (summary["fused_window"], summary["dispatches"]) == (4, 6)
    assert torch.equal(got.model_state, ref.model_state)
    for name in ref.params:
        assert torch.equal(got.params[name], ref.params[name]), name


def test_fused_window_graph_fixes_host_state_at_capture(device):
    """A loss_fn with host-side state (a Python counter scaling the loss)
    under fuse="window": the counter advances in the eager first window
    and at the capture only, and every replay reuses the capture's last
    scale, so the run leaves the pipelined one (where the counter advances
    at every update). fuse=False keeps the eager semantics."""
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    x = np.random.default_rng(0).uniform(-2, 2, (64, 1)).astype(np.float32)

    def run(fuse):
        model = MLP(features=(16, 1), device=device,
                    generator=torch.Generator().manual_seed(0))
        calls = [0]

        def loss_fn(p, ms, b):
            calls[0] += 1
            return ((model(b[0]) - b[1]) ** 2).mean() * (1.0 + 0.5 * calls[0]), ms

        opt = optim.adam(1e-3)
        loader = fm.DistributedDataLoader(fm.ArrayDataset((x, x ** 2)), 8,
                                          shuffle=True, device=device)
        state, summary = train_loop(make_train_step(loss_fn, opt, grad_reduce=None),
                                    TrainState.create(model, opt), loader,
                                    epochs=2, flush_every=4, fuse=fuse)
        return state, summary, calls[0]

    ref, s_ref, n_ref = run(False)
    got, s_got, n_got = run("window")
    assert (s_got["dispatches"], s_ref["dispatches"]) == (4, 16)
    assert n_ref == 16 and n_got == 2 * 4  # the eager window and the capture
    # The first window is eager in both runs; the replays differ.
    assert s_got["flushes"][0]["loss"] == s_ref["flushes"][0]["loss"]
    assert not all(torch.equal(got.params[k], ref.params[k]) for k in ref.params)


def test_model_stats_inside_a_captured_window(device, tmp_path):
    """``make_train_step(model_stats=3)`` in CUDA-graph windows: the stats the
    graph writes equal the pipelined run's (norms within 1e-5 relative,
    counts exact; both compute them from the same tensors, the window at its
    last update), every parameter and moment equals the run without stats
    bit for bit, each capture reaches the compile monitor as a compile
    event attributed to ``train_loop.window``, and an auto-profiler capture
    started beside the replays writes its trace and leaves no profiler
    running."""
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim, telemetry
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.utils.profiling import AutoProfiler

    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 211, (32, 129), generator=gen).numpy()
    fm.init()
    try:
        def run(fuse, stats):
            lm = _small_bf16_lm(device, seed=6)
            opt = optim.adamw(1e-3)
            step = make_train_step(lambda p, ms, b: (lm(b[0], targets=b[1]).mean(), ms),
                                   opt, model_stats=3 if stats else False)
            loader = fm.DistributedDataLoader(
                fm.ArrayDataset((tokens[:, :-1], tokens[:, 1:])), 4, shuffle=True)
            reg = telemetry.MetricsRegistry()
            state, summary = train_loop(step, TrainState.create(lm, opt), loader,
                                        epochs=2, flush_every=4, fuse=fuse, metrics=reg)
            recs = {(m["name"], m["labels"].get("layer")): m["value"]
                    for m in reg.snapshot() if m["name"].startswith("model.")}
            return state, summary, recs

        fm.init(model_stats=3)
        mon = telemetry.CompileMonitor()
        fm.init(compileplane=mon)
        ap = AutoProfiler(str(tmp_path), seconds=0.5)
        ref, _, want = run(False, True)
        assert ap.maybe_capture("test", force=True) == str(tmp_path)
        got, summary, recs = run("window", True)
        ap.wait(60)
        plain, _, _ = run("window", False)
    finally:
        fm.shutdown()
    assert summary["fused_window"] == 4 and summary["window_compile_seconds"] > 0
    assert set(recs) == set(want) and len(want) > 8
    for key, value in want.items():
        if key[0] == "model.nonfinite":
            assert recs[key] == value == 0.0
        else:
            assert recs[key] == pytest.approx(value, rel=1e-5), key
    for name in got.params:
        assert torch.equal(got.params[name], plain.params[name]), name
        assert torch.equal(got.opt_state["mu"][name], plain.opt_state["mu"][name]), name
    assert mon.events >= 1 and mon.compile_seconds("compile") > 0
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]) == 1
    assert not torch.autograd.profiler._is_profiler_enabled


def _bn_run(device, fuse, axis_name=None, epochs=3):
    """A small Conv+BN CNN through ``train_loop`` on the card (NCCL world
    1, so the step's ``state_reduce="mean"`` all-reduces the statistics)."""
    import torch.nn.functional as F

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import CNN
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 4, 64)
    model = CNN(4, (8, 16), axis_name=axis_name, device=device)

    def loss_fn(p, ms, b):
        logits, new = model(b[0], ms, train=True)
        return F.cross_entropy(logits, b[1]), new

    opt = optim.sgd(0.1, momentum=0.9)
    loader = fm.DistributedDataLoader(fm.ArrayDataset((x, y)), 8, shuffle=True,
                                      device=device)
    state = TrainState.create(model, opt, model_state=model.init_batch_stats())
    return train_loop(make_train_step(loss_fn, opt), state, loader, epochs=epochs,
                      flush_every=4, fuse=fuse)


def test_fused_window_graph_carries_the_batchnorm_state(device):
    """BatchNorm's running statistics, averaged over the world by the step
    (C.5) and carried from window to window by the captured graph, equal
    the eager updates' bit for bit; so does ``CNN(axis_name=...)``, whose
    sync-BN all-reduce (``torch.distributed.nn``) runs inside the graph at
    world 1 over NCCL and changes no bit against the plain model."""
    import fluxmpi_tpu_torch as fm

    fm.init()
    try:
        ref, _ = _bn_run(device, False)
        got, summary = _bn_run(device, "window")
        sync, _ = _bn_run(device, "window", axis_name="dp")
    finally:
        fm.shutdown()
    assert (summary["fused_window"], summary["dispatches"]) == (4, 6)
    assert set(got.model_state) == {"bn_0.mean", "bn_0.var", "bn_1.mean", "bn_1.var"}
    for other in (got, sync):
        for k, v in ref.model_state.items():
            assert torch.equal(other.model_state[k], v), k
        for k, v in ref.params.items():
            assert torch.equal(other.params[k], v), k
    assert not torch.equal(ref.model_state["bn_0.var"], torch.ones_like(
        ref.model_state["bn_0.var"]))


def test_resnet_on_card_matches_cpu(device):
    """ResNet-50's structure (bottlenecks, the projections, the stride-2
    convs and the stem with flax's asymmetric padding) at ``num_filters`` 8
    on 64 x 64, batch 4, f32 with TF32 off: the logits, the loss,
    every gradient and the new statistics on the card (cuDNN) against the
    CPU, per leaf ``max|diff| / max|ref| <= 1e-4``."""
    import torch.nn.functional as F

    from fluxmpi_tpu_torch.models import ResNet

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    out = []
    try:
        for where in (device, torch.device("cpu")):
            model = ResNet((3, 4, 6, 3), num_classes=10, num_filters=8, device=where,
                           generator=torch.Generator().manual_seed(1))
            with torch.no_grad():  # off the zero-initialised scales
                for k, p in model.named_parameters():
                    p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                             .manual_seed(len(k))).to(where))
            logits, new = model(x.to(where), model.init_batch_stats(), train=True)
            loss = F.cross_entropy(logits, y.to(where))
            names = [k for k, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, list(model.parameters()))
            res = {k: g.cpu() for k, g in zip(names, grads)}
            res.update({k: v.cpu() for k, v in new.items()})
            res["logits"], res["loss"] = logits.detach().cpu(), loss.detach().cpu()
            out.append(res)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    card, cpu = out
    assert set(card) == set(cpu) and len(cpu) == 161 + 106 + 2
    for k, ref in cpu.items():
        err = (card[k] - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, (k, float(err))


# The zoo's attention shapes (slice 6), non-causal: ViT-B/16's 197 tokens,
# a tail in every query and key tile; the UNet's attentions over an 8x8
# grid at head dim 64, and its middle one at head dim 128 over a 4x4 grid.
ZOO_CASES = {"vit_197": dict(b=128, sq=197, sk=197, h=12, hkv=12, d=64),
             "unet_64": dict(b=64, sq=64, sk=64, h=4, hkv=4, d=64),
             "unet_mid_d128": dict(b=64, sq=16, sk=16, h=4, hkv=4, d=128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ZOO_CASES))
def test_zoo_shapes_kernels_match_plain_version(device, dtype, case):
    """The three kernels at the zoo's shapes against their plain versions,
    forward (output and lse) and backward (dQ, dK, dV), with the
    tolerances of the tests above."""
    dims = [ZOO_CASES[case][n] for n in ("b", "sq", "sk", "h", "hkv", "d")]
    q, k, v, g, _, _ = _bwd_inputs(device, dtype, *dims, seed=4)
    out, lse = fa.flash_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    dterm = ((g.float() * out.float()).sum(-1).permute(0, 2, 1)).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, None, None, g, lse, dterm)
    dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm)
    want = fa.flash_attention_bwd_reference(q, k, v, g, lse, dterm)
    torch.cuda.synchronize()
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * ref.float().abs().max().item() + 1e-6


def _padding_mask(device, b, s, lengths):
    valid = torch.arange(s, device=device)[None] < torch.as_tensor(lengths, device=device)[:, None]
    return valid[:, None, :, None] & valid[:, None, None, :]


def test_flash_attention_fn_mask_inside_a_captured_graph(device):
    """``flash_attention_fn`` with a flax padding mask captures into a CUDA
    graph (segment ids and the fidelity check on the device, no host
    read), and the replay equals the eager call; an unrepresentable mask
    under capture NaN-poisons its batch rows and leaves the others; kernel
    dropout captures too (its seed drawn on the card from a generator
    registered with the graph), and two replays drop differently."""
    fn = fa.flash_attention_fn()
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(3, 40, 4, 64, generator=gen).to(device) for _ in range(3))
    mask = _padding_mask(device, 3, 40, [40, 23, 7])
    bad = mask.clone()
    bad[1, 0, 4, 9] = False  # a hole: no segment ids rebuild it
    eager = fn(q, k, v, mask=mask)
    with pytest.raises(ValueError, match="batch rows \\[1\\]"):
        fn(q, k, v, mask=bad)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(q, k, v, mask=mask)
    torch.cuda.current_stream().wait_stream(side)
    graph, poisoned = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(q, k, v, mask=mask)
    with torch.cuda.graph(poisoned):
        out_bad = fn(q, k, v, mask=bad)
    graph.replay()
    poisoned.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.isnan(out_bad[1]).all() and not torch.isnan(out_bad[[0, 2]]).any()
    kernel_drop = fa.flash_attention_fn(dropout_impl="kernel")
    rng = torch.Generator(device=device).manual_seed(0)
    drop = dict(dropout_rate=0.1, deterministic=False, dropout_rng=rng)
    assert not torch.equal(kernel_drop(q, k, v, mask=mask, **drop), eager)  # eager
    dropped = torch.cuda.CUDAGraph()
    dropped.register_generator_state(rng)
    with torch.cuda.graph(dropped):
        out_drop = kernel_drop(q, k, v, mask=mask, **drop)
    replays = []
    for _ in range(2):
        dropped.replay()
        torch.cuda.synchronize()
        replays.append(out_drop.clone())
    assert not torch.equal(replays[0], replays[1])
    assert all(torch.isfinite(r).all() and not torch.equal(r, eager) for r in replays)


def test_ddpm_windows_draw_fresh_timesteps_bit_for_bit(device):
    """A small UNet through ``ddpm_loss`` with a CUDA generator in
    ``train_loop(fuse="window")``: the generator is registered with the
    captured graph, so every replay draws new timesteps and noise, the
    very draws of ``fuse=False``: every parameter, adam moment and flush
    loss bit-identical over 32 updates, and the updates' timesteps (kept by
    the loss in a device ring the graph replays) equal and differing from
    update to update."""
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import UNet, cosine_beta_schedule, ddpm_loss
    from fluxmpi_tpu_torch.models import unet as tunet
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    x = np.random.default_rng(0).uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    draws = tunet._ddpm_draws

    def run(fuse):
        model = UNet(base_channels=8, channel_mults=(1, 2), attn_resolutions=(4,), groups=4,
                     attention_fn=fa.flash_attention_fn(), image_size=8, device=device)
        betas = cosine_beta_schedule(1000, device=device)
        gen = torch.Generator(device=device).manual_seed(42)
        seen = torch.zeros(32, 8, dtype=torch.int64, device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)

        def keep(*a):
            t, eps = draws(*a)
            seen.index_copy_(0, count.reshape(1) % 32, t[None])
            count.add_(1)
            return t, eps

        tunet._ddpm_draws = keep
        try:
            opt = optim.adam(1e-3)
            step = make_train_step(lambda p, ms, b: (ddpm_loss(model, p, b[0], gen, betas), ms),
                                   opt)
            loader = fm.DistributedDataLoader(fm.ArrayDataset((x,)), 8, shuffle=True,
                                              device=device)
            state, summary = train_loop(step, TrainState.create(model, opt), loader,
                                        steps=32, flush_every=8, fuse=fuse)
        finally:
            tunet._ddpm_draws = draws
        return state, summary, seen.cpu(), step

    fm.init()
    try:
        ref, s_ref, t_ref, _ = run(False)
        got, s_got, t_got, step = run("window")
    finally:
        fm.shutdown()
    (prog,) = step.__fluxmpi_window_cache__.values()
    assert prog.graph is not None and prog.replays == 3 and len(prog._generators) == 1
    assert torch.equal(t_got, t_ref)
    assert len({tuple(r.tolist()) for r in t_ref}) == 32
    flush = lambda s: [(f["updates"], f["loss"], f["loss_mean"]) for f in s["flushes"]]  # noqa: E731
    assert flush(s_got) == flush(s_ref)
    for name in ref.params:
        assert torch.equal(got.params[name], ref.params[name]), name
        for m in ("mu", "nu"):
            assert torch.equal(got.opt_state[m][name], ref.opt_state[m][name]), (m, name)


NCCL_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    dev = fm.init()  # RANK, WORLD_SIZE, LOCAL_RANK, MASTER_* from the launcher
    rank, world = fm.local_rank(), fm.total_workers()
    res = {"device": dev.index, "world": world,
           "allreduce": fm.allreduce(torch.full((3,), rank + 1.0, device=dev))}
    model = fm.synchronize(MLP(device=dev, generator=torch.Generator().manual_seed(100 + rank)))
    X = np.random.default_rng(0).uniform(-2, 2, (16 * world, 1)).astype(np.float32)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((X, X ** 2))),
        global_batch_size=16 * world)
    (xb, yb), = list(loader)

    def loss_fn(p, ms, batch):
        return ((model(batch[0]) - batch[1]) ** 2).mean(), ms

    opt = optim.sgd(0.1, momentum=0.9)
    state, res["loss"] = make_train_step(loss_fn, opt)(TrainState.create(model, opt), (xb, yb))
    for name, p in model.named_parameters():
        res["param/" + name] = p

    # Sync-BN and the statistics' all-reduce across the cards: this rank's
    # share of a batch of 4 per card (f32, TF32 off).
    import torch.nn.functional as F
    from fluxmpi_tpu_torch.models import CNN

    torch.backends.cudnn.allow_tf32 = False
    images = np.random.default_rng(1).normal(size=(4 * world, 8, 8, 3)).astype(np.float32)
    labels = np.arange(4 * world) % 4
    cnn = fm.synchronize(CNN(4, (4, 8), axis_name="dp", device=dev,
                             generator=torch.Generator().manual_seed(100 + rank)))

    def bn_loss(p, ms, batch):
        logits, new = cnn(batch[0], ms, train=True)
        return F.cross_entropy(logits, batch[1]), new

    share = slice(4 * rank, 4 * rank + 4)
    opt = optim.sgd(0.1)
    state, res["bn_loss"] = make_train_step(bn_loss, opt)(
        TrainState.create(cnn, opt, model_state=cnn.init_batch_stats()),
        (torch.from_numpy(images[share]).to(dev), torch.from_numpy(labels[share]).to(dev)))
    for name, p in cnn.named_parameters():
        res["bn_param/" + name] = p
    for name, v in state.model_state.items():
        res["bn_stats/" + name] = v
    np.savez(sys.argv[1], **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                             for k, v in res.items()})
    fm.shutdown()
''')


def test_nccl_data_parallel_step_matches_single_process(tmp_path):
    """One worker per card over NCCL, brought up from the launcher's
    environment as ``torchrun`` sets it: the ranks bind their own cards,
    the collectives reduce across them, and one step on the shards equals
    the single-process step on the global batch (f32 on the cards against
    f32 on the CPU, a 16-wide MLP: atol 1e-5); so does one step of a
    Conv+BN CNN with sync-BN (``axis_name``) and the step's statistics
    all-reduce (its loss, parameters and running statistics; TF32 off,
    atol 1e-5)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    world = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", NCCL_WORKER, str(tmp_path / f"rank{rank}.npz")],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    X = np.random.default_rng(0).uniform(-2, 2, (16 * world, 1)).astype(np.float32)
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    model = MLP(device="cpu", generator=torch.Generator().manual_seed(100))

    def loss_fn(p, ms, batch):
        return ((model(batch[0]) - batch[1]) ** 2).mean(), ms

    opt = optim.sgd(0.1, momentum=0.9)
    x, y = torch.from_numpy(X), torch.from_numpy(X ** 2)
    _, loss = make_train_step(loss_fn, opt, grad_reduce=None)(
        TrainState.create(model, opt), (x, y))
    for rank in range(world):
        r = np.load(tmp_path / f"rank{rank}.npz")
        assert int(r["device"]) == rank and int(r["world"]) == world
        np.testing.assert_array_equal(r["allreduce"], np.full(3, world * (world + 1) / 2))
        np.testing.assert_allclose(float(r["loss"]), loss.item(), atol=1e-5, rtol=0)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["param/" + name], p.detach().numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)

    # Sync-BN over the cards = one process on the whole batch (no axis).
    import torch.nn.functional as F
    from fluxmpi_tpu_torch.models import CNN

    images = np.random.default_rng(1).normal(size=(4 * world, 8, 8, 3)).astype(np.float32)
    labels = torch.from_numpy(np.arange(4 * world) % 4)
    cnn = CNN(4, (4, 8), device="cpu", generator=torch.Generator().manual_seed(100))

    def bn_loss(p, ms, batch):
        logits, new = cnn(batch[0], ms, train=True)
        return F.cross_entropy(logits, batch[1]), new

    state, bn_loss_ref = make_train_step(bn_loss, optim.sgd(0.1), grad_reduce=None)(
        TrainState.create(cnn, optim.sgd(0.1), model_state=cnn.init_batch_stats()),
        (torch.from_numpy(images), labels))
    for rank in range(world):
        r = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(float(r["bn_loss"]), bn_loss_ref.item(), atol=1e-5, rtol=0)
        for name, p in cnn.named_parameters():
            np.testing.assert_allclose(r["bn_param/" + name], p.detach().numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
        for name, v in state.model_state.items():
            np.testing.assert_allclose(r["bn_stats/" + name], v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)


AUTOTUNE_WORKER = textwrap.dedent('''
    import json
    import sys

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    import fluxmpi_tpu_torch.parallel.autotune  # noqa: F401
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState, make_train_step,
                                            train_loop)

    at = sys.modules["fluxmpi_tpu_torch.parallel.autotune"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = fm.init(parallel="auto")  # RANK, WORLD_SIZE, LOCAL_RANK, MASTER_* from the launcher
    world = fm.total_workers()
    # GPT-2 small's widths with its padded vocabulary (50304 divides by 4).
    cfg = dict(vocab_size=50304, max_len=1024, num_layers=12, d_model=768,
               num_heads=12, d_ff=3072, ln_eps=1e-5)
    model = TransformerLM(**cfg, attention="flash", device=dev,
                          generator=torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    tokens = np.random.default_rng(0).integers(0, cfg["vocab_size"], (64, 1025))
    sample = (tokens[:32, :-1], tokens[:32, 1:])

    def loss_fn(p, ms, batch):
        out = torch.func.functional_call(model, p, (batch[0],), {"targets": batch[1]})
        return out.mean(), ms

    res = at.autotune(loss_fn, optim.adamw(3e-4), model, sample, trials=16, force=True)
    real = at._run_trial

    def boom(*a, **k):
        raise AssertionError("a trial ran on a bank hit")

    at._run_trial = boom
    hit = at.autotune(loss_fn, optim.adamw(3e-4), model, sample, trials=16)
    at._run_trial = real

    def train(plan):
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(start[k])
        opt = optim.adamw(3e-4)
        state = TrainState.create(model, opt)
        if plan.shards_parameters:
            state, _ = plan.shard_state(state)
        step = make_train_step(loss_fn, opt, parallel=plan)
        axes = plan.data_axes
        loader = fm.DistributedDataLoader(
            fm.ArrayDataset((tokens[:, :-1], tokens[:, 1:])), 32, mesh=plan.mesh,
            axis_name=axes[0] if len(axes) == 1 else list(axes))
        _, summary = train_loop(step, state, loader, steps=8, flush_every=1, fuse=False)
        return [f["loss"] for f in summary["flushes"]]

    winner = fm.global_plan()
    out = dict(record=res.record, bank_hit=hit.from_bank,
               winner_installed=winner is hit.plan, auto=train(winner),
               dp=train(ParallelConfig(dp=world).resolve()),
               card=torch.cuda.get_device_name(dev))

    # tp over every card, whatever won: the kernels' heads per update (the
    # first update gathers, the next run on this card's heads) and their
    # launches by the device counters.
    import importlib

    from fluxmpi_tpu_torch.ops import device_launches

    fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
    heads = []
    kernel = fa.flash_fwd

    def seen(q, *a, **k):
        heads.append(q.shape[2])
        return kernel(q, *a, **k)

    seen.launches = 0
    fa.flash_fwd = seen
    device_launches(reset=True)
    out["tp"] = train(ParallelConfig(tp=world).resolve())
    out["tp_launches"] = device_launches()
    fa.flash_fwd = kernel
    out["tp_heads"] = heads
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    fm.shutdown()
''')


def test_nccl_autotune_searches_four_cards_and_trains_the_winner(tmp_path):
    """The layout search on four cards over NCCL, one worker per card:
    GPT-2 small's widths (vocabulary 50304, f32, TF32 off,
    ``attention="flash"``, adamw, a global batch of 32 x 1024): every
    dp x fsdp x tp factorization of 4 is a candidate and scored, every
    candidate is trialed (the budget covers them), every rank ends with the
    same winner, the second search is answered by the bank, and the winner
    trains 8 updates through ``make_train_step(parallel="auto")`` with the
    losses of the same updates under ``ParallelConfig(dp=4)`` within 2e-5;
    so does ``ParallelConfig(tp=4)``, whose attention runs 3 of the 12
    heads on each card from its second update on (12 launches of each
    kernel per update by the device counters). Prints the candidate table
    (memory, score, examples/s per trial)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    world = 4
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", AUTOTUNE_WORKER, str(tmp_path / f"rank{rank}.json")],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    import json

    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    rec = ranks[0]["record"]
    axes = [tuple(c["axes"][a] for a in ("dp", "fsdp", "tp")) for c in rec["candidates"]]
    assert axes == [(4, 1, 1), (2, 2, 1), (2, 1, 2), (1, 4, 1), (1, 2, 2), (1, 1, 4)]
    print(f"\nautotune on {world} x {ranks[0]['card']}: winner {rec['winner']['axes']}")
    for c in rec["candidates"]:
        trial = c["trial"] or {}
        print(f"  {c['axes']}: {c['mem_bytes_per_device']} bytes/device, flops "
              f"{c['flops']}, bytes {c['bytes_accessed']}, score {c['score']}, "
              f"{trial.get('examples_per_sec')} examples/s "
              f"({trial.get('updates')} updates, {trial.get('seconds')} s)")
        assert c["score"] is not None and c["pruned"] is None
        assert trial["examples_per_sec"] > 0 and trial["steady_compiles"] == 0
    for res in ranks:
        assert res["record"]["winner"] == rec["winner"]
        assert res["bank_hit"] and res["winner_installed"]
        assert res["auto"] == ranks[0]["auto"] and len(res["auto"]) == 8
        np.testing.assert_allclose(res["auto"], res["dp"], atol=2e-5, rtol=0)
        # Under tp=4 each card's attention runs 3 of the 12 heads from the
        # second update on, 12 launches of each kernel per update.
        np.testing.assert_allclose(res["tp"], res["dp"], atol=2e-5, rtol=0)
        assert res["tp_heads"] == [12] * 12 + [3] * 84
        assert res["tp_launches"] == {k: 96 for k in ("flash_fwd", "flash_bwd_dq",
                                                      "flash_bwd_dkv")}


RESIZE_WORKER = textwrap.dedent(r'''
    import json
    import math
    import os
    import sys
    import time

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.fleet import resize
    from fluxmpi_tpu_torch.utils.manifest import global_shape
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState, make_train_step,
                                            train_loop)
    from fluxmpi_tpu_torch.utils import CheckpointManager

    out, ckpt_dir, bank, phase = sys.argv[1:5]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    dev = fm.init(parallel=ParallelConfig(fsdp=world),
                  resize=bank if phase != "ref" else None)
    rank = fm.local_rank()
    plan = fm.global_plan()
    cfg = dict(vocab_size=50304, max_len=1024, num_layers=12, d_model=768,
               num_heads=12, d_ff=3072, ln_eps=1e-5)
    model = TransformerLM(**cfg, attention="flash", device=dev,
                          generator=torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg["vocab_size"], (128, 1025))
    ids = np.arange(128, dtype=np.int32)
    consumed = []
    calls = [0]

    def loss_fn(p, ms, batch):
        x, y, rows = batch
        consumed.append(rows.tolist())  # the ids this update consumed
        calls[0] += 1
        if phase == "drain" and rank == 0 and calls[0] == 3:
            resize.request_resize(2, reason="four-to-two")
        out = torch.func.functional_call(model, p, (x,), {"targets": y})
        return out.mean(), ms

    opt = optim.adamw(3e-4)
    state, _ = plan.shard_state(TrainState.create(model, opt))
    step = make_train_step(loss_fn, opt, parallel=plan)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((tokens[:, :-1], tokens[:, 1:], ids))),
        16, elastic_order=True, shuffle=True, seed=7)
    res = dict(card=torch.cuda.get_device_name(dev))
    kw = {}
    if phase != "ref":
        mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
        blocking = []
        save = mgr.save

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            save(*a, **k)
            blocking.append(time.perf_counter() - t0)

        mgr.save = timed_save
        kw = dict(checkpoint=mgr, save_every=100, resume=phase == "resume")
    state, summary = train_loop(step, state, loader, epochs=1, flush_every=2, fuse=False,
                                **kw)
    res.update(updates=summary["updates"], resized_to=summary["resized_to"],
               resumed_from=summary["resumed_from"], loss=summary["loss"],
               consumed=consumed)
    if phase != "ref":
        mgr.close()
        res.update(blocking_seconds=blocking, background_seconds=mgr.write_seconds,
                   phase_seconds=resize.get_resize_coordinator().phase_seconds(),
                   state_bytes=sum(math.prod(global_shape(t)) * t.element_size()
                                   for t in [*state.params.values(),
                                             *state.opt_state["mu"].values(),
                                             *state.opt_state["nu"].values()]))
    with open(out, "w") as f:
        json.dump(res, f)
    fm.shutdown()
''')


def _launch_world(tmp_path, script, world, args, tag):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(tmp_path / f"{tag}{rank}.json"), *args],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    import json

    return [json.loads((tmp_path / f"{tag}{r}.json").read_text()) for r in range(world)]


def test_nccl_resize_four_to_two_is_sample_exact(tmp_path):
    """A live resize from four cards to two over NCCL: GPT-2 small's widths
    (vocabulary 50304, f32, TF32 off, ``attention="flash"``, adamw) under
    ``ParallelConfig(fsdp=4)``, the ``elastic_order`` loader at a global
    batch of 16 x 1024 over 128 sequences, ``flush_every=2``. A request on
    rank 0 drains the four-card world at a flush boundary (update 4); each
    worker writes its ``shard_<rank>.pt``, about a quarter of the state's
    bytes; a two-card world under ``ParallelConfig(fsdp=2)`` resumes from
    the manifest's specs and finishes the epoch. The ids both worlds
    consumed are the uninterrupted four-card run's (as a multiset, and
    batch by batch), the final loss is its within ``rtol=5e-3``, and one
    valid record from 4 to 2 workers is banked. Prints the save's blocking
    and background seconds and the record's phase seconds."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    import json

    from fluxmpi_tpu_torch.telemetry.schema import validate_resize_record

    ckpt, bank = str(tmp_path / "ckpt"), str(tmp_path / "bank.jsonl")
    ref = _launch_world(tmp_path, RESIZE_WORKER, 4, [ckpt + "_ref", bank, "ref"], "ref")
    four = _launch_world(tmp_path, RESIZE_WORKER, 4, [ckpt, bank, "drain"], "drain")
    sizes = [os.path.getsize(os.path.join(ckpt, f"step_{4:08d}", f"shard_{r}.pt"))
             for r in range(4)]
    two = _launch_world(tmp_path, RESIZE_WORKER, 2, [ckpt, bank, "resume"], "resume")
    total = four[0]["state_bytes"]
    print(f"\nresize 4 -> 2 on {ref[0]['card']}: shard bytes {sizes} of a {total}-byte "
          f"state; blocking save seconds {[r['blocking_seconds'] for r in four]}; "
          f"background {[r['background_seconds'] for r in four]}; drain-world phases "
          f"{four[0]['phase_seconds']}; resumed-world phases {two[0]['phase_seconds']}; "
          f"final loss {two[0]['loss']} vs uninterrupted {ref[0]['loss']}")
    assert all(r["updates"] == 8 and r["resized_to"] is None for r in ref)
    assert all(r["updates"] == 4 and r["resized_to"] == 2 for r in four)
    assert all(r["resumed_from"] == 4 and r["updates"] == 8 for r in two)
    assert all(0.2 < s / total < 0.35 for s in sizes), (sizes, total)
    want = [sum((r["consumed"][u] for r in ref), []) for u in range(8)]
    got = ([sum((r["consumed"][u] for r in four), []) for u in range(4)]
           + [sum((r["consumed"][u] for r in two), []) for u in range(4)])
    assert sorted(i for b in got for i in b) == sorted(i for b in want for i in b)
    assert [sorted(b) for b in got] == [sorted(b) for b in want]
    np.testing.assert_allclose(two[0]["loss"], ref[0]["loss"], rtol=5e-3)
    with open(bank) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert len(records) == 1 and validate_resize_record(records[0]) == []
    assert (records[0]["from_processes"], records[0]["to_processes"]) == (4, 2)
    print(f"record: {json.dumps(records[0])}")
