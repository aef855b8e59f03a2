"""The arithmetic of the bf16 flash kernels' value products, emulated on
the CPU. The JAX package's kernels form ``P . V`` (forward), ``dS . K``
(dQ) and ``P_drop^T . dO``, ``dS^T . Q`` (dK/dV) from f32 ``p`` and
``ds``; a bf16 tensor-core product takes bf16 operands, so
``csrc/flash_mma.cuh`` splits the f32 operand, ``x ~ hi + lo`` with ``hi =
bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest even), and issues two
bf16 products into one f32 accumulator, the small one first. The other
operand is a bf16 input, exact.

The emulation runs each product as an f32 matmul of bf16 values (a product
of two bf16 values is exact in f32; the sums are f32, as on the tensor
cores) and the score products from the bf16 inputs the same way. On bf16
inputs, the causal forward (before its output's bf16 rounding), the dQ
formula and the dK/dV formulas (in the dK/dV kernel's transposed order)
through the split are held to the port's plain versions in f64 within the
f32 kernels' tolerances (2e-5 absolute on the output, 1e-4 of max|dQ|,
max|dK| and max|dV|), and one bf16 product (the operand rounded to bf16,
as the kernels did before the split) is shown to be at least 10x worse and
outside those tolerances. The kernels' shared header is read to hold that
the emulated arithmetic is the one its bf16 value product issues.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
torch.set_num_threads(1)
CSRC = Path(tfa.__file__).resolve().parent / "csrc"

OUT_TOL = 2e-5
DQ_TOL = 1e-4


def bf16(x):
    return x.to(torch.bfloat16).float()


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def value_product(a, b, terms):
    """``a @ b`` for f32 ``a`` and bf16-valued ``b``: ``terms=2`` the
    kernels' split (small product first), ``terms=1`` one bf16 product."""
    hi, lo = split(a.float())
    if terms == 1:
        return hi @ b
    return lo @ b + hi @ b


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return tuple(bf16(torch.from_numpy(rng.standard_normal((b, s, h, d))).float())
                 .double() for _ in range(4))


def _causal(s):
    return torch.tril(torch.ones(s, s, dtype=torch.bool))


def _heads(*xs):
    return tuple(x.float().permute(0, 2, 1, 3) for x in xs)


def forward_split(q, k, v, terms):
    """Causal attention, scores from the bf16 inputs in f32, P . V through
    the emulation; ``(out, lse)`` with ``out`` f32 (before the kernel's
    bf16 output rounding)."""
    d = q.shape[-1]
    qt, kt, vt = _heads(q, k, v)
    s = (qt @ kt.transpose(-1, -2)) * (d ** -0.5)
    s = torch.where(_causal(q.shape[1]), s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = value_product(p, vt, terms) / l
    return out.permute(0, 2, 1, 3), (m + torch.log(l))[..., 0]


def dq_split(q, k, v, g, lse, dterm, terms):
    """The dQ kernel's formula: p = exp(s - lse), ds = p * (dO V^T -
    dterm) / sqrt(d), dQ = ds K with dS through the emulation."""
    d = q.shape[-1]
    qt, kt, vt, gt = _heads(q, k, v, g)
    s = (qt @ kt.transpose(-1, -2)) * (d ** -0.5)
    live = _causal(q.shape[1])
    p = torch.exp(torch.where(live, s - lse.float()[..., None], tfa.NEG_INF))
    dp = gt @ vt.transpose(-1, -2)
    ds = p * (dp - dterm.float()[..., None]) * (d ** -0.5)
    return value_product(ds, kt, terms).permute(0, 2, 1, 3)


def dkv_split(q, k, v, g, lse, dterm, terms):
    """The dK/dV kernel's formulas, transposed (key rows are the MMA
    rows): P^T = exp(K Q^T / sqrt(d) - lse), dS^T = P^T * (V dO^T -
    dterm) / sqrt(d), dV = P^T dO, dK = dS^T Q, with P^T and dS^T through
    the emulation."""
    d = q.shape[-1]
    qt, kt, vt, gt = _heads(q, k, v, g)
    st = (kt @ qt.transpose(-1, -2)) * (d ** -0.5)
    live = _causal(q.shape[1]).T  # [key, query]: query >= key
    pt = torch.exp(torch.where(live, st - lse.float()[..., None, :], tfa.NEG_INF))
    dpt = vt @ gt.transpose(-1, -2)
    dst = pt * (dpt - dterm.float()[..., None, :]) * (d ** -0.5)
    dv = value_product(pt, gt, terms)
    dk = value_product(dst, qt, terms)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


CASES = [
    dict(seed=0, b=1, s=128, h=2, d=64),
    dict(seed=1, b=2, s=96, h=2, d=40),
    dict(seed=2, b=1, s=80, h=1, d=128),
]


def _grad_refs(q, k, v, g):
    out, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    dterm = (g * out).sum(-1).permute(0, 2, 1)
    return lse, dterm, tfa.flash_attention_bwd_reference(q, k, v, g, lse, dterm,
                                                         causal=True)


def test_bf16_split_keeps_sixteen_bits():
    x = torch.tensor([1.0 + 2.0 ** -9 + 2.0 ** -17, 0.3, -2.0 ** -20, 7.123456],
                     dtype=torch.float32)
    hi, lo = split(x)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0xFFFF).eq(0).all()
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -16
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max().item() > 2.0 ** -16


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_forward_within_f32_tolerance(case):
    q, k, v, _ = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert ref_out.dtype == torch.float64
    out, lse = forward_split(q, k, v, terms=2)
    err = (out.double() - ref_out).abs().max().item()
    assert err <= OUT_TOL
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-4
    err_1 = (forward_split(q, k, v, terms=1)[0].double() - ref_out).abs().max().item()
    assert err_1 > OUT_TOL and err_1 >= 10 * err


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_dq_within_f32_tolerance(case):
    q, k, v, g = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    lse, dterm, (ref_dq, _, _) = _grad_refs(q, k, v, g)
    scale = ref_dq.abs().max().item()
    err = (dq_split(q, k, v, g, lse, dterm, terms=2).double() - ref_dq).abs().max().item()
    assert err <= DQ_TOL * scale
    err_1 = (dq_split(q, k, v, g, lse, dterm, terms=1).double() - ref_dq).abs().max().item()
    assert err_1 > DQ_TOL * scale and err_1 >= 10 * err


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_dkv_within_f32_tolerance(case):
    q, k, v, g = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    lse, dterm, (_, ref_dk, ref_dv) = _grad_refs(q, k, v, g)
    got = dkv_split(q, k, v, g, lse, dterm, terms=2)
    got_1 = dkv_split(q, k, v, g, lse, dterm, terms=1)
    for ref, split2, split1 in zip((ref_dk, ref_dv), got, got_1):
        scale = ref.abs().max().item()
        err = (split2.double() - ref).abs().max().item()
        assert err <= DQ_TOL * scale
        err_1 = (split1.double() - ref).abs().max().item()
        assert err_1 > DQ_TOL * scale and err_1 >= 10 * err


def test_kernel_source_issues_the_split():
    """``flash_mma.cuh``'s bf16 ``value_product`` (P . V, dS . K, P^T . dO,
    dS^T . Q in all three kernels) splits its f32 operand with
    ``split_bf16`` and issues the lo product before the hi product into
    the same accumulator, for both accumulator tiles of each B fragment;
    no fragment of P or dS is packed to bf16 alone."""
    src = (CSRC / "flash_mma.cuh").read_text()
    body = re.search(r"void value_product\([^{]*?const __nv_bfloat16\* b_s, int lane\) \{"
                     r"(.*?)\n\}", src, re.S).group(1)
    assert "pack_bf16(p[" not in body
    assert body.count("split_bf16(p[") == 4
    issued = re.findall(r"mma_bf16\(o\[(n(?: \+ 1)?)\], (a[hl]), (b(?: \+ 2)?)\);", body)
    assert issued == [("n", "al", "b"), ("n + 1", "al", "b + 2"),
                      ("n", "ah", "b"), ("n + 1", "ah", "b + 2")]
    split = re.search(r"void split_bf16\(.*?\n\}", src, re.S).group(0)
    assert "__floats2bfloat162_rn(x0, x1)" in split
    assert "pack_bf16(x0 - __low2float(h), x1 - __high2float(h))" in split
