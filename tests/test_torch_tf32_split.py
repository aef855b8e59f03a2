"""The arithmetic of the f32 flash kernels' tensor-core products, emulated
on the CPU: ``csrc/flash_mma.cuh`` runs every f32 product as three TF32
products, ``a * b ~ hi_a * hi_b + hi_a * lo_b + lo_a * hi_b`` with ``hi =
tf32(x)`` and ``lo = tf32(x - hi)``, each rounded to nearest with ties away
from zero (``cvt.rna.tf32.f32``: 10 mantissa bits).

The emulation rounds with integer arithmetic on the f32 bits and runs the
products as f32 matmuls (a product of two TF32 values is exact in f32, the
sums are f32 as on the tensor cores). The causal forward, the dQ formula
and the dK/dV formulas (in the dK/dV kernel's transposed order) through the
split are held to the port's plain versions in f64 within the card's f32
tolerances (2e-5 absolute on the output, 1e-4 of max|dQ|, max|dK| and
max|dV| on the gradients), and a single TF32 product is shown to be at
least 10x worse and outside those tolerances: the reason for the split.
"""

import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")

OUT_TOL = 2e-5
DQ_TOL = 1e-4


def tf32(x):
    """Round f32 ``x`` to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_split(a, b, terms):
    """``a @ b`` in f32 from TF32 operands: ``terms=3`` the kernels' split
    (the two small products first, then the large one), ``terms=1`` one
    TF32 product."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d))) for _ in range(4))
    return q, k, v, g


def _causal(s):
    return torch.tril(torch.ones(s, s, dtype=torch.bool))


def forward_split(q, k, v, terms):
    """Causal attention with both products through the TF32 emulation;
    softmax in f32. ``[b, s, h, d]`` in, ``(out, lse)`` out."""
    d = q.shape[-1]
    qt, kt, vt = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = matmul_split(qt, kt.transpose(-1, -2), terms) * (d ** -0.5)
    s = torch.where(_causal(q.shape[1]), s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = matmul_split(p, vt, terms) / l
    return out.permute(0, 2, 1, 3), (m + torch.log(l))[..., 0]


def dq_split(q, k, v, g, lse, dterm, terms):
    """The dQ kernel's formula with its three products through the TF32
    emulation: p = exp(s - lse), ds = p * (dO V^T - dterm) / sqrt(d),
    dQ = ds K."""
    d = q.shape[-1]
    qt, kt, vt, gt = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, g))
    s = matmul_split(qt, kt.transpose(-1, -2), terms) * (d ** -0.5)
    live = _causal(q.shape[1])
    p = torch.exp(torch.where(live, s - lse.float()[..., None], tfa.NEG_INF))
    dp = matmul_split(gt, vt.transpose(-1, -2), terms)
    ds = p * (dp - dterm.float()[..., None]) * (d ** -0.5)
    return matmul_split(ds, kt, terms).permute(0, 2, 1, 3)


def dkv_split(q, k, v, g, lse, dterm, terms):
    """The dK/dV kernel's formulas, transposed as the kernel runs them (key
    rows are the MMA rows), with its four products through the TF32
    emulation: S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T / sqrt(d) - lse),
    dS^T = P^T * (dP^T - dterm) / sqrt(d), dV = P^T dO, dK = dS^T Q."""
    d = q.shape[-1]
    qt, kt, vt, gt = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, g))
    st = matmul_split(kt, qt.transpose(-1, -2), terms) * (d ** -0.5)
    live = _causal(q.shape[1]).T  # [key, query]: query >= key
    pt = torch.exp(torch.where(live, st - lse.float()[..., None, :], tfa.NEG_INF))
    dpt = matmul_split(vt, gt.transpose(-1, -2), terms)
    dst = pt * (dpt - dterm.float()[..., None, :]) * (d ** -0.5)
    dv = matmul_split(pt, gt, terms)
    dk = matmul_split(dst, qt, terms)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


CASES = [
    dict(seed=0, b=1, s=128, h=2, d=64),
    dict(seed=1, b=2, s=96, h=2, d=40),
    dict(seed=2, b=1, s=80, h=1, d=128),
]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      3.14159265], dtype=torch.float32)
    got = tf32(x)
    # Ties go away from zero; the rest to nearest; the low 13 bits are zero.
    assert got[:4].tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10)]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[4].item() - 3.14159265) <= 2.0 ** -10
    hi, lo = split(x)
    assert ((hi.double() + lo.double()) - x.double()).abs().max().item() <= 2.0 ** -21


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_forward_within_f32_tolerance(case):
    q, k, v, _ = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert ref_out.dtype == torch.float64
    out, lse = forward_split(q, k, v, terms=3)
    err = (out.double() - ref_out).abs().max().item()
    assert err <= OUT_TOL
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-4
    err_1 = (forward_split(q, k, v, terms=1)[0].double() - ref_out).abs().max().item()
    assert err_1 >= 10 * err


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_dq_within_f32_tolerance(case):
    q, k, v, g = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    out, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    dterm = (g * out).sum(-1).permute(0, 2, 1)
    ref_dq = tfa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, causal=True)[0]
    assert ref_dq.dtype == torch.float64
    scale = ref_dq.abs().max().item()
    err = (dq_split(q, k, v, g, lse, dterm, terms=3).double() - ref_dq).abs().max().item()
    assert err <= DQ_TOL * scale
    err_1 = (dq_split(q, k, v, g, lse, dterm, terms=1).double() - ref_dq).abs().max().item()
    assert err_1 >= 10 * err


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['s']}_d{c['d']}")
def test_split_dkv_within_f32_tolerance(case):
    q, k, v, g = _inputs(case["seed"], case["b"], case["s"], case["h"], case["d"])
    out, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    dterm = (g * out).sum(-1).permute(0, 2, 1)
    _, ref_dk, ref_dv = tfa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, causal=True)
    assert ref_dk.dtype == ref_dv.dtype == torch.float64
    got = dkv_split(q, k, v, g, lse, dterm, terms=3)
    got_1 = dkv_split(q, k, v, g, lse, dterm, terms=1)
    for ref, split3, split1 in zip((ref_dk, ref_dv), got, got_1):
        err = (split3.double() - ref).abs().max().item()
        assert err <= DQ_TOL * ref.abs().max().item()
        assert (split1.double() - ref).abs().max().item() >= 10 * err


def test_single_tf32_product_misses_the_f32_tolerances():
    """At the training head width one TF32 product per f32 product is
    outside both tolerances that the split meets."""
    q, k, v, g = _inputs(3, 1, 256, 2, 64)
    ref_out, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert (forward_split(q, k, v, terms=1)[0].double() - ref_out).abs().max().item() > OUT_TOL
    dterm = (g * ref_out).sum(-1).permute(0, 2, 1)
    ref_dq = tfa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, causal=True)[0]
    err_1 = (dq_split(q, k, v, g, lse, dterm, terms=1).double() - ref_dq).abs().max().item()
    assert err_1 > DQ_TOL * ref_dq.abs().max().item()
