"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of :mod:`fluxmpi_tpu.ops.flash_attention`. Inputs are
``(batch, seq, heads, head_dim)``; the scale is ``1/sqrt(head_dim)``;
scores, the running max and sum, the accumulators and every gradient sum
are f32 whatever the input dtype; outputs and gradients come back in the
inputs' dtypes and the per-row logsumexp ``lse`` as f32 ``[batch, heads,
q_seq]``.

Masking: ``causal`` (``q_pos >= k_pos``), a sliding ``window``
(``q_pos - k_pos < window``; band only when ``causal=False``, reachable
through :func:`flash_attention_with_lse`), and integer segment ids: a pair
attends iff ``q_seg == kv_seg`` and ``kv_seg != 0`` (id 0 is padding). A
row with no attendable key outputs zeros and ``lse = -1e30``. Grouped-query
attention: ``k``/``v`` may carry ``h_kv`` heads with ``h % h_kv == 0``.

Dropout (``dropout_rate > 0`` with a ``dropout_seed``): the normalized
probabilities on the value path are dropped and rescaled by
``1/keep_prob``, the softmax sum is not; the keep mask is the JAX
package's counter-based murmur3 hash of ``(seed, b*h + head, q_pos,
k_pos)`` (:func:`dropout_keep_reference`), so the port and the TPU
kernels drop the same entries. The seed is an ``int`` or a one-element
integer tensor holding a uint32; the kernels read it from device memory
(as the JAX kernels read a ``[1, 128]`` uint32 operand), so a seed drawn on
the card needs no host read and a CUDA graph that captured the call drops
afresh whenever the seed's buffer changes.

:func:`flash_attention_fn` is the ``attention_fn`` drop-in for the
models' multi-head attention (flax's call: ``fn(query, key, value,
bias=None, mask=None, **kwargs)``): it turns a flax boolean mask into
segment ids on the device and checks that they rebuild it.

Differentiation is a :class:`torch.autograd.Function` over ``(out,
lse)`` with the recompute-based two-pass backward of the JAX package:
``dterm = rowsum(dO * O) - dlse`` in plain torch, then one kernel for dQ
and one for dK/dV. On CUDA tensors the wrappers :func:`flash_fwd`,
:func:`flash_bwd_dq` and :func:`flash_bwd_dkv` launch the kernels of
``csrc/`` (or raise); on CPU tensors the plain versions
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
run. There is no fallback between the two. Each wrapper's ``launches``
counts its calls that launched the kernel; :func:`device_launches` reads
the launches the device itself ran, CUDA-graph replays included.
"""

from __future__ import annotations

import torch

from ..utils.flops import attention_flops, kernel_flops

__all__ = [
    "device_launches",
    "dropout_keep_reference",
    "dropout_threshold",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_fn",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_fwd",
    "padding_to_segment_ids",
]

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def padding_to_segment_ids(valid: torch.Tensor) -> torch.Tensor:
    """Boolean validity mask ``[batch, seq]`` (True = real token) → segment
    ids for ``segment_ids=``: valid → 1, pad → 0."""
    return torch.as_tensor(valid).to(torch.int32)


def _check_window(window, causal: bool, allow_band: bool = False):
    if window is None:
        return None
    if not causal:
        if not allow_band:
            raise ValueError(
                "window (sliding-window attention) requires causal=True"
            )
        return int(window)
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return window


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (batch, seq, heads, head_dim)")
    b, _, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k shape {tuple(k.shape)} does not fit q shape "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(
            f"query head count {h} must be a multiple of the kv head count "
            f"{k.shape[2]} (grouped-query attention)"
        )


def _normalize_segments(segment_ids, b: int, sq: int, sk: int, device):
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        if len(segment_ids) != 2:
            raise ValueError(
                "segment_ids must be one [batch, seq] tensor (shared q/kv) "
                "or a (q_seg, kv_seg) pair"
            )
        qseg, kseg = segment_ids
    else:
        if sq != sk:
            raise ValueError(
                "a single segment_ids tensor requires q/k sequence lengths "
                f"to match (got {sq} vs {sk}); pass (q_seg, kv_seg)"
            )
        qseg = kseg = segment_ids
    qseg = torch.as_tensor(qseg, device=device).to(torch.int32).contiguous()
    kseg = torch.as_tensor(kseg, device=device).to(torch.int32).contiguous()
    if tuple(qseg.shape) != (b, sq):
        raise ValueError(
            f"q segment_ids shape {tuple(qseg.shape)} != (batch, q_seq) = "
            f"{(b, sq)}"
        )
    if tuple(kseg.shape) != (b, sk):
        raise ValueError(
            f"kv segment_ids shape {tuple(kseg.shape)} != (batch, kv_seq) = "
            f"{(b, sk)}"
        )
    return qseg, kseg


def _is_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def dropout_threshold(keep_prob: float) -> int:
    """The uint32 keep threshold, in double precision on the host exactly
    as the JAX package computes it: keep iff hash bits < threshold."""
    return min(int(keep_prob * 4294967296.0), 4294967295)


_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` without
    leaving int64: the product is split at 16 bits of ``x``."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _hash_mix(h, k):
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl32(k, 15)
    k = _mul32(k, 0x1B873593)
    h = h ^ k
    h = _rotl32(h, 13)
    return (_mul32(h, 5) + 0xE6546B64) & _MASK32


def _hash_final(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_keep_reference(seed, bh, q_pos, k_pos, keep_prob: float):
    """The dropout keep mask (True = keep) of the JAX package's
    ``_dropout_keep``: murmur3 rounds over ``(seed, bh, q_pos, k_pos)``
    and the finalizer, in int64 arithmetic masked to 32 bits. ``seed`` is
    an int or a one-element integer tensor (its low 32 bits; read on its
    device); ``bh``, ``q_pos`` and ``k_pos`` are integer tensors (or ints)
    that broadcast."""
    as64 = lambda x: torch.as_tensor(x, dtype=torch.int64) & _MASK32  # noqa: E731
    seed = (seed.to(torch.int64).reshape(()) if torch.is_tensor(seed)
            else int(seed))
    h = _hash_mix(as64(seed), as64(bh))
    h = _hash_mix(h, as64(q_pos))
    h = _hash_mix(h, as64(k_pos))
    return _hash_final(h) < dropout_threshold(keep_prob)


def _keep_mask(b, h, sq, sk, seed, keep_prob, device):
    """``[b, h, sq, sk]`` keep mask, the hash keyed by the folded query
    row ``b_idx * h + head``."""
    bh = torch.arange(b * h, device=device).reshape(b, h, 1, 1)
    q_pos = torch.arange(sq, device=device).reshape(1, 1, sq, 1)
    k_pos = torch.arange(sk, device=device).reshape(1, 1, 1, sk)
    return dropout_keep_reference(seed, bh, q_pos, k_pos, keep_prob)


def _pair_mask(b, sq, sk, causal, window, q_seg, kv_seg, device):
    """``[b, 1, sq, sk]`` attendable pairs."""
    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    if q_seg is not None:
        seg = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
        mask = mask & seg[:, None]
    return mask


def _expand_kv(x, h):
    return x if x.shape[2] == h else x.repeat_interleave(h // x.shape[2], dim=2)


def _acc_dtype(x):
    """The plain versions' arithmetic type: f32 (f64 for f64 inputs, which
    the tests use as the exact reference)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_attention_reference(q, k, v, *, causal=False, window=None,
                              q_seg=None, kv_seg=None, dropout_rate=0.0,
                              seed=0):
    """The plain PyTorch version of the forward kernel: the same function,
    materializing the ``[b, h, sq, sk]`` scores. Returns ``(out, lse)``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    acc = _acc_dtype(q)
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * (d ** -0.5)
    mask = _pair_mask(b, sq, sk, causal, window, q_seg, kv_seg, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if dropout_rate:
        keep_prob = 1.0 - dropout_rate
        keep = _keep_mask(b, h, sq, sk, seed, keep_prob, q.device)
        p = torch.where(keep, p / keep_prob, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, dout, lse, dterm, *, causal=False,
                                  window=None, q_seg=None, kv_seg=None,
                                  dropout_rate=0.0, seed=0):
    """The plain PyTorch version of the two backward kernels, written out
    as formulas (not autograd of the forward): with ``p = exp(s - lse)``
    on attendable pairs, ``dp = dO V^T`` (dropped and rescaled like the
    forward's value path) and ``ds = p * (dp - dterm) / sqrt(d)``, returns
    ``dQ = ds K``, ``dK = ds^T Q`` and ``dV = p_drop^T dO``, the last two
    summed over each kv head's query-head group. ``lse`` and ``dterm`` are
    f32 ``[b, h, sq]``."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    acc = _acc_dtype(q)
    kf, vf = _expand_kv(k, h).to(acc), _expand_kv(v, h).to(acc)
    qf, gf = q.to(acc), dout.to(acc)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _pair_mask(b, sq, sk, causal, window, q_seg, kv_seg, q.device)
    # Select before exp: exp(s - lse) overflows on rows whose lse is -1e30.
    p = torch.exp(torch.where(mask, s - lse[..., None], NEG_INF))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    p_drop = p
    if dropout_rate:
        keep_prob = 1.0 - dropout_rate
        keep = _keep_mask(b, h, sq, sk, seed, keep_prob, q.device)
        p_drop = torch.where(keep, p / keep_prob, torch.zeros_like(p))
        dp = torch.where(keep, dp / keep_prob, torch.zeros_like(dp))
    ds = p * (dp - dterm[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, gf)
    if h_kv != h:
        dk = dk.reshape(b, sk, h_kv, h // h_kv, d).sum(dim=3)
        dv = dv.reshape(b, sk, h_kv, h // h_kv, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(name, tensors, q, k, v, q_seg, kv_seg):
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass q_seg and kv_seg together, or neither")
    for t in tensors + ([q_seg, kv_seg] if q_seg is not None else []):
        if not _is_cuda(t) or t.device != q.device:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} supports float32 and bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q_seg is not None and (q_seg.dtype != torch.int32
                              or kv_seg.dtype != torch.int32):
        raise TypeError("segment ids must be int32")
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    if q_seg is not None and (tuple(q_seg.shape) != (b, sq)
                              or tuple(kv_seg.shape) != (b, k.shape[1])):
        raise ValueError("segment ids must be q_seg [b, sq] and kv_seg [b, sk]")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name} supports head_dim <= {MAX_HEAD_DIM}, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid limit 65535")


def _seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as the kernels read it: one int32 holding the
    uint32's bits, on ``device``. An ``int`` is filled in there (a fill,
    not a host copy, so a CUDA graph may capture it); a tensor (one
    element, any integer dtype) is converted on its own device, with no
    host read, so a seed drawn on the card stays there."""
    if not torch.is_tensor(seed):
        bits = int(seed) & _MASK32
        return torch.full((1,), bits - (1 << 32) if bits >= 1 << 31 else bits,
                          dtype=torch.int32, device=device)
    s = seed.reshape(1)
    if s.dtype != torch.int32:
        s = s.to(torch.int64) & _MASK32
        s = torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)
    return s.to(device)


def _mask_args(causal, window, dropout_rate, seed):
    """The C entries' trailing mask and dropout arguments; ``seed`` is the
    int32 tensor of :func:`_seed_tensor` (its device address is passed)."""
    keep_prob = 1.0 - float(dropout_rate)
    return (int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0,
            int(bool(dropout_rate)), _ptr(seed) if dropout_rate else None,
            dropout_threshold(keep_prob) if dropout_rate else 0, keep_prob)


def _kernel_seed(dropout_rate, seed, q):
    return _seed_tensor(seed, q.device) if dropout_rate else None


def _launch(name, q, *args):
    """Call the C entry ``name`` on q's device and current stream; raise on
    a refused launch."""
    from ._build import load

    lib = load(name)
    # The C entry launches on the calling thread's current device.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(*args, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, *, causal=False, window=None,
              dropout_rate=0.0, seed=0):
    """Launch the forward kernel (``csrc/flash_fwd.cu``) on the current
    stream.

    Takes contiguous CUDA tensors ``q [b, sq, h, d]``, ``k``/``v
    [b, sk, h_kv, d]`` of one dtype (float32 or bfloat16, ``d <= 128``) and
    optional int32 ``q_seg [b, sq]`` / ``kv_seg [b, sk]``; raises on
    anything else. ``seed`` (read only with ``dropout_rate``): an int, or a
    one-element integer tensor that the kernel reads on the card. Returns
    ``(out, lse)``. ``flash_fwd.launches`` counts the launches.
    """
    _check_kernel_inputs("flash_fwd", [q, k, v], q, k, v, q_seg, kv_seg)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), out.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, h_kv, d,
            *_mask_args(causal, window, dropout_rate, _kernel_seed(dropout_rate, seed, q)))
    flash_fwd.launches += 1
    return out, lse


def _check_bwd_inputs(name, q, dout, lse, dterm):
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout must match q's shape and dtype")
    b, sq, h, _ = q.shape
    for t in (lse, dterm):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(f"{name}: lse and dterm must be f32 [b, h, sq]")


def flash_bwd_dq(q, k, v, q_seg, kv_seg, dout, lse, dterm, *, causal=False,
                 window=None, dropout_rate=0.0, seed=0):
    """Launch the dQ kernel (``csrc/flash_bwd_dq.cu``) on the current
    stream. Tensors as for :func:`flash_fwd`, plus ``dout`` (q's shape and
    dtype) and f32 ``lse``/``dterm [b, h, sq]``, all contiguous on one CUDA
    device; raises on anything else. Returns ``dq`` in q's dtype.
    ``flash_bwd_dq.launches`` counts the launches."""
    _check_kernel_inputs("flash_bwd_dq", [q, k, v, dout, lse, dterm], q, k, v,
                         q_seg, kv_seg)
    _check_bwd_inputs("flash_bwd_dq", q, dout, lse, dterm)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), dout.data_ptr(), lse.data_ptr(),
            dterm.data_ptr(), dq.data_ptr(),
            b, sq, sk, h, h_kv, d,
            *_mask_args(causal, window, dropout_rate, _kernel_seed(dropout_rate, seed, q)))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, q_seg, kv_seg, dout, lse, dterm, *, causal=False,
                  window=None, dropout_rate=0.0, seed=0):
    """Launch the dK/dV kernel (``csrc/flash_bwd_dkv.cu``) on the current
    stream. Arguments as for :func:`flash_bwd_dq`. Returns ``(dk, dv)`` in
    k's and v's dtype, each summed over its kv head's query-head group.
    ``flash_bwd_dkv.launches`` counts the launches."""
    _check_kernel_inputs("flash_bwd_dkv", [q, k, v, dout, lse, dterm], q, k, v,
                         q_seg, kv_seg)
    _check_bwd_inputs("flash_bwd_dkv", q, dout, lse, dterm)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), dout.data_ptr(), lse.data_ptr(),
            dterm.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, h, h_kv, d,
            *_mask_args(causal, window, dropout_rate, _kernel_seed(dropout_rate, seed, q)))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def device_launches(device=None, *, reset: bool = False) -> dict[str, int]:
    """Per kernel, the launches ``device`` (default: the current CUDA
    device) ran since the count was last reset, counted by the kernels
    themselves (``csrc/flash_common.cuh``): unlike the wrappers'
    ``launches``, a CUDA-graph replay adds its captured launches and a
    capture adds none. Synchronizes the device; a kernel whose library this
    process has not loaded counts 0. ``reset=True`` zeroes the counts after
    reading them. Not to be called while a stream is capturing."""
    import ctypes

    from ._build import loaded

    device = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    out = {}
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            lib, count = loaded(name), ctypes.c_ulonglong(0)
            if lib is not None:
                err = lib.device_launches(ctypes.byref(count), int(reset))
                if err != 0:
                    raise RuntimeError(f"{name}: reading the device's launch "
                                       f"count failed with CUDA error {err}")
            out[name] = count.value
    return out


def _on_cpu(q) -> bool:
    if _is_cuda(q):
        return False
    if q.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {q.device}")


class _Flash(torch.autograd.Function):
    """``(out, lse)`` of attention with the recompute-based backward: the
    counterpart of the JAX package's ``_flash`` custom VJP. The forward
    saves ``(q, k, v, q_seg, kv_seg, seed, out, lse)`` (``seed`` the
    dropout seed's tensor, as the reference keeps it in its residuals, so
    the backward reads the forward's draw); the backward takes
    ``(dO, dlse)``, honours the lse cotangent through ``dterm = rowsum(dO *
    O) - dlse`` and launches the dQ and the dK/dV kernels (their plain
    versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, seed, causal, window,
                dropout_rate):
        opts = dict(causal=causal, window=window, dropout_rate=dropout_rate)
        with kernel_flops("flash_fwd", attention_flops(q, k)["flash_fwd"]):
            if _on_cpu(q):
                out, lse = flash_attention_reference(q, k, v, q_seg=q_seg,
                                                     kv_seg=kv_seg, seed=seed, **opts)
            else:
                out, lse = flash_fwd(q, k, v, q_seg, kv_seg, seed=seed, **opts)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, seed, out, lse)
        ctx.opts = opts
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, q_seg, kv_seg, seed, out, lse = ctx.saved_tensors
        opts = dict(ctx.opts, seed=seed)
        if dout is None:
            dout = torch.zeros_like(out)
        dout = dout.to(q.dtype).contiguous()
        # dterm = rowsum(dO * O) - dlse: plain torch, outside the kernels,
        # as the JAX package computes it outside its Pallas kernels.
        dterm = (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1)
        if dlse is not None:
            dterm = dterm - dlse.float()
        dterm = dterm.contiguous()
        cost = attention_flops(q, k)
        if _on_cpu(q):
            with kernel_flops("flash_bwd_dq", cost["flash_bwd_dq"]), \
                    kernel_flops("flash_bwd_dkv", cost["flash_bwd_dkv"]):
                dq, dk, dv = flash_attention_bwd_reference(
                    q, k, v, dout, lse, dterm, q_seg=q_seg, kv_seg=kv_seg,
                    **opts)
        else:
            with kernel_flops("flash_bwd_dq", cost["flash_bwd_dq"]):
                dq = flash_bwd_dq(q, k, v, q_seg, kv_seg, dout, lse, dterm,
                                  **opts)
            with kernel_flops("flash_bwd_dkv", cost["flash_bwd_dkv"]):
                dk, dv = flash_bwd_dkv(q, k, v, q_seg, kv_seg, dout, lse,
                                       dterm, **opts)
        return dq, dk, dv, None, None, None, None, None, None


def _check_dropout(dropout_rate, dropout_seed, device):
    """Validate the dropout configuration; returns ``(rate, seed)`` with
    ``seed`` the int32 tensor of :func:`_seed_tensor` on ``device`` (None
    without dropout). A tensor seed is never read on the host."""
    rate = float(dropout_rate)
    if rate == 0.0:
        return 0.0, None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed (an int or "
                         "an integer scalar tensor; vary it per step)")
    if torch.is_tensor(dropout_seed) and (
            dropout_seed.numel() != 1 or dropout_seed.is_floating_point()
            or dropout_seed.is_complex() or dropout_seed.dtype == torch.bool):
        raise ValueError("dropout_seed must be an int or a one-element integer "
                         f"tensor, got a {dropout_seed.dtype} tensor of shape "
                         f"{tuple(dropout_seed.shape)}")
    return rate, _seed_tensor(dropout_seed, device)


def _attend(q, k, v, causal, window, segment_ids, dropout_rate, dropout_seed):
    rate, seed = _check_dropout(dropout_rate, dropout_seed, q.device)
    _check_shapes(q, k, v)
    qseg, kseg = _normalize_segments(
        segment_ids, q.shape[0], q.shape[1], k.shape[1], q.device
    )
    if not _on_cpu(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, qseg, kseg, seed, bool(causal), window, rate)


def flash_attention(q, k, v, *, causal: bool = False, window: int | None = None,
                    segment_ids=None, dropout_rate: float = 0.0,
                    dropout_seed=None):
    """Attention over ``(batch, seq, heads, head_dim)`` without
    materializing the scores on the card; differentiable in ``q``, ``k``
    and ``v``. ``segment_ids``: one int ``[batch, seq]`` tensor, or a
    ``(q_seg, kv_seg)`` pair. ``window`` requires ``causal=True`` here.
    ``dropout_rate > 0`` drops inside the kernels with the hash keyed by
    ``dropout_seed``: an int, or a one-element integer tensor (a uint32
    value) that the kernels read on the device, so it may be drawn on the
    card, and the call captured into a CUDA graph, with no host read."""
    window = _check_window(window, causal)
    out, _ = _attend(q, k, v, causal, window, segment_ids, dropout_rate,
                     dropout_seed)
    return out


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             window: int | None = None, segment_ids=None,
                             dropout_rate: float = 0.0, dropout_seed=None):
    """:func:`flash_attention` that also returns ``lse`` ``[b, h, sq]``
    (f32; ``-1e30`` for rows with no attendable key), differentiable in
    both outputs (the lse cotangent folds into the backward's dS term).
    With ``causal=False`` a ``window`` is a pure band, ``q_pos - k_pos <
    window``."""
    window = _check_window(window, causal, allow_band=True)
    return _attend(q, k, v, causal, window, segment_ids, dropout_rate,
                   dropout_seed)


def _segments_from_attention_mask(mask, b: int, sq: int, sk: int, causal: bool):
    """Segment ids ``(q_seg [b, sq], kv_seg [b, sk])`` (int32) recovered
    from a flax attention mask broadcastable to ``[b, heads, sq, sk]``, by
    the JAX package's rule (``_segments_from_attention_mask``): exact for
    trailing padding and contiguous packed documents, and for either under
    ``causal`` (document boundaries from the subdiagonal). O(b·s) device
    reductions over the caller's mask, no host read; masks they do not
    represent are caught by :func:`_mask_fidelity`."""
    m = torch.as_tensor(mask)
    if m.dtype != torch.bool:
        m = m > 0
    if m.ndim != 4:
        raise ValueError(f"attention mask must be rank 4 [batch, heads, q, kv]; "
                         f"got shape {tuple(m.shape)}")
    kv_valid = m.any(dim=2).any(dim=1).expand(b, sk)
    q_valid = m.any(dim=3).any(dim=1).expand(b, sq)

    def ids(change):  # 1 + running count of boundaries, [b, n]
        first = torch.zeros((b, 1), dtype=torch.int32, device=m.device)
        return 1 + torch.cumsum(torch.cat([first, change.to(torch.int32)], dim=1),
                                dim=1, dtype=torch.int32)

    if causal and sq == sk:
        # Token j+1 continues token j's document iff it attends it.
        cont = torch.diagonal(m[:, :, 1:, :-1], dim1=2, dim2=3).any(dim=1)
        seg = ids(~cont.expand(b, sq - 1))
        zero = torch.zeros((), dtype=torch.int32, device=m.device)
        return torch.where(q_valid, seg, zero), torch.where(kv_valid, seg, zero)
    col = (m[:, :, :, 1:] != m[:, :, :, :-1]).any(dim=2).any(dim=1).expand(b, sk - 1)
    row = (m[:, :, 1:, :] != m[:, :, :-1, :]).any(dim=3).any(dim=1).expand(b, sq - 1)
    zero = torch.zeros((), dtype=torch.int32, device=m.device)
    return torch.where(q_valid, ids(row), zero), torch.where(kv_valid, ids(col), zero)


_FIDELITY_CHUNK = 512


def _mask_fidelity(mask, q_seg, kv_seg, causal: bool):
    """``[b]`` bools: whether the segment ids rebuild ``mask`` exactly (the
    JAX package's ``_mask_fidelity``), compared in chunks of query rows so
    that no second ``[b, sq, sk]`` buffer is made. A mask that varies
    across heads fails: segment ids are per batch row. Under ``causal``
    (and ``sq == sk``) both sides are taken with the causal mask, as the
    kernels apply it."""
    m = torch.as_tensor(mask)
    if m.dtype != torch.bool:
        m = m > 0
    b, sq, sk = q_seg.shape[0], q_seg.shape[1], kv_seg.shape[1]
    causal_sq = causal and sq == sk
    ok = torch.ones((b,), dtype=torch.bool, device=q_seg.device)
    kv_live = kv_seg[:, None, :] != 0
    for q0 in range(0, sq, _FIDELITY_CHUNK):
        q1 = min(q0 + _FIDELITY_CHUNK, sq)
        mc_h = m[:, :, q0:q1]
        mc = mc_h[:, 0]
        if m.shape[1] > 1:
            ok = ok & (mc_h == mc_h[:, :1]).flatten(1).all(dim=1)
        rebuilt = (q_seg[:, q0:q1, None] == kv_seg[:, None, :]) & kv_live
        if causal_sq:
            pos = (torch.arange(q0, q1, device=m.device)[:, None]
                   >= torch.arange(sk, device=m.device)[None, :])[None]
            rebuilt, mc = rebuilt & pos, mc & pos
        ok = ok & (rebuilt == mc).flatten(1).all(dim=1)
    return ok


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _draw_dropout_seed(dropout_rng) -> torch.Tensor:
    """A uint32 dropout seed (a 0-d int64 tensor) drawn from the
    ``torch.Generator`` ``dropout_rng`` on the generator's device, with no
    host read. The generator is noted for CUDA-graph windows
    (:func:`~fluxmpi_tpu_torch.runtime.note_graph_generator`), so every
    replay of a captured window draws afresh."""
    from .. import runtime

    runtime.note_graph_generator(dropout_rng)
    return torch.randint(0, 2 ** 32, (), generator=dropout_rng, dtype=torch.int64,
                         device=dropout_rng.device)


def flash_attention_fn(causal: bool = False, *, window: int | None = None,
                       mask_check: bool = True, dropout_impl: str = "dense"):
    """An ``attention_fn`` drop-in for the models' multi-head attention
    (:class:`~fluxmpi_tpu_torch.models._layers.MultiHeadDotProductAttention`,
    e.g. ``TransformerEncoder(attention_fn=flash_attention_fn())``):
    ``fn(query, key, value, bias=None, mask=None, **kwargs)`` over ``(b, s,
    h, d)`` tensors, through :func:`flash_attention`, the output in the
    query's dtype.

    A flax boolean ``mask`` (``[b | 1, h | 1, sq, sk]``) becomes segment ids
    (:func:`_segments_from_attention_mask`, composed with ``causal``):
    trailing padding, contiguous packed documents, and either with causal.
    A query row with no key left outputs zeros (flax's dense attend
    averages every value there). A mask the ids do not rebuild raises
    ``ValueError`` at the call; while a CUDA graph is being captured the
    check cannot be read on the host, so ``mask_check=True`` NaN-poisons
    the offending batch rows instead (``mask_check=False`` skips it there).
    ``bias`` raises: the scores never materialize.

    Dropout (``dropout_rate > 0`` with ``deterministic=False``):
    ``dropout_impl="kernel"`` draws a uint32 seed from ``dropout_rng`` (a
    ``torch.Generator`` on the query's device) on that device and drops
    inside the kernels with the reference's hash; no host read, so it runs
    under CUDA-graph capture, and a window captured by ``train_loop`` draws
    a fresh seed on every replay. ``dropout_impl="dense"`` (JAX's
    flax-exact fallback) raises ``NotImplementedError``: flax's random
    stream cannot be reproduced. Under the models' attention modules flax's
    keyword filter passes ``mask`` alone to this function, so they never
    drop here."""
    if dropout_impl not in ("dense", "kernel"):
        raise ValueError("dropout_impl must be 'dense' or 'kernel'")

    def fn(query, key, value, bias=None, mask=None, **kwargs):
        if bias is not None:
            raise ValueError("flash_attention_fn cannot honor a dense attention bias "
                             "(the score matrix never materializes)")
        _check_window(window, causal)
        dropout_rate = float(kwargs.get("dropout_rate", 0.0))
        dropout_seed = None
        if dropout_rate and not kwargs.get("deterministic", True):
            dropout_rng = kwargs.get("dropout_rng")
            if dropout_rng is None:
                raise ValueError("dropout_rate > 0 with deterministic=False requires "
                                 "a dropout_rng (a torch.Generator)")
            if dropout_impl == "dense":
                raise NotImplementedError(
                    "flash_attention_fn(dropout_impl='dense') is not ported: JAX "
                    "then takes flax's dense attention with flax's random stream "
                    "(dropout_rng), which the port cannot reproduce; pass "
                    "dropout_impl='kernel', or dropout_rate=0.0")
            dropout_seed = _draw_dropout_seed(dropout_rng)
        else:
            dropout_rate = 0.0
        segment_ids = fidelity = None
        if mask is not None:
            mask = torch.as_tensor(mask, device=query.device)
            segment_ids = _segments_from_attention_mask(
                mask, query.shape[0], query.shape[1], key.shape[1], causal)
            if not _capturing(query.device):
                ok = _mask_fidelity(mask, *segment_ids, causal)
                if not bool(ok.all()):
                    rows = torch.nonzero(~ok).flatten().tolist()
                    raise ValueError(
                        f"attention mask is not representable by segment ids for "
                        f"batch rows {rows} (non-contiguous sparsity, a head-varying "
                        f"pattern, or a causal mask passed with causal={causal}); "
                        f"use segment_ids= on flash_attention, or a dense "
                        f"attention_fn")
            elif mask_check:
                fidelity = _mask_fidelity(mask, *segment_ids, causal)
        out = flash_attention(query, key, value, causal=causal, window=window,
                              segment_ids=segment_ids, dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed).to(query.dtype)
        if fidelity is not None:
            out = torch.where(fidelity[:, None, None, None], out,
                              torch.full((), float("nan"), dtype=out.dtype,
                                         device=out.device))
        return out

    return fn
