"""Flash attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of :mod:`fluxmpi_tpu.ops.flash_attention`. Inputs are
``(batch, seq, heads, head_dim)``; the scale is ``1/sqrt(head_dim)``;
scores, the running max and sum, and the accumulator are f32 whatever the
input dtype; the output comes back in the input dtype and the per-row
logsumexp ``lse`` as f32 ``[batch, heads, q_seq]``.

Masking: ``causal`` (``q_pos >= k_pos``), a sliding ``window``
(``q_pos - k_pos < window``; band only when ``causal=False``, reachable
through :func:`flash_attention_with_lse`), and integer segment ids: a pair
attends iff ``q_seg == kv_seg`` and ``kv_seg != 0`` (id 0 is padding). A
row with no attendable key outputs zeros and ``lse = -1e30``. Grouped-query
attention: ``k``/``v`` may carry ``h_kv`` heads with ``h % h_kv == 0``.

On a CUDA tensor the wrapper :func:`flash_fwd` launches the kernel of
``csrc/flash_fwd.cu`` (or raises); on a CPU tensor the plain version
:func:`flash_attention_reference` runs. There is no fallback between the
two. The backward kernels and in-kernel dropout come with the training
work: ``dropout_rate > 0`` raises.
"""

from __future__ import annotations

import torch

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_reference",
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


def flash_attention_reference(q, k, v, *, causal=False, window=None,
                              q_seg=None, kv_seg=None):
    """The plain PyTorch version of the kernel: the same function,
    materializing the ``[b, h, sq, sk]`` scores. Returns ``(out, lse)``."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=2)
        v = v.repeat_interleave(h // h_kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    if q_seg is not None:
        seg = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
        mask = mask & seg[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, *, causal=False, window=None):
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on the current stream.

    Takes contiguous CUDA tensors ``q [b, sq, h, d]``, ``k``/``v
    [b, sk, h_kv, d]`` of one dtype (float32 or bfloat16, ``d <= 128``) and
    optional int32 ``q_seg [b, sq]`` / ``kv_seg [b, sk]``; raises on
    anything else. Returns ``(out, lse)``. ``flash_fwd.launches`` counts the
    launches.
    """
    tensors = [q, k, v] + ([q_seg, kv_seg] if q_seg is not None else [])
    for t in tensors:
        if not _is_cuda(t) or t.device != q.device:
            raise ValueError("flash_fwd takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("flash_fwd takes contiguous tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd supports float32 and bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q_seg is not None and (q_seg.dtype != torch.int32
                              or kv_seg.dtype != torch.int32):
        raise TypeError("segment ids must be int32")
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd supports head_dim <= {MAX_HEAD_DIM}, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid limit 65535")
    from ._build import load

    lib = load("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # The C entry launches on the calling thread's current device.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            kv_seg.data_ptr() if kv_seg is not None else None,
            out.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, h_kv, d,
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0,
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _attend(q, k, v, causal, window, segment_ids, dropout_rate):
    if dropout_rate:
        raise NotImplementedError(
            "in-kernel attention dropout comes with the training kernels"
        )
    _check_shapes(q, k, v)
    qseg, kseg = _normalize_segments(
        segment_ids, q.shape[0], q.shape[1], k.shape[1], q.device
    )
    if _is_cuda(q):
        return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         qseg, kseg, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         q_seg=qseg, kv_seg=kseg)
    raise ValueError(f"unsupported device {q.device}")


def flash_attention(q, k, v, *, causal: bool = False, window: int | None = None,
                    segment_ids=None, dropout_rate: float = 0.0):
    """Attention over ``(batch, seq, heads, head_dim)`` without
    materializing the scores on the card. ``segment_ids``: one int
    ``[batch, seq]`` tensor, or a ``(q_seg, kv_seg)`` pair. ``window``
    requires ``causal=True`` here."""
    window = _check_window(window, causal)
    out, _ = _attend(q, k, v, causal, window, segment_ids, dropout_rate)
    return out


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             window: int | None = None, segment_ids=None,
                             dropout_rate: float = 0.0):
    """:func:`flash_attention` that also returns ``lse`` ``[b, h, sq]``
    (f32; ``-1e30`` for rows with no attendable key). With
    ``causal=False`` a ``window`` is a pure band, ``q_pos - k_pos <
    window``."""
    window = _check_window(window, causal, allow_band=True)
    return _attend(q, k, v, causal, window, segment_ids, dropout_rate)
