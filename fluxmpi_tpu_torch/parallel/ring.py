"""Ring attention: sequence (context) parallelism over a mesh axis.

Counterpart of :mod:`fluxmpi_tpu.parallel.ring`. The sequence dimension
is sharded over a mesh axis (``sp``): each worker holds one block of
Q/K/V, the K/V blocks rotate around the ring in neighbour exchanges
(:class:`~fluxmpi_tpu_torch._collective_ops.Exchanges`, the counterpart of
``jax.lax.ppermute``), and each worker accumulates its queries' attention
block by block. Peak memory is O(seq / n) per worker.

Two causal schedules:

- **contiguous** (:func:`ring_attention` with ``causal=True``): worker i
  owns sequence block i. Worker 0 attends on one of the n ticks, worker
  n-1 on all of them.
- **zigzag** (:func:`zigzag_ring_attention`): the sequence is split into
  ``2n`` chunks and worker i owns chunks ``(i, 2n-1-i)``, so every worker
  does the same causal work on every tick (:func:`zigzag_tick_work`). Use
  :func:`zigzag_indices` to permute global arrays into this layout.

The flash path (``use_flash=True``) attends each resident block with
:func:`~fluxmpi_tpu_torch.ops.flash_attention_with_lse` (the CUDA kernels
on the card) and merges the normalized block results on their
log-sum-exp; the kernels' backward honours the lse cotangent, so the ring
differentiates exactly. The dense path accumulates an online softmax in
plain torch.

The worker knows its ring index and the tick on the host, so where the
JAX package selects with ``lax.cond``/``jnp.where``, the port branches on
the host: a block that is masked out entirely launches nothing. The
rotation itself is never conditional: every worker makes the same
exchanges in the same order. The schedules take the rotation as a
callable (``rotate(blocks) -> blocks``), so the same schedule code can
also run every ring position on one device with the blocks handed over
in memory.

Masking beyond ``causal`` uses the flash kernels' integer segment ids
(attend iff ids equal and key id nonzero; 0 is padding); K/V ids rotate
with their blocks. Shapes: ``q, k, v`` are ``(batch, seq_local, heads,
head_dim)``, this worker's block of a sequence sharded over
``axis_name``. The axis is bound under a sequence-parallel context (the
``style="auto"`` step over a plan with ``sp``, or the ``make_*``
wrappers) or when the runtime's mesh has it
(:mod:`fluxmpi_tpu_torch._sequence_parallel`); unbound, the ring is the
exact single-worker attention (the n = 1 ring).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _sequence_parallel as _sp
from .._collective_ops import Exchanges, MeshAxis, shard_along, unshard_along
from .plan import plan_axis_name

__all__ = [
    "ring_attention",
    "zigzag_ring_attention",
    "zigzag_indices",
    "make_ring_attention",
    "ring_attention_fn",
]

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF


def _expand_kv(t, h):
    """Repeat grouped K/V heads up to the query head count for the dense
    paths, locally, after any rotation (the exchanges move the small
    ``h_kv`` blocks)."""
    h_kv = t.shape[2]
    if h_kv == h:
        return t
    if h % h_kv:
        raise ValueError(
            f"query head count {h} must be a multiple of the kv head "
            f"count {h_kv} (grouped-query attention)"
        )
    return t.repeat_interleave(h // h_kv, dim=2)


def _block_attend(q, k, v, o, m, l, mask, keep=None, keep_prob=1.0):
    """One blockwise online-softmax update.

    q: [b, sq, h, d]; k/v: [b, sk, h, d]; o: [b, sq, h, d];
    m/l: [b, sq, h]; mask: bool broadcastable to [b, h, sq, sk]
    (True = attend) or None. ``keep`` (broadcastable to the scores, True =
    keep): flax's dropout of the normalized weights, which scales only
    the numerator, by ``keep / keep_prob``; the normalizer ``l`` sums the
    undropped weights.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m_block = scores.amax(dim=-1).movedim(1, -1)  # [b, sq, h]
    m_new = torch.maximum(m, m_block)
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new.movedim(-1, 1)[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = l * alpha + p.sum(dim=-1).movedim(1, -1)
    if keep is not None:
        p = p * (keep.to(p.dtype) / keep_prob)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v).movedim(1, 2)
    return o_new, m_new, l_new


def _seg_mask4(qseg, kseg):
    """Segment mask broadcastable to [b, h, sq, sk]: attend iff same
    segment and the key is not padding (id 0)."""
    q4 = qseg[:, None, :, None]
    k4 = kseg[:, None, None, :]
    return (q4 == k4) & (k4 != 0)


def _dense_with_lse(q, k, v, causal, qseg=None, kseg=None):
    """Dense local attend returning ``(out [b, sq, h, d] f32, lse [b, h,
    sq] f32)``: the plain twin of ``flash_attention_with_lse``, used by the
    zigzag schedule's dense path. Handles grouped K/V heads and segment
    ids."""
    k = _expand_kv(k, q.shape[2]).float()
    v = _expand_kv(v, q.shape[2]).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (1.0 / np.sqrt(q.shape[-1]))
    mask = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])[None, None]
    if qseg is not None:
        smask = _seg_mask4(qseg, kseg)
        mask = smask if mask is None else mask & smask
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = m + torch.log(l_safe)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe[..., None], v)
    return o, lse


def _lse_merge(o, lse, o_blk, lse_blk):
    """Merge an accumulated ``(o [b, sq, h, d] f32, lse [b, sq, h])`` with
    a new normalized block result whose lse arrives as ``[b, h, sq]`` (the
    kernels' convention)."""
    lse_blk = lse_blk.movedim(1, -1)
    lse_new = torch.logaddexp(lse, lse_blk)
    w_prev = torch.exp(lse - lse_new)[..., None]
    w_blk = torch.exp(lse_blk - lse_new)[..., None]
    return o * w_prev + o_blk.float() * w_blk, lse_new


_FOLD = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def _fold_seed(seed, *salts):
    """Per-call-site dropout seed: the JAX package's fold of the salts
    (ring index, tick source, attend id) into the base seed, as uint32
    arithmetic: ``seed + sum((salt + 1) * c) mod 2**32``. The salts are
    host ints; a tensor seed stays on its device (int64 holding the uint32
    bits, no host read), an int seed gives an int."""
    add = 0
    for salt, c in zip(salts, _FOLD):
        add = (add + (int(salt) + 1) * c) & _MASK32
    if torch.is_tensor(seed):
        return ((seed.reshape(()).to(torch.int64) & _MASK32) + add) & _MASK32
    return (int(seed) + add) & _MASK32


def _ring_flash(q, k, v, *, causal: bool, n: int, idx: int, qseg, kseg,
                window: int | None = None, dropout_rate: float = 0.0,
                dropout_seed=None, rotate=None):
    """Ring accumulation with the flash kernels as the local block attend
    (:func:`~fluxmpi_tpu_torch.ops.flash_attention_with_lse`): returns
    ``(out f32 [b, sq, h, d], lse f32 [b, sq, h])`` of ring position
    ``idx`` of ``n``. ``rotate(blocks) -> blocks`` hands the resident
    ``(k, v[, kv_seg])`` to the next position and returns what arrives.

    Each resident block is attended by the kernels, which return a
    normalized block output and its logsumexp; the blocks merge on the
    lse. Attention dropout composes exactly with the merge (the kernels
    normalize with the undropped probabilities); each (position, source)
    attend folds its coordinates into the seed.

    ``window`` (causal only): on tick ``s`` every live resident block
    sits exactly ``s`` positions in the past, a static displacement of
    ``s * sq``, so the diagonal tick runs the kernels' causal+window mask
    and each past tick the band-only mask ``q - k < window - s * sq``
    (``causal=False``; a band of every pair drops the window). Once the
    band is dead for every position the schedule stops attending and
    rotating, so compute and traffic are O(window)."""
    from ..ops.flash_attention import flash_attention_with_lse

    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, sq, h), _NEG_INF, dtype=torch.float32, device=q.device)
    has_seg = qseg is not None

    def attend(blocks, local_causal, src, local_window=None):
        seg = (qseg, blocks[2]) if has_seg else None
        seed = _fold_seed(dropout_seed, idx, src) if dropout_rate else None
        return flash_attention_with_lse(
            q, blocks[0], blocks[1], causal=local_causal, segment_ids=seg,
            window=local_window, dropout_rate=dropout_rate, dropout_seed=seed)

    blocks = (k, v, kseg) if has_seg else (k, v)
    if window is not None:
        if k.shape[1] != sq:
            raise ValueError(
                f"windowed ring attention requires equal q/kv shards, got "
                f"{sq} vs {k.shape[1]}"
            )
        o, lse = _lse_merge(o, lse, *attend(blocks, True, idx, window))
        for s in range(1, n):
            w_local = window - s * sq
            # Dead for every position from here on: stop attending and
            # rotating.
            if w_local <= 1 - sq:
                break
            # A band of every pair: the unmasked kernel.
            tick_window = None if w_local >= sq else w_local
            blocks = rotate(blocks)
            if idx >= s:
                o, lse = _lse_merge(o, lse, *attend(blocks, False, idx - s, tick_window))
        return o, lse

    for s in range(n):
        if s:
            blocks = rotate(blocks)
        # After s rotations the resident block came from position idx - s.
        src = (idx - s) % n
        if causal and src > idx:
            continue  # strictly in the future: nothing to attend
        o, lse = _lse_merge(o, lse, *attend(blocks, causal and src == idx, src))
    return o, lse


def _ring_dense(q, k, v, *, causal: bool, n: int, idx: int, qseg, kseg,
                window: int | None = None, rotate=None, dropout_rate: float = 0.0,
                dropout_seed=None):
    """The dense ring of position ``idx`` of ``n``: an online softmax in
    f32 over the resident blocks, masked on global positions. Returns
    the output in q's dtype. ``dropout_rate`` with ``dropout_seed`` (the
    uint32 seed of a dense attend's draw) drops as the whole-sequence
    dense attend with that seed does: each tick the ``[q block, key
    block]`` slice, by global positions, of its mask
    (:func:`~fluxmpi_tpu_torch.models._layers.dense_dropout_keep`)."""
    from ..models._layers import dense_dropout_keep

    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, h), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    qf = q.float()
    has_seg = qseg is not None
    blocks = (k, v, kseg) if has_seg else (k, v)
    for s in range(n):
        if s:
            blocks = rotate(blocks)
        src = (idx - s) % n
        sk = blocks[0].shape[1]
        if causal:
            # A block entirely in the future or outside the window band
            # is skipped; the K/V still rotate.
            live = (idx + 1) * sq - 1 >= src * sk
            if window is not None:
                live = live and idx * sq - ((src + 1) * sk - 1) < window
            if not live:
                continue
        kf = _expand_kv(blocks[0], h).float()
        vf = _expand_kv(blocks[1], h).float()
        mask = keep = None
        q_pos = idx * sq + torch.arange(sq, device=q.device)
        k_pos = src * sk + torch.arange(sk, device=q.device)
        if dropout_rate:
            keep = dense_dropout_keep(dropout_seed, q_pos, k_pos, 1.0 - dropout_rate)
        if causal:
            pos = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                pos = pos & (q_pos[:, None] - k_pos[None, :] < window)
            mask = pos[None, None]
        if has_seg:
            smask = _seg_mask4(qseg, blocks[2])
            mask = smask if mask is None else mask & smask
        o, m, l = _block_attend(qf, kf, vf, o, m, l, mask, keep, 1.0 - dropout_rate)
    # Guard fully-masked rows (l == 0) against 0/0.
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def _dense_dropout_ring(q, k, v, *, axis_name: str, causal: bool, dropout_rate: float,
                        dropout_seed):
    """The dense ring over the bound ``axis_name`` with the dense attend's
    dropout (a transformer layer's ``"naive"`` attention under a
    sequence-parallel step): each tick drops the slice of the mask the
    whole-sequence attend draws with ``dropout_seed``, so the sp run drops
    exactly what the unsharded run drops. The public ring functions keep
    the JAX package's refusal of dropout on their dense path."""
    axis = _sp.bound(axis_name)
    xs, rotate = _rotation(axis, (q, k, v))
    return xs.attach(_ring_dense(q, k, v, causal=causal, n=axis.size, idx=axis.index,
                                 qseg=None, kseg=None, rotate=rotate,
                                 dropout_rate=dropout_rate, dropout_seed=dropout_seed))


def _local_attend(q, k, v, *, causal, segment_ids=None, use_flash=False,
                  window=None, dropout_rate=0.0, dropout_seed=None):
    """Single-worker attention with ring semantics (the n = 1 ring): the
    unbound-axis fallback, and the local attend of
    :func:`~fluxmpi_tpu_torch.parallel.ulysses.ulysses_attention`."""
    if use_flash:
        from ..ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, causal=causal, segment_ids=segment_ids, window=window,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if dropout_rate:
        raise ValueError(
            "attention dropout on the SP layers requires use_flash=True "
            "(the in-kernel mask; the dense debug paths do not implement it)"
        )
    qseg, kseg = _normalize_ring_segments(segment_ids, q.shape[0], q.shape[1],
                                          k.shape[1], q.device)
    k = _expand_kv(k, q.shape[2])
    v = _expand_kv(v, q.shape[2])
    mask = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        pos = qp >= kp
        if window is not None:
            pos = pos & (qp - kp < window)
        mask = pos[None, None]
    if qseg is not None:
        smask = _seg_mask4(qseg, kseg)
        mask = smask if mask is None else mask & smask
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:2], q.shape[2]), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    o, m, l = _block_attend(q.float(), k.float(), v.float(), o, m, l, mask)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def _normalize_ring_segments(segment_ids, b, sq, sk, device):
    """The flash kernels' segment normalization on the local shards
    ``(batch, seq_local)``, so the two paths share their checks."""
    from ..ops.flash_attention import _normalize_segments

    return _normalize_segments(segment_ids, b, sq, sk, device)


def _check_dropout(name, dropout_rate, dropout_seed, use_flash, why):
    if dropout_rate and not use_flash:
        raise ValueError(f"{name} dropout requires use_flash=True ({why})")
    if dropout_rate and dropout_seed is None:
        raise ValueError(
            "dropout_rate > 0 requires dropout_seed (an int or traced "
            "uint32 scalar)"
        )


def _rotation(axis: MeshAxis, inputs) -> tuple[Exchanges, callable]:
    """The exchanges of one ring over ``axis`` and the rotation that
    sends every resident block one position on."""
    xs = Exchanges(axis, inputs)
    n = axis.size
    perm = [(i, (i + 1) % n) for i in range(n)]
    return xs, lambda blocks: xs(blocks, [perm] * len(blocks))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str | None = None,
    causal: bool = False,
    segment_ids=None,
    use_flash: bool = False,
    window: int | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """Blockwise ring attention over this worker's block of a sequence
    sharded over ``axis_name`` (default the plan's ``sp`` axis).

    Each of the ``n`` ring ticks attends the local queries to the
    resident K/V block, then the blocks rotate to the next neighbour.
    With ``causal=True`` blocks strictly in the future are skipped; for
    balanced causal work use :func:`zigzag_ring_attention`.

    ``segment_ids``: optional int local shards ``[batch, seq_local]`` (or a
    ``(q_seg, kv_seg)`` pair) in the flash kernels' convention; K/V ids
    rotate with their blocks.

    ``use_flash=True`` attends each block with the flash kernels.
    ``window`` (sliding-window attention, requires ``causal=True``) holds
    on both paths: the dense ring masks on global positions; the flash
    ring runs the band-only kernels on past ticks and never attends nor
    rotates a tick whose band is dead (see :func:`_ring_flash`).
    Dropout (``dropout_rate > 0``, flash only) needs ``dropout_seed``: an
    int or a one-element integer tensor (a uint32), folded per attend.
    """
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    _check_dropout("ring_attention", dropout_rate, dropout_seed, use_flash,
                   "in-kernel position-hash masks; see flash_attention dropout_rate")
    name = axis_name or plan_axis_name("sp")
    axis = _sp.bound(name)
    if axis is None:
        # Unbound axis: the one-worker ring is the local attention.
        return _local_attend(
            q, k, v, causal=causal, segment_ids=segment_ids,
            use_flash=use_flash, window=window,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
    b, sq, h, d = q.shape
    qseg, kseg = _normalize_ring_segments(segment_ids, b, sq, k.shape[1], q.device)
    xs, rotate = _rotation(axis, (q, k, v))
    opts = dict(causal=causal, n=axis.size, idx=axis.index, qseg=qseg, kseg=kseg,
                window=window, rotate=rotate)
    if use_flash:
        o, _ = _ring_flash(q, k, v, dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed, **opts)
        return xs.attach(o.to(q.dtype))
    return xs.attach(_ring_dense(q, k, v, **opts))


def zigzag_tick_work(i: int, s: int, n: int) -> tuple[tuple[str, str, str], ...]:
    """The zigzag schedule as data: the chunk attends worker ``i`` performs
    on tick ``s`` of an ``n``-worker ring, as ``(q_chunk, kv_chunk, kind)``
    triples with chunks named ``"lo"``/``"hi"`` and kind ``"full"`` or
    ``"diag"`` (diag is about half the work of full)."""
    src = (i - s) % n
    if s == 0:
        return (("lo", "lo", "diag"), ("hi", "lo", "full"), ("hi", "hi", "diag"))
    if src < i:
        return (("hi", "lo", "full"), ("lo", "lo", "full"))
    return (("hi", "lo", "full"), ("hi", "hi", "full"))


def zigzag_indices(seq_len: int, n: int) -> np.ndarray:
    """Permutation taking a contiguous global sequence to zigzag layout:
    split into ``2n`` chunks, worker i owns chunks ``(i, 2n-1-i)``. Apply as
    ``x[:, zigzag_indices(s, n)]`` before the sharded call; invert with
    the ``argsort`` of the same indices."""
    if seq_len % (2 * n):
        raise ValueError(
            f"sequence length {seq_len} must be divisible by 2·n = {2 * n}"
        )
    c = seq_len // (2 * n)
    chunks = np.arange(seq_len).reshape(2 * n, c)
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return chunks[order].reshape(-1)


def _zigzag(q, k, v, *, n: int, idx: int, qseg, kseg, use_flash: bool,
            dropout_rate: float = 0.0, dropout_seed=None, rotate=None):
    """The zigzag schedule of ring position ``idx`` of ``n``
    (:func:`zigzag_tick_work`): ``(out f32 [b, sq, h, d], lse f32 [b, sq,
    h])``, the lo chunk's rows then the hi chunk's. ``rotate`` as
    :func:`_ring_flash` takes it."""
    from ..ops.flash_attention import flash_attention_with_lse

    b, sq, h, d = q.shape
    c = sq // 2
    has_seg = qseg is not None

    def attend(qc, kc, vc, local_causal, qs, ks, attend_id):
        seg = (qs, ks) if qs is not None else None
        if use_flash:
            seed = _fold_seed(dropout_seed, idx, attend_id) if dropout_rate else None
            return flash_attention_with_lse(
                qc, kc, vc, causal=local_causal, segment_ids=seg,
                dropout_rate=dropout_rate, dropout_seed=seed)
        return _dense_with_lse(qc, kc, vc, local_causal, qs, ks)

    def split(t):
        return t[:, :c], t[:, c:]

    q_lo, q_hi = split(q)
    qs_lo, qs_hi = split(qseg) if has_seg else (None, None)
    zeros = dict(dtype=torch.float32, device=q.device)
    o_lo = torch.zeros((b, c, h, d), **zeros)
    o_hi = torch.zeros((b, c, h, d), **zeros)
    lse_lo = torch.full((b, c, h), _NEG_INF, **zeros)
    lse_hi = torch.full((b, c, h), _NEG_INF, **zeros)

    # Tick 0: the resident pair is this position's own.
    klo, khi = split(k)
    vlo, vhi = split(v)
    ks_lo, ks_hi = split(kseg) if has_seg else (None, None)
    o_lo, lse_lo = _lse_merge(o_lo, lse_lo, *attend(q_lo, klo, vlo, True, qs_lo, ks_lo, 0))
    o_hi, lse_hi = _lse_merge(o_hi, lse_hi, *attend(q_hi, klo, vlo, False, qs_hi, ks_lo, 1))
    o_hi, lse_hi = _lse_merge(o_hi, lse_hi, *attend(q_hi, khi, vhi, True, qs_hi, ks_hi, 2))

    blocks = (k, v, kseg) if has_seg else (k, v)
    for s in range(1, n):
        blocks = rotate(blocks)
        src = (idx - s) % n
        klo, khi = split(blocks[0])
        vlo, vhi = split(blocks[1])
        ks_lo, ks_hi = split(blocks[2]) if has_seg else (None, None)
        # Always (hi, lo, full): q_hi is in the future of every lo chunk.
        o_hi, lse_hi = _lse_merge(
            o_hi, lse_hi, *attend(q_hi, klo, vlo, False, qs_hi, ks_lo, 1 + 2 * s))
        if src < idx:  # (lo, lo, full)
            o_lo, lse_lo = _lse_merge(
                o_lo, lse_lo, *attend(q_lo, klo, vlo, False, qs_lo, ks_lo, 2 + 2 * s))
        else:  # (hi, hi, full)
            o_hi, lse_hi = _lse_merge(
                o_hi, lse_hi, *attend(q_hi, khi, vhi, False, qs_hi, ks_hi, 2 + 2 * s))
    return torch.cat([o_lo, o_hi], dim=1), torch.cat([lse_lo, lse_hi], dim=1)


def zigzag_ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str | None = None,
    segment_ids=None,
    use_flash: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """Causal ring attention with the zigzag-balanced schedule, on arrays
    pre-permuted with :func:`zigzag_indices`.

    Worker i holds global chunks ``(i, 2n-1-i)`` concatenated along the
    sequence axis. Every tick each worker attends two half blocks (tick
    0: two causal diagonals and one full), so no worker idles. Schedule:
    :func:`zigzag_tick_work`.

    ``segment_ids``: optional int local shards ``[batch, seq_local]``,
    **pre-permuted with the same** :func:`zigzag_indices` **as q/k/v**;
    they split into the same chunks and rotate with their K/V blocks.
    Grouped-query K/V rotate at ``h_kv`` heads; the kernels read them as
    they are.
    """
    _check_dropout("zigzag_ring_attention", dropout_rate, dropout_seed, use_flash,
                   "in-kernel position-hash masks")
    name = axis_name or plan_axis_name("sp")
    axis = _sp.bound(name)
    if axis is None:
        # The n = 1 zigzag layout is the identity: plain causal attention.
        return _local_attend(
            q, k, v, causal=True, segment_ids=segment_ids, use_flash=use_flash,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
    b, sq, h, d = q.shape
    if sq % 2:
        raise ValueError(f"local sequence length {sq} must be even (2 chunks)")
    qseg, kseg = _normalize_ring_segments(segment_ids, b, sq, k.shape[1], q.device)
    xs, rotate = _rotation(axis, (q, k, v))
    o, _ = _zigzag(q, k, v, n=axis.size, idx=axis.index, qseg=qseg, kseg=kseg,
                   use_flash=use_flash, dropout_rate=dropout_rate,
                   dropout_seed=dropout_seed, rotate=rotate)
    return xs.attach(o.to(q.dtype))


def _adapter_dropout(kwargs):
    """Dropout plumbing shared by the SP ``attention_fn`` wrappers: the
    module-passed dropout keywords as an in-kernel ``(rate, seed)`` pair,
    the seed drawn on the device from the ``torch.Generator``
    ``dropout_rng``; ``(0.0, None)`` when deterministic."""
    rate = float(kwargs.get("dropout_rate", 0.0))
    if not rate or kwargs.get("deterministic", True):
        return 0.0, None
    rng = kwargs.get("dropout_rng")
    if rng is None:
        raise ValueError(
            "dropout_rate > 0 with deterministic=False requires a "
            "dropout_rng (flax passes it when the module is given a "
            "'dropout' rng collection)"
        )
    from ..ops.flash_attention import _draw_dropout_seed

    return rate, _draw_dropout_seed(rng)


def ring_attention_fn(
    axis_name: str | None = None,
    causal: bool = False,
    use_flash: bool = False,
    window: int | None = None,
):
    """An ``attention_fn`` drop-in for the models' multi-head attention
    (``TransformerEncoder(attention_fn=ring_attention_fn(...))``), for a
    model that runs on this worker's block of a sequence sharded over
    ``axis_name``: every other encoder op is pointwise over the sequence,
    so only attention needs the ring. Explicit masks raise (use
    ``causal=True``; the mask comes from global ring positions).

    Attention dropout runs in the kernels on the flash path, seeded from
    the module's ``dropout_rng``, with masks independent per (batch,
    head). Unbound, the ring is exact single-worker attention, so the
    model runs outside the sharded setting too."""
    def fn(query, key, value, bias=None, mask=None, **kwargs):
        if bias is not None or mask is not None:
            raise ValueError(
                "ring_attention_fn derives masking from ring position; "
                "pass causal=True instead of an explicit mask/bias"
            )
        rate, seed = _adapter_dropout(kwargs)
        return ring_attention(
            query, key, value, axis_name=axis_name, causal=causal,
            use_flash=use_flash, window=window, dropout_rate=rate,
            dropout_seed=seed,
        )

    return fn


def _segment_pair(segment_ids, q, k):
    """``segment_ids`` as a checked ``(q_seg, kv_seg)`` pair of int32
    global ``[batch, seq]`` tensors (or ``()``)."""
    if segment_ids is None:
        return ()
    if isinstance(segment_ids, (tuple, list)):
        segs = tuple(torch.as_tensor(s, device=q.device).to(torch.int32)
                     for s in segment_ids)
    else:
        segs = (torch.as_tensor(segment_ids, device=q.device).to(torch.int32),) * 2
    for s, ref in zip(segs, (q, k)):
        if tuple(s.shape) != (ref.shape[0], ref.shape[1]):
            raise ValueError(
                f"segment_ids shape {tuple(s.shape)} != (batch, seq) = "
                f"{(ref.shape[0], ref.shape[1])}"
            )
    return segs


def _sharded_call(mesh, sp: str, dp: str | None, args, body):
    """``body`` on this worker's blocks of the global ``args`` (batch over
    ``dp`` when given, sequence over ``sp``) under a sequence-parallel
    context for ``sp``; returns the global result, gathered back. The
    inputs' cotangents come back whole on every worker, and the output's
    backward keeps this worker's block, as every worker computes the same
    function of the global result."""
    sp_axis = MeshAxis(mesh, sp)
    args = shard_along(args, sp_axis, [1] * len(args))
    dp_axis = MeshAxis(mesh, dp) if dp else None
    if dp_axis is not None:
        args = shard_along(args, dp_axis, [0] * len(args))
    ctx = _sp.SequenceParallel(mesh, sp)
    with _sp.active(ctx):
        out = body(*args)
    if dp_axis is not None:
        out = unshard_along(out, dp_axis, 0)
    return unshard_along(out, sp_axis, 1)


def make_ring_attention(
    mesh=None,
    *,
    axis_name: str | None = None,
    causal: bool = False,
    batch_axis_name: str | None = None,
    use_flash: bool = False,
    schedule: str = "contiguous",
    window: int | None = None,
    dropout_rate: float = 0.0,
):
    """Wrap :func:`ring_attention` for eager use on global arrays.

    Returns ``fn(q, k, v, segment_ids=None, dropout_seed=None) -> out``:
    every worker of ``mesh`` (default the runtime's) passes the global
    ``(batch, seq, heads, head_dim)`` tensors and gets the global result,
    each computing on its block (sequence over ``axis_name``, and batch
    over ``batch_axis_name`` when given). Differentiable: each input's
    gradient comes back whole on every worker.

    ``schedule="zigzag"`` (causal only) applies the :func:`zigzag_indices`
    permutation on the way in and its inverse on the way out, so callers
    keep contiguous global sequences while the workers run the balanced
    schedule.
    """
    from ..runtime import global_mesh

    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "zigzag" and not causal:
        raise ValueError("zigzag schedule only applies to causal attention")
    if schedule == "zigzag" and window is not None:
        raise ValueError(
            "window is not supported on the zigzag schedule (chunk attends "
            "carry global offsets); use schedule='contiguous', or "
            "ulysses_attention"
        )
    mesh = mesh or global_mesh()
    sp = axis_name or plan_axis_name("sp")
    dp = batch_axis_name
    if dropout_rate and not use_flash:
        raise ValueError(
            "make_ring_attention dropout requires use_flash=True"
        )

    def fn(q, k, v, segment_ids=None, dropout_seed=None):
        if dropout_rate and dropout_seed is None:
            raise ValueError(
                "this wrapper was built with dropout_rate > 0; pass "
                "dropout_seed= per call (vary it per step)"
            )
        size = mesh.shape[sp]
        divisor = 2 * size if schedule == "zigzag" else size
        for name_, t in (("q", q), ("k", k), ("v", v)):
            if t.shape[1] % divisor != 0:
                raise ValueError(
                    f"{name_} sequence length {t.shape[1]} must be divisible "
                    f"by {divisor} ('{sp}' axis size {size}"
                    + (", ×2 chunks for zigzag)" if schedule == "zigzag"
                       else ") — pad the sequence")
                )
        segs = _segment_pair(segment_ids, q, k)
        seed = dropout_seed if dropout_rate else None

        def body(q, k, v, *seg):
            if schedule == "zigzag":
                return zigzag_ring_attention(
                    q, k, v, axis_name=sp, use_flash=use_flash,
                    segment_ids=seg if seg else None,
                    dropout_rate=dropout_rate, dropout_seed=seed)
            return ring_attention(
                q, k, v, axis_name=sp, causal=causal, use_flash=use_flash,
                segment_ids=seg if seg else None, window=window,
                dropout_rate=dropout_rate, dropout_seed=seed)

        if schedule == "zigzag":
            idxs = torch.as_tensor(zigzag_indices(q.shape[1], size), device=q.device)
            inv = torch.argsort(idxs)
            args = tuple(t[:, idxs] for t in (q, k, v, *segs))
            return _sharded_call(mesh, sp, dp, args, body)[:, inv]
        return _sharded_call(mesh, sp, dp, (q, k, v, *segs), body)

    return fn
