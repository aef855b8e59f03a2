"""Ulysses-style sequence parallelism: all-to-all head/sequence resharding.

Counterpart of :mod:`fluxmpi_tpu.parallel.ulysses`, the second
long-context layout beside the ring (:mod:`fluxmpi_tpu_torch.parallel.ring`).
On this worker's block of a sequence sharded over ``axis_name`` (n
workers):

1. Q/K/V arrive ``[b, s/n, h, d]`` (sequence-sharded, every head local).
2. One all-to-all reshards them to ``[b, s, h/n, d]``: every worker holds
   the whole sequence for ``h/n`` heads.
3. Attention runs locally (dense, or the flash kernels), exact because the
   heads are independent.
4. One all-to-all back returns ``[b, s/n, h, d]``.

The all-to-alls are ``torch.distributed.nn.functional.all_to_all_single``
(differentiable: the backward is the reverse all-to-all); Q, K and V travel
in one of them. The head count (and the kv head count under grouped-query
attention) must divide by the axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn

from .. import _sequence_parallel as _sp
from .. import _tensor_parallel
from .plan import plan_axis_name
from .ring import _adapter_dropout, _fold_seed, _local_attend, _sharded_call

__all__ = ["ulysses_attention", "make_ulysses_attention", "ulysses_attention_fn"]


def _seq_to_heads(ts, axis):
    """``[b, s/n, h_i, d]`` each → ``[b, s, h_i/n, d]``: this worker's head
    group of the whole sequence, every tensor in one all-to-all."""
    n = axis.size
    parts, shapes = [], []
    for t in ts:
        b, s_l, h, d = t.shape
        # Chunk j (head group j) goes to member j.
        parts.append(t.reshape(b, s_l, n, h // n, d).permute(2, 0, 1, 3, 4)
                     .reshape(n, -1))
        shapes.append((b, s_l, h // n, d))
    flat = torch.cat(parts, dim=1).contiguous()
    out = dfn.all_to_all_single(torch.empty_like(flat), flat, group=axis.group)
    res, at = [], 0
    for b, s_l, hn, d in shapes:
        size = b * s_l * hn * d
        # Row j came from member j: sequence block j.
        blk = out[:, at:at + size].reshape(n, b, s_l, hn, d)
        res.append(blk.permute(1, 0, 2, 3, 4).reshape(b, n * s_l, hn, d))
        at += size
    return res


def _heads_to_seq(t, axis):
    """``[b, s, h/n, d]`` → ``[b, s/n, h, d]``: the inverse reshard."""
    n = axis.size
    b, s, hn, d = t.shape
    flat = t.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    flat = flat.reshape(n, -1)
    out = dfn.all_to_all_single(torch.empty_like(flat), flat, group=axis.group)
    # Row j came from member j: head group j.
    return out.reshape(n, b, s // n, hn, d).permute(1, 2, 0, 3, 4).reshape(
        b, s // n, n * hn, d)


def _gather_seq(seg, axis):
    """Int ``[b, s/n]`` → ``[b, s]``, the blocks in axis order."""
    seg = seg.contiguous()
    parts = [torch.empty_like(seg) for _ in range(axis.size)]
    dist.all_gather(parts, seg, group=axis.group)
    return torch.cat(parts, dim=1)


def ulysses_attention(
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
    """All-to-all sequence-parallel attention over this worker's block of
    a sequence sharded over ``axis_name`` (axis 1), its head dimension
    (axis 2) divisible by the axis size.

    ``segment_ids``: optional int **local shards** ``[batch, seq_local]``
    (or a ``(q_seg, kv_seg)`` pair) in the flash kernels' convention; they
    are all-gathered to the whole sequence for the local attend.
    Grouped-query attention: K/V may carry fewer heads than Q; each
    tensor's own head axis is resharded, so ``h_kv`` must divide by the
    axis size too. ``window`` (requires ``causal=True``): the local attend
    sees the whole sequence, so global positions apply directly.

    Unbound (no sequence-parallel context or mesh axis) this is exact
    single-worker attention, like the ring.
    """
    name = axis_name or plan_axis_name("sp")
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    if dropout_rate and not use_flash:
        raise ValueError(
            "ulysses_attention dropout requires use_flash=True (in-kernel "
            "position-hash masks)"
        )
    if dropout_rate and dropout_seed is None:
        raise ValueError(
            "dropout_rate > 0 requires dropout_seed (an int or traced "
            "uint32 scalar)"
        )
    axis = _sp.bound(name)
    if axis is None:
        return _local_attend(
            q, k, v, causal=causal, segment_ids=segment_ids,
            use_flash=use_flash, window=window,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
    n = axis.size
    h, h_kv = q.shape[2], k.shape[2]
    tp = _tensor_parallel.current()
    if tp is not None and tp.names is not None and (h // tp.size) % n:
        # The step's first update computes on whole heads; from the next
        # on each tp worker may hold h/tp of them, and Ulysses shards a
        # worker's heads over the sp axis.
        raise ValueError(
            f"Ulysses over '{name}' of size {n} under tp={tp.size}: each tp "
            f"worker holds {h // tp.size} of the {h} heads, which {n} does not "
            f"divide (use ring_attention, or a head count divisible by "
            f"tp x {name} = {tp.size * n})")
    if h % n:
        raise ValueError(
            f"head count {h} must be divisible by the '{name}' axis size "
            f"{n} (Ulysses shards heads; use ring_attention otherwise)"
        )
    if h_kv != h and h_kv % n:
        raise ValueError(
            f"kv head count {h_kv} must be divisible by the '{name}' axis "
            f"size {n} (Ulysses shards kv heads too; use ring_attention "
            f"for grouped-KV layouts with fewer heads than devices)"
        )
    if n == 1:
        qg, kg, vg = q, k, v
    else:
        qg, kg, vg = _seq_to_heads((q, k, v), axis)

    seg_full = None
    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            qseg, kseg = segment_ids
        else:
            qseg = kseg = segment_ids
        qseg = torch.as_tensor(qseg, device=q.device).to(torch.int32)
        kseg = torch.as_tensor(kseg, device=q.device).to(torch.int32)
        seg_full = (_gather_seq(qseg, axis), _gather_seq(kseg, axis)) if n > 1 \
            else (qseg, kseg)

    # Every worker holds another head group at the same local (bh, q, k)
    # coordinates: fold its index into the seed.
    seed = _fold_seed(dropout_seed, axis.index) if dropout_rate else None
    out = _local_attend(
        qg, kg, vg, causal=causal, segment_ids=seg_full,
        use_flash=use_flash, window=window,
        dropout_rate=dropout_rate, dropout_seed=seed,
    )
    return out if n == 1 else _heads_to_seq(out, axis)


def ulysses_attention_fn(
    axis_name: str | None = None,
    causal: bool = False,
    use_flash: bool = False,
    window: int | None = None,
):
    """``attention_fn`` drop-in for the models' multi-head attention on a
    sequence-sharded block (used as
    :func:`~fluxmpi_tpu_torch.parallel.ring.ring_attention_fn` is).
    Attention dropout runs in the kernels with masks independent per
    (batch, head)."""

    def fn(query, key, value, bias=None, mask=None, **kwargs):
        if bias is not None or mask is not None:
            raise ValueError(
                "ulysses_attention_fn derives masking from causal/"
                "segment_ids; pass causal=True instead of a mask/bias"
            )
        rate, seed = _adapter_dropout(kwargs)
        return ulysses_attention(
            query, key, value, axis_name=axis_name, causal=causal,
            use_flash=use_flash, window=window, dropout_rate=rate,
            dropout_seed=seed,
        )

    return fn


def make_ulysses_attention(
    mesh=None,
    *,
    axis_name: str | None = None,
    causal: bool = False,
    batch_axis_name: str | None = None,
    use_flash: bool = False,
    window: int | None = None,
    dropout_rate: float = 0.0,
):
    """Eager wrapper over global arrays (the mirror of
    :func:`~fluxmpi_tpu_torch.parallel.ring.make_ring_attention`). With
    ``dropout_rate > 0`` (requires ``use_flash=True``), pass
    ``dropout_seed=`` on each call."""
    from ..runtime import global_mesh

    mesh = mesh or global_mesh()
    sp = axis_name or plan_axis_name("sp")
    dp = batch_axis_name
    if dropout_rate and not use_flash:
        raise ValueError(
            "make_ulysses_attention dropout requires use_flash=True"
        )

    def fn(q, k, v, dropout_seed=None):
        if dropout_rate and dropout_seed is None:
            raise ValueError(
                "this wrapper was built with dropout_rate > 0; pass "
                "dropout_seed= per call (vary it per step)"
            )
        size = mesh.shape[sp]
        for name_, t in (("q", q), ("k", k), ("v", v)):
            if t.shape[1] % size != 0:
                raise ValueError(
                    f"{name_} sequence length {t.shape[1]} must be divisible "
                    f"by the '{sp}' mesh axis size {size} (pad the sequence)"
                )
            if t.shape[2] % size != 0:
                raise ValueError(
                    f"{name_} head count {t.shape[2]} must be divisible by "
                    f"the '{sp}' axis size {size} (Ulysses shards heads)"
                )
        seed = dropout_seed if dropout_rate else None

        def body(q, k, v):
            return ulysses_attention(
                q, k, v, axis_name=sp, causal=causal, use_flash=use_flash,
                window=window, dropout_rate=dropout_rate, dropout_seed=seed)

        return _sharded_call(mesh, sp, dp, (q, k, v), body)

    return fn
