"""Chunked fused unembed + softmax cross-entropy.

Counterpart of :func:`fluxmpi_tpu.ops.unembed_cross_entropy`: per-token
``softmax_cross_entropy(h @ embedding^T, targets)`` without materializing
the ``[tokens, vocab]`` logits. The forward walks the vocab in tiles of
``chunk`` rows of the table, keeping a running max, sum and target logit
per token (and the sum of the logits, for label smoothing); the backward
rebuilds each tile's softmax from the saved per-token logsumexp, so the
residuals are ``(h, embedding, targets, lse)`` and peak memory is
O(tokens * chunk). A trailing partial tile is zero-padded and its dead
columns masked to -inf (their softmax weight is exactly 0).

The JAX package runs this as a ``lax.scan``, not a TPU kernel, so here the
tiles are plain matrix products: the logits take the table's tile in the
hidden states' dtype and sum in f32, with an f32 result (bf16 hidden
states give f32 logits, not bf16-rounded ones); the backward's products
and the table's gradient are f32, returned in the table's own dtype.
"""

from __future__ import annotations

import torch

__all__ = ["tp_unembed_cross_entropy", "unembed_cross_entropy",
           "unembed_cross_entropy_reference"]


def _tiles(w, chunk: int):
    """``w [V, d]`` zero-padded to whole ``chunk``-row tiles: ``[K, chunk,
    d]``."""
    vocab, d = w.shape
    pad = (-vocab) % chunk
    if pad:
        w = torch.cat([w, w.new_zeros((pad, d))])
    return w.reshape(-1, chunk, d)


def _mm_f32(a, b):
    """``a @ b`` of two tensors of one dtype, summed in f32 and returned in
    f32 without rounding to the inputs' dtype (the JAX package's
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # bf16 and f16 products are exact in f32.
    return a.float() @ b.float()


def _tile_logits(h2, w_c, off: int, vocab: int):
    """``[N, chunk]`` f32 logits of one tile (the tile cast to the hidden
    states' dtype, products summed in f32), -inf on the padded columns,
    and the tile's column-validity mask ``[chunk]``."""
    z = _mm_f32(h2, w_c.to(h2.dtype).t())
    valid = torch.arange(off, off + w_c.shape[0], device=z.device) < vocab
    return z.masked_fill(~valid, float("-inf")), valid


def _scan_lse(h2, w, targets1, chunk: int, want_zsum: bool):
    """One pass over ``w``'s tiles: per-token ``(lse, t, zsum)``, the
    logsumexp, the target logit (0 where the target is not a row of
    ``w``) and the sum of the logits (None unless ``want_zsum``)."""
    vocab = w.shape[0]
    n = h2.shape[0]
    dev = h2.device
    m = torch.full((n,), float("-inf"), device=dev)
    l = torch.zeros(n, device=dev)
    t = torch.zeros(n, device=dev)
    zsum = torch.zeros(n, device=dev) if want_zsum else None
    rows = torch.arange(n, device=dev)
    for i, w_c in enumerate(_tiles(w.detach(), chunk)):
        off = i * chunk
        z, valid = _tile_logits(h2, w_c, off, vocab)
        if want_zsum:
            zsum += torch.where(valid, z, 0.0).sum(dim=-1)
        m_new = torch.maximum(m, z.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = targets1 - off
        in_chunk = (local >= 0) & (local < chunk)
        picked = z[rows, local.clamp(0, chunk - 1)]
        t = torch.where(in_chunk, picked, t)
    return m + torch.log(l), t, zsum


def _ce_bwd(h2, w, targets1, lse, g, chunk: int, eps: float, smooth_vocab: int):
    """``(dh, dw)`` of the loss through ``w``'s columns, given the
    per-token ``lse`` (the global one for a vocab shard) and the
    cotangent ``g``; ``smooth_vocab`` is the vocabulary label smoothing
    spreads over."""
    vocab, d = w.shape
    n = h2.shape[0]
    gf = g.float()
    hf = h2.float()
    dh = torch.zeros((n, d), dtype=torch.float32, device=h2.device)
    tiles = _tiles(w.detach(), chunk)
    dw = torch.empty((tiles.shape[0] * chunk, d), dtype=torch.float32,
                     device=w.device)
    for i, w_c in enumerate(tiles):
        off = i * chunk
        z, valid = _tile_logits(h2, w_c, off, vocab)
        # d loss / dz = p - [(1-eps) onehot + eps/V on valid columns]
        dz = torch.exp(z - lse[:, None])  # exactly 0 on padded columns
        local = targets1 - off
        hit = (local >= 0) & (local < chunk)
        # The target column loses 1 - eps on the rows whose target is in
        # this tile; the others lose 0.0, which leaves them unchanged.
        # No row selection by value, so no read back to the host (a CUDA
        # graph can capture it).
        col = local.clamp(0, chunk - 1)[:, None]
        dz.scatter_(1, col, dz.gather(1, col)
                    - torch.where(hit, 1.0 - eps, 0.0)[:, None])
        if eps:
            dz -= (eps / smooth_vocab) * valid
        dz *= gf[:, None]
        dh += dz @ w_c.float()
        dw[off:off + chunk] = dz.t() @ hf
    return dh, dw[:vocab]


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, targets1, chunk, eps):
        vocab = w.shape[0]
        lse, t, zsum = _scan_lse(h2, w, targets1, chunk, bool(eps))
        # (1-eps)(lse - t) + eps(lse - mean_v z) = lse - (1-eps)t - eps*zsum/V
        loss = lse - (1.0 - eps) * t
        if eps:
            loss = loss - eps * zsum / vocab
        ctx.save_for_backward(h2, w, targets1, lse)
        ctx.chunk, ctx.eps = chunk, eps
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, w, targets1, lse = ctx.saved_tensors
        dh, dw = _ce_bwd(h2, w, targets1, lse, g, ctx.chunk, ctx.eps, w.shape[0])
        return dh.to(h2.dtype), dw.to(w.dtype), None, None, None


def unembed_cross_entropy(h, embedding, targets, *, chunk: int = 8192,
                          label_smoothing: float = 0.0):
    """Per-token cross-entropy of the weight-tied head, f32, shape
    ``h.shape[:-1]``: ``h [..., d]`` hidden states (the matmuls run in this
    dtype), ``embedding [vocab, d]`` the table (its gradient returns in its
    own dtype), ``targets`` int labels of ``h.shape[:-1]``. ``chunk`` tiles
    the vocab; ``label_smoothing`` ``eps`` in [0, 1) makes the target
    ``(1 - eps) onehot + eps / vocab``."""
    if tuple(h.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"targets shape {tuple(targets.shape)} must equal the hidden "
            f"states' leading shape {tuple(h.shape[:-1])}"
        )
    vocab, d = embedding.shape
    if h.shape[-1] != d:
        raise ValueError(f"hidden dim {h.shape[-1]} != embedding dim {d}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}"
        )
    lead = h.shape[:-1]
    out = _FusedCE.apply(h.reshape(-1, d), embedding,
                         targets.reshape(-1).long(), min(chunk, vocab),
                         float(label_smoothing))
    return out.reshape(lead)


def unembed_cross_entropy_reference(h, embedding, targets, *,
                                    label_smoothing: float = 0.0):
    """The same loss through the full ``[tokens, vocab]`` logits."""
    logits = (h @ embedding.to(h.dtype).t()).float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
        reduction="none", label_smoothing=label_smoothing,
    ).reshape(targets.shape)


# ---------------------------------------------------------------------------
# Tensor-parallel (vocab-sharded) spelling: the Megatron parallel CE.
# ---------------------------------------------------------------------------


def _all_reduce(x, op, group):
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


class _FusedCETP(torch.autograd.Function):
    """Forward: the local scan over this worker's vocab block, then one
    max and two sums over the tp group give the exact global ``(loss,
    lse)``. Backward: the local pass fed the global lse gives this block's
    columns; ``dh`` sums over the tp group; the block's gradient stays
    local (summed over the batch group when the tokens are sharded), or,
    for a whole table (``full``), is placed in a table-shaped gradient
    summed over the tp group, the whole gradient on every worker."""

    @staticmethod
    def forward(ctx, h2, w, targets1, chunk, eps, tp_group, tp_size, tp_index,
                batch_group, full):
        import torch.distributed as dist

        v_local = w.shape[0] // tp_size if full else w.shape[0]
        wl = w[tp_index * v_local:(tp_index + 1) * v_local] if full else w
        local = targets1 - tp_index * v_local
        lse_l, t_l, zsum_l = _scan_lse(h2, wl, local, chunk, bool(eps))
        m_g = _all_reduce(lse_l.clone(), dist.ReduceOp.MAX, tp_group)
        lse = m_g + torch.log(_all_reduce(torch.exp(lse_l - m_g), dist.ReduceOp.SUM,
                                          tp_group))
        owned = (local >= 0) & (local < v_local)
        t = _all_reduce(torch.where(owned, t_l, 0.0), dist.ReduceOp.SUM, tp_group)
        loss = lse - (1.0 - eps) * t
        if eps:
            zsum = _all_reduce(zsum_l, dist.ReduceOp.SUM, tp_group)
            loss = loss - eps * zsum / (v_local * tp_size)
        ctx.save_for_backward(h2, wl, local, lse)
        ctx.args = (chunk, eps, tp_group, tp_size, tp_index, batch_group, full)
        return loss

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        h2, wl, local, lse = ctx.saved_tensors
        chunk, eps, tp_group, tp_size, tp_index, batch_group, full = ctx.args
        v_local = wl.shape[0]
        dh, dw = _ce_bwd(h2, wl, local, lse, g, chunk, eps, v_local * tp_size)
        _all_reduce(dh, dist.ReduceOp.SUM, tp_group)
        _all_reduce(dw, dist.ReduceOp.SUM, batch_group)
        if full:
            table = dw.new_zeros((v_local * tp_size, dw.shape[1]))
            table[tp_index * v_local:(tp_index + 1) * v_local] = dw
            dw = _all_reduce(table, dist.ReduceOp.SUM, tp_group)
        return (dh.to(h2.dtype), dw.to(wl.dtype), None, None, None, None, None,
                None, None, None)


def tp_unembed_cross_entropy(h, embedding, targets, *, mesh=None,
                             axis_name: str | None = None,
                             batch_axis_name=None, chunk: int = 8192,
                             label_smoothing: float = 0.0):
    """:func:`unembed_cross_entropy` for a vocab-sharded table, the
    Megatron parallel cross-entropy
    (:func:`fluxmpi_tpu.ops.tp_unembed_cross_entropy`). ``h``/``targets``
    are this worker's tokens (global vocabulary ids). ``embedding`` is the
    table as JAX's global array: a ``DTensor`` sharded ``Shard(0)`` over the
    tp axis (the ``transformer_tp_rules`` layout; its gradient stays this
    worker's block), or a plain tensor holding the whole ``[vocab, d]``
    table, such as the gathered table ``TransformerLM.forward(hidden=True)``
    returns inside a layout step (each worker computes its vocab block, and
    the table's gradient, summed over the tp group, is whole on every
    worker). Block ``i`` belongs to the worker at tp index ``i``.

    One max and two sums over the ``axis_name`` (default ``tp``) group of
    ``mesh`` (default the global mesh) combine the blocks' partial
    logsumexps and target logits into the exact global loss (``lse = m_g +
    log sum exp(lse_l - m_g)``; exactly one worker owns each target); the
    logits never exist. ``dh`` sums over the tp group. ``batch_axis_name``:
    the axes the tokens are sharded over (not tp); the table's gradient
    then sums over them too. ``vocab`` must divide evenly over tp."""
    from torch.distributed.tensor import DTensor

    from .. import config as _config

    if mesh is None:
        from ..runtime import global_mesh

        mesh = global_mesh()
    tp = axis_name or _config.TP_AXIS_NAME
    n = mesh.shape.get(tp)
    if n is None:
        raise ValueError(f"mesh has no axis {tp!r}")
    vocab, d = embedding.shape
    if vocab % n:
        raise ValueError(
            f"vocab {vocab} must divide evenly over the {tp!r} axis "
            f"(size {n}) for the vocab-sharded head"
        )
    if tuple(h.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"targets shape {tuple(targets.shape)} must equal the hidden "
            f"states' leading shape {tuple(h.shape[:-1])}"
        )
    if h.shape[-1] != d:
        raise ValueError(f"hidden dim {h.shape[-1]} != embedding dim {d}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    batch_axes = batch_axis_name
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    if batch_axes:
        for ax in batch_axes:
            if ax not in mesh.shape:
                raise ValueError(f"mesh has no axis {ax!r}")
            if ax == tp:
                raise ValueError("batch_axis_name cannot include the tp axis")
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}"
        )
    full = not isinstance(embedding, DTensor)
    table = embedding if full else embedding.to_local()
    index, _ = mesh.block_index(mesh.my_rank(), tp)
    lead = h.shape[:-1]
    out = _FusedCETP.apply(
        h.reshape(-1, d), table, targets.reshape(-1).long(), min(chunk, vocab // n),
        float(label_smoothing), mesh.group((tp,)), n, index,
        mesh.group(tuple(batch_axes)) if batch_axes else None, full)
    return out.reshape(lead)
