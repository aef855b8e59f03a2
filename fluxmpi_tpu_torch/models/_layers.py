"""The layers of the port's models, with flax 0.12's semantics: Dense and
LayerNorm (the transformers), convolution, BatchNorm, GroupNorm and
pooling (the vision models), and multi-head dot-product attention.

Vision models take NHWC inputs, as in JAX, and run on NCHW views of them: a
contiguous NHWC tensor permuted to NCHW is a ``torch.channels_last``
tensor, the layout cuDNN's fast convolutions want, so the permute moves no
data. Conv kernels keep flax's HWIO layout and names (``kernel``
``[kh, kw, in, out]``); each forward permutes them to OIHW inside the cast
to the compute dtype, as ``.to(dtype, memory_format=channels_last)``.

What follows flax and not ``torch.nn``:

- ``padding="SAME"`` is flax's: ``total = max((out - 1) * s + k - in, 0)``
  with ``lo = total // 2`` (at stride 2 the extra row and column go at the
  end: a 7x7/2 conv on 224 pads (2, 3), a 3x3/2 conv on 56 pads (0, 1)),
  applied with ``F.pad`` where it is not symmetric; max pooling pads with
  ``-inf``, as ``lax.reduce_window`` does. A conv's bias is added after
  the product is rounded to the compute dtype, as flax adds it.
- :class:`BatchNorm` is ``flax.linen.BatchNorm(momentum=0.9,
  epsilon=1e-5)`` with ``use_fast_variance``: the statistics in f32,
  ``var = max(0, E[x^2] - E[x]^2)`` (biased), running averages ``0.9 * old
  + 0.1 * batch``, and the output ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in f32, rounded once to the module's dtype. With
  ``axis_name`` set, a training forward averages the stacked ``[mean,
  E[x^2]]`` over the world in one all-reduce that autograd reduces too
  (``torch.distributed.nn.functional.all_reduce``), as flax's one
  ``pmean``. It never mutates its state: the running statistics come in as
  a dict keyed by flax path (``"bn_0.mean"``, ``"bn_0.var"``) and the new
  ones go out in another, as flax's ``mutable=["batch_stats"]``.
- :class:`GroupNorm` is ``flax.linen.GroupNorm(num_groups, epsilon=1e-6,
  dtype=jnp.float32)``: group ``g`` is the contiguous channel run ``[g *
  C/G, (g + 1) * C/G)``, its statistics are taken over ``(H, W, C/G)`` in
  f32 with the same fast variance, and the output is the same f32
  formula.
- :func:`dot_product_attention` is flax's: the query divided by
  ``sqrt(head_dim)`` in the compute dtype, masked scores set to the
  dtype's lowest finite value (a row with no key left averages every
  value, as flax's does), the softmax rounded to the compute dtype.
  :class:`MultiHeadDotProductAttention` calls its ``attention_fn`` with
  the keywords flax passes, filtered by the function's signature as flax
  filters them.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import _batch_parallel, runtime

__all__ = ["BatchNorm", "Conv", "Dense", "GroupNorm", "LayerNorm",
           "MultiHeadDotProductAttention", "StatsContext", "at_least_f32",
           "dense_dropout_keep", "dot_product_attention", "init_batch_stats", "lecun_normal", "max_pool",
           "name_norms", "same_pads", "zeros_init"]


class _Init:
    """Explicit-generator initializers (flax's defaults in kind: normal
    kernels scaled by ``1/sqrt(fan_in)``, zero biases, unit LN scales).
    Draws on the CPU generator and copies to the device, so one seed gives
    the same weights on every device."""

    def __init__(self, device, generator):
        self.device = device
        self.generator = generator

    def normal(self, shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.generator)
        return nn.Parameter(t.to(self.device))

    def fill(self, shape, value):
        return nn.Parameter(
            torch.full(shape, value, dtype=torch.float32, device=self.device)
        )


def zeros_init(init: _Init, shape, fan_in: int) -> nn.Parameter:
    """flax's ``zeros_init()`` as a kernel initializer."""
    return init.fill(shape, 0.0)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` of shape ``[in, *out]`` or
    ``[*in, out]``; ``in_dims`` counts the trailing input axes contracted.
    ``kernel_init(init, shape, fan_in)`` draws the kernel (default: a
    normal of standard deviation ``1/sqrt(fan_in)``)."""

    def __init__(self, kernel_shape, bias_shape, init: _Init, fan_in: int,
                 in_dims: int = 1, kernel_init: Callable | None = None):
        super().__init__()
        if kernel_init is None:
            self.kernel = init.normal(kernel_shape, 1.0 / math.sqrt(fan_in))
        else:
            self.kernel = kernel_init(init, kernel_shape, fan_in)
        self.bias = init.fill(bias_shape, 0.0)
        self.in_dims = in_dims

    def forward(self, x, dtype, bias: bool = True):
        """``x @ kernel + bias`` in ``dtype`` (without the bias when
        ``bias=False``: a row-parallel block's partial sum, the bias added
        once after the sum over the tp group)."""
        lead = x.shape[: x.ndim - self.in_dims]
        n_in = math.prod(self.kernel.shape[: self.in_dims])
        w = self.kernel.to(dtype).reshape(n_in, -1)
        y = x.to(dtype).reshape(-1, n_in) @ w
        if bias:
            y = y + self.bias.to(dtype).reshape(-1)
        return y.reshape(*lead, *self.kernel.shape[self.in_dims:])


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, init: _Init):
        super().__init__()
        self.scale = init.fill((d,), 1.0)
        self.bias = init.fill((d,), 0.0)
        self.eps = eps

    def forward(self, x, dtype):
        # In f32 whatever the parameters' dtype (flax promotes the stats,
        # scale and bias to f32), then cast.
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(dtype)


def same_pads(size: Sequence[int], window: Sequence[int],
              strides: Sequence[int]) -> list[tuple[int, int]]:
    """flax's ``"SAME"`` padding per spatial axis: ``(lo, hi)``."""
    pads = []
    for n, k, s in zip(size, window, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh), value=value)


def lecun_normal(init: _Init, shape, fan_in: int) -> nn.Parameter:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=init.generator)
    return nn.Parameter(t.to(init.device))


class Conv(nn.Module):
    """``flax.linen.Conv(features, kernel_size, strides, padding=padding,
    use_bias=use_bias, dtype=dtype, kernel_init=kernel_init)`` on NCHW
    tensors: input, kernel and bias cast to ``dtype``, the output in
    ``dtype``. ``padding`` is ``"SAME"`` or ``"VALID"``; ``kernel_init``
    as :class:`Dense`'s (default flax's ``lecun_normal``), the bias
    zeros."""

    def __init__(self, in_features: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), *, init: _Init, dtype=torch.float32,
                 padding: str = "SAME", use_bias: bool = False,
                 kernel_init: Callable | None = None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        kh, kw = kernel_size
        shape = (kh, kw, in_features, features)
        self.kernel = (kernel_init or lecun_normal)(init, shape, kh * kw * in_features)
        if use_bias:
            self.bias = init.fill((features,), 0.0)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.permute(3, 2, 0, 1).to(self.dtype,
                                              memory_format=torch.channels_last)
        x = x.to(self.dtype)
        if self.padding == "VALID":
            y = F.conv2d(x, w, stride=self.strides)
        else:
            pads = same_pads(x.shape[2:], w.shape[2:], self.strides)
            if all(lo == hi for lo, hi in pads):
                y = F.conv2d(x, w, stride=self.strides, padding=[lo for lo, _ in pads])
            else:
                y = F.conv2d(_pad(x, pads), w, stride=self.strides)
        if hasattr(self, "bias"):
            y = y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)
        return y


def max_pool(x: torch.Tensor, window, strides, padding: str = "VALID") -> torch.Tensor:
    """``flax.linen.max_pool`` on NCHW tensors (``"SAME"`` pads with
    ``-inf``)."""
    if padding == "SAME":
        x = _pad(x, same_pads(x.shape[2:], window, strides), float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.max_pool2d(x, window, strides)


class StatsContext:
    """The BatchNorm statistics of one forward: ``stats`` in (keyed by
    flax path), ``new`` out (filled by each training-mode BatchNorm)."""

    def __init__(self, stats: dict, train: bool):
        self.stats = stats
        self.train = train
        self.new: dict = {}


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` promoted to at least f32 (f64 stays f64), as flax promotes
    BatchNorm's statistics and ``jnp.mean``'s sums."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _pmean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the world; the backward reduces too."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn

    runtime._require_init()
    # The group is named at each call: the function's default is the
    # group that was current when the module was first imported, which a
    # later init() may have replaced.
    return dist_fn.all_reduce(t, group=dist.group.WORLD) / runtime.total_workers()


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
    axis_name=axis_name)`` over axis 1 (the channels of an NCHW tensor, or
    the features of ``[N, C]``). Parameters ``scale`` (ones, or
    ``scale_init``) and ``bias`` (zeros); the statistics live in the
    :class:`StatsContext` under ``<path>.mean`` and ``<path>.var``, where
    ``path`` is the module's name in its model (:func:`name_norms`).
    Training statistics: with ``axis_name``, over the world (sync-BN);
    else inside the ``style="auto"`` step over the global batch
    (:mod:`~fluxmpi_tpu_torch._batch_parallel`), as flax's BatchNorm sees
    it under JAX's partitioned step; else over ``x``'s rows."""

    def __init__(self, features: int, *, init: _Init, dtype=torch.float32,
                 axis_name: str | None = None, momentum: float = 0.9,
                 epsilon: float = 1e-5, scale_init: float = 1.0):
        super().__init__()
        self.scale = init.fill((features,), scale_init)
        self.bias = init.fill((features,), 0.0)
        self.dtype = dtype
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.path = ""

    def forward(self, x: torch.Tensor, ctx: StatsContext) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        keys = (f"{self.path}.mean", f"{self.path}.var")
        # One cast feeds both the statistics and the normalization, so the
        # backward sums their cotangents in f32 and rounds once (two casts
        # would round each to the input's dtype before the sum, and the
        # two nearly cancel).
        xf = at_least_f32(x)
        if ctx.train:
            axes = [d for d in range(x.ndim) if d != 1]
            mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
            if self.axis_name is not None:
                mean, mean2 = _pmean(torch.stack([mean, mean2])).unbind(0)
            elif (rows := _batch_parallel.current()) is not None:
                # The global batch's statistics under the style="auto" step.
                mean, mean2 = rows.mean(torch.stack([mean, mean2])).unbind(0)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            m = self.momentum
            for key, batch in zip(keys, (mean, var)):
                ctx.new[key] = m * ctx.stats[key] + (1 - m) * batch.detach()
        else:
            mean, var = (ctx.stats[k] for k in keys)
        mul = torch.rsqrt(var + self.epsilon) * at_least_f32(self.scale)
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        return (y + at_least_f32(self.bias).reshape(shape)).to(self.dtype)


def name_norms(model: nn.Module) -> None:
    """Give each :class:`BatchNorm` of ``model`` its flax path (its module
    name) as the key prefix of its statistics."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.path = name


def init_batch_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """flax's initial ``batch_stats`` of ``model``'s BatchNorms: means 0
    and variances 1, f32, on the parameters' device, keyed by flax path
    joined with ``.``."""
    out: dict[str, Any] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            dev = mod.scale.device
            out[f"{name}.mean"] = torch.zeros(mod.scale.shape, device=dev)
            out[f"{name}.var"] = torch.ones(mod.scale.shape, device=dev)
    return out


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups, epsilon=epsilon,
    dtype=jnp.float32)`` over the channels of an NCHW tensor (axis 1):
    group ``g`` holds the contiguous channels ``[g * C/G, (g + 1) * C/G)``,
    as flax groups the last axis of NHWC. Statistics over ``(H, W, C/G)``
    per sample and group in (at least) f32, ``var = max(0, E[x^2] -
    E[x]^2)``; the output ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in (at least) f32. Parameters ``scale`` (ones) and ``bias``
    (zeros), ``[C]``."""

    def __init__(self, num_groups: int, features: int, *, init: _Init,
                 epsilon: float = 1e-6):
        super().__init__()
        if num_groups <= 0 or features % num_groups:
            raise ValueError(f"Number of groups ({num_groups}) does not divide the "
                             f"number of channels ({features}).")
        self.num_groups = num_groups
        self.scale = init.fill((features,), 1.0)
        self.bias = init.fill((features,), 0.0)
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        shape = [1] * x.ndim
        shape[:2] = [n, c]
        # One cast feeds both the statistics and the normalization (as in
        # BatchNorm); expand + reshape (not repeat_interleave) spreads the
        # group statistics over their channels, so the backward is a plain
        # sum, the same bits on every run.
        xf = at_least_f32(x)
        grouped = xf.reshape(n, g, -1)
        mean, mean2 = grouped.mean(-1), (grouped * grouped).mean(-1)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)

        def per_channel(t):
            return t[:, :, None].expand(n, g, c // g).reshape(shape)

        mul = torch.rsqrt(per_channel(var) + self.epsilon) * at_least_f32(
            self.scale).reshape(1, c, *shape[2:])
        y = (xf - per_channel(mean)) * mul
        return y + at_least_f32(self.bias).reshape(1, c, *shape[2:])


def dense_dropout_keep(seed, q_pos, k_pos, keep_prob: float, bh=0) -> torch.Tensor:
    """The keep mask (True = keep) of the dense attend's dropout at query
    positions ``q_pos`` and key positions ``k_pos`` (integer tensors):
    ``[len(q_pos), len(k_pos)]``, or with ``bh`` (a ``[b * h]`` tensor of
    folded batch-head rows) ``[b * h, len(q_pos), len(k_pos)]``. A
    counter-based draw: the flash kernels' murmur3 hash of ``(seed, bh,
    q_pos, k_pos)`` against the keep threshold
    (:func:`~fluxmpi_tpu_torch.ops.flash_attention.dropout_keep_reference`),
    so any block of the mask is drawn alone, by its global positions: a
    sequence-parallel ring drops exactly what the whole-sequence attend
    drops with the same seed."""
    from ..ops.flash_attention import dropout_keep_reference

    q_pos, k_pos = q_pos[:, None], k_pos[None, :]
    if torch.is_tensor(bh):
        bh, q_pos, k_pos = bh[:, None, None], q_pos[None], k_pos[None]
    return dropout_keep_reference(seed, bh, q_pos, k_pos, keep_prob)


def dot_product_attention(query, key, value, mask=None, *, dropout_rng=None,
                          dropout_rate: float = 0.0, broadcast_dropout: bool = True,
                          deterministic: bool = False, dtype=None,
                          dropout_positions=None):
    """flax's ``nn.dot_product_attention`` over ``(b, s, h, d)`` tensors:
    ``softmax(q / sqrt(d) . k^T)`` in ``dtype`` (default the query's),
    where ``mask`` (broadcastable to ``[b, h, sq, sk]``, True = attend) is
    False the score is the dtype's lowest finite value, then the weights
    (rounded to ``dtype``) times the values.

    Dropout (``dropout_rate > 0`` and not ``deterministic``), as flax's
    ``dot_product_attention_weights``: with ``broadcast_dropout=True`` (its
    default) one Bernoulli(``1 - dropout_rate``) keep mask of shape ``[sq,
    sk]``, shared by every batch row and head, else one per batch row and
    head (each keyed by its place in the whole batch,
    :func:`~fluxmpi_tpu_torch._batch_parallel.place`); the weights times
    ``keep / keep_prob`` in ``dtype``. The mask is :func:`dense_dropout_keep`
    under one uint32 seed drawn from the ``torch.Generator``
    ``dropout_rng`` (on the weights' device; required,
    as flax requires a ``"dropout"`` rng). flax draws its mask from its own
    random stream, which the port cannot reproduce: the two agree in law
    (the keep rate, the scaling, the shared shape), not bit for bit. A CUDA
    generator is noted for CUDA-graph windows
    (:func:`~fluxmpi_tpu_torch.runtime.note_graph_generator`), so each
    replay draws a fresh mask. ``dropout_positions`` (a ``[b]`` integer
    tensor; one query per row; the shared mask only) places each row's
    query at that position of the mask, so a cached decode step drops what
    the whole-sequence attend drops at the same position under the same
    seed."""
    dtype = dtype or query.dtype
    q = query.to(dtype) / math.sqrt(query.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, key.to(dtype))
    if mask is not None:
        s = torch.where(torch.as_tensor(mask, device=s.device).to(torch.bool), s,
                        torch.finfo(dtype).min)
    w = torch.softmax(s, dim=-1).to(dtype)
    if dropout_rate > 0.0 and not deterministic:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 with deterministic=False needs a "
                             "dropout_rng (a torch.Generator on the weights' "
                             "device), as flax needs a 'dropout' rng")
        from ..ops.flash_attention import _draw_dropout_seed, hash_rows

        keep_prob = 1.0 - dropout_rate
        seed = _draw_dropout_seed(dropout_rng).to(w.device)
        b, h, sq, sk = w.shape
        rows = torch.arange(sq, device=w.device)
        cols = torch.arange(sk, device=w.device)
        if dropout_positions is not None:
            # One query per row, each at its own position of the shared mask.
            if not broadcast_dropout:
                raise ValueError("dropout_positions places rows of the shared "
                                 "(broadcast_dropout=True) mask")
            pos = torch.as_tensor(dropout_positions, device=w.device).long().reshape(b)
            keep = dense_dropout_keep(seed, pos, cols, keep_prob)[:, None, None, :]
        elif broadcast_dropout:
            keep = dense_dropout_keep(seed, rows, cols, keep_prob)
        else:
            # Each row and head keyed by its place in the whole batch.
            b0, h0, heads = _batch_parallel.place(b, h)
            bh = hash_rows(b, h, b0=b0, h0=h0, heads=heads, device=w.device).reshape(b * h)
            keep = dense_dropout_keep(seed, rows, cols, keep_prob, bh).reshape(b, h, sq, sk)
        w = w * (keep.to(dtype) / torch.full((), keep_prob, dtype=dtype, device=w.device))
    return torch.einsum("bhqk,bkhd->bqhd", w, value.to(dtype))


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention(num_heads, dtype=dtype,
    dropout_rate=dropout_rate, attention_fn=attention_fn,
    out_kernel_init=out_kernel_init)`` for self-attention over ``[b, s,
    features]``: ``query``/``key``/``value`` kernels ``[features, heads,
    head_dim]`` with biases ``[heads, head_dim]``, ``out`` kernel
    ``[heads, head_dim, features]`` with bias ``[features]``, all in
    ``dtype``. ``attention_fn`` (default :func:`dot_product_attention`) is
    called as flax calls it: ``fn(query, key, value, mask=,
    dropout_rng=, dropout_rate=, deterministic=, dtype=)``, each keyword
    passed only if the function's signature names it (so a function that
    takes ``**kwargs`` gets ``mask`` alone, as under flax)."""

    def __init__(self, num_heads: int, features: int, *, init: _Init,
                 dtype=torch.float32, dropout_rate: float = 0.0,
                 attention_fn: Callable | None = None,
                 out_kernel_init: Callable | None = None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"Memory dimension ({features}) must be divisible by "
                             f"number of heads ({num_heads}).")
        hd = features // num_heads
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = float(dropout_rate)
        self.attention_fn = attention_fn
        for name in ("query", "key", "value"):
            self.add_module(name, Dense((features, num_heads, hd), (num_heads, hd),
                                        init, features))
        self.out = Dense((num_heads, hd, features), (features,), init, features,
                         in_dims=2, kernel_init=out_kernel_init)

    def project(self, x):
        """``(query, key, value)``, each ``[b, s, heads, head_dim]`` in the
        module's dtype."""
        return self.query(x, self.dtype), self.key(x, self.dtype), self.value(x, self.dtype)

    def attend(self, fn, q, k, v, *, mask=None, deterministic=None, dropout_rng=None):
        """``fn(q, k, v, **kwargs)`` with flax's keywords, filtered by
        ``fn``'s signature."""
        # flax asks for `deterministic` only when the module drops.
        det = True if self.dropout_rate == 0.0 else bool(deterministic)
        kwargs = dict(mask=mask, dropout_rng=dropout_rng, dropout_rate=self.dropout_rate,
                      deterministic=det, dtype=self.dtype)
        names = inspect.signature(fn).parameters
        return fn(q, k, v, **{k_: v_ for k_, v_ in kwargs.items() if k_ in names})

    def forward(self, inputs_q, *, mask=None, deterministic=None, dropout_rng=None):
        if self.dropout_rate > 0.0 and deterministic is None:
            raise ValueError("deterministic must be given when dropout_rate > 0")
        q, k, v = self.project(inputs_q)
        o = self.attend(self.attention_fn or dot_product_attention, q, k, v, mask=mask,
                        deterministic=deterministic, dropout_rng=dropout_rng)
        return self.out(o, self.dtype)
