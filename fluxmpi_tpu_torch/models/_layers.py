"""Convolution, BatchNorm and pooling as flax 0.12 computes them, for the
vision models (:mod:`.cnn`, :mod:`.resnet`).

The models take NHWC inputs, as in JAX, and run on NCHW views of them: a
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
  ``-inf``, as ``lax.reduce_window`` does.
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
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import runtime
from .transformer import _Init

__all__ = ["BatchNorm", "Conv", "StatsContext", "at_least_f32", "init_batch_stats", "max_pool",
           "name_norms", "same_pads"]


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
    """``flax.linen.Conv(features, kernel_size, strides, padding="SAME",
    use_bias=False, dtype=dtype)`` on NCHW tensors: input and kernel cast
    to ``dtype``, the output in ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), *, init: _Init, dtype=torch.float32):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = lecun_normal(init, (kh, kw, in_features, features),
                                   kh * kw * in_features)
        self.strides = tuple(strides)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.permute(3, 2, 0, 1).to(self.dtype,
                                              memory_format=torch.channels_last)
        x = x.to(self.dtype)
        pads = same_pads(x.shape[2:], w.shape[2:], self.strides)
        if all(lo == hi for lo, hi in pads):
            return F.conv2d(x, w, stride=self.strides, padding=[lo for lo, _ in pads])
        return F.conv2d(_pad(x, pads), w, stride=self.strides)


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
    ``path`` is the module's name in its model (:func:`name_norms`)."""

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
