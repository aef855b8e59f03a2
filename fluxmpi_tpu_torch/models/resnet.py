"""ResNet v1.5 (BASELINE config 3; ResNet-50 is the reference's headline
ImageNet workload).

Counterpart of :mod:`fluxmpi_tpu.models.resnet`: NHWC inputs, the stride
on the 3x3 conv of a bottleneck, a projection shortcut (1x1 conv + BN)
exactly where a block changes its shape (the channels or the stride; so
stage 0's first bottleneck gets one at stride 1, 64 -> 256 channels), the
last BatchNorm of every block zero-initialised, the 7x7/2 stem and 3x3/2
max pool with flax's ``"SAME"`` padding, the global mean and an f32 head.
``dtype=torch.bfloat16`` computes in bf16 with f32 parameters and
statistics. Names, layouts and the BatchNorm state as in :mod:`.cnn`
(``stage{i}_block{j}.conv1.kernel``, ``stage{i}_block{j}.bn1.mean``, ...).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import resolve_device
from ._layers import (BatchNorm, Conv, StatsContext, at_least_f32, init_batch_stats,
                      max_pool, name_norms)
from .transformer import Dense, _Init

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet101", "ResNet18",
           "ResNet34", "ResNet50"]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck with a projection shortcut
    on a change of shape. ``conv(in, out, kernel, strides)`` and
    ``norm(features[, scale_init=])`` build the layers; ``in_features`` is
    the input's channel count (flax infers it; default the block's output
    width, ``4 * filters``)."""

    def __init__(self, filters: int, strides, conv: Callable, norm: Callable,
                 act: Callable, *, in_features: int | None = None):
        super().__init__()
        self.act = act
        self.out_features = 4 * filters
        in_features = in_features or self.out_features
        self.conv1 = conv(in_features, filters, (1, 1))
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, (3, 3), strides)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, 4 * filters, (1, 1))
        self.bn3 = norm(4 * filters, scale_init=0.0)
        if in_features != 4 * filters or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, 4 * filters, (1, 1), strides)
            self.bn_proj = norm(4 * filters)

    def forward(self, x: torch.Tensor, ctx: StatsContext) -> torch.Tensor:
        residual = x
        y = self.act(self.bn1(self.conv1(x), ctx))
        y = self.act(self.bn2(self.conv2(y), ctx))
        y = self.bn3(self.conv3(y), ctx)
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(self.conv_proj(residual), ctx)
        return self.act(y + residual)


class BasicBlock(nn.Module):
    """3x3 (strided) -> 3x3 basic block (ResNet-18/34), projection as in
    :class:`BottleneckBlock` (``in_features`` default ``filters``)."""

    def __init__(self, filters: int, strides, conv: Callable, norm: Callable,
                 act: Callable, *, in_features: int | None = None):
        super().__init__()
        self.act = act
        self.out_features = filters
        in_features = in_features or self.out_features
        self.conv1 = conv(in_features, filters, (3, 3), strides)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, (3, 3))
        self.bn2 = norm(filters, scale_init=0.0)
        if in_features != filters or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.bn_proj = norm(filters)

    def forward(self, x: torch.Tensor, ctx: StatsContext) -> torch.Tensor:
        residual = x
        y = self.act(self.bn1(self.conv1(x), ctx))
        y = self.bn2(self.conv2(y), ctx)
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(self.conv_proj(residual), ctx)
        return self.act(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC inputs. ``forward(x, batch_stats,
    train=True)`` returns ``(logits, new_batch_stats)``; with
    ``train=False``, the logits from the running statistics. Weights from
    the CPU ``generator`` (default seeded with 0) on ``device`` (default
    CUDA; ``"cpu"`` only when asked)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type = BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, axis_name: str | None = None,
                 *, in_features: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.stage_sizes = tuple(stage_sizes)
        self.dtype, self.axis_name = dtype, axis_name
        conv = functools.partial(Conv, init=init, dtype=dtype)
        norm = functools.partial(BatchNorm, init=init, dtype=dtype, axis_name=axis_name)
        self.conv_init = conv(in_features, num_filters, (7, 7), (2, 2))
        self.bn_init = norm(num_filters)
        width = num_filters
        self.blocks = []
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                name = f"stage{i}_block{j}"
                block = block_cls(num_filters * 2 ** i, (2, 2) if i > 0 and j == 0 else (1, 1),
                                  conv, norm, F.relu, in_features=width)
                self.add_module(name, block)
                self.blocks.append(name)
                width = block.out_features
        self.head = Dense((width, num_classes), (num_classes,), init, width)
        name_norms(self)

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        """The initial running statistics (means 0, variances 1)."""
        return init_batch_stats(self)

    def forward(self, x, batch_stats: dict, *, train: bool = True):
        ctx = StatsContext(batch_stats, train)
        x = torch.as_tensor(x, device=self.device).permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x), ctx))
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for name in self.blocks:
            x = getattr(self, name)(x, ctx)
        # jnp.mean of a bf16 tensor sums in f32 and rounds once; the head
        # runs in f32 on it.
        x = at_least_f32(x).mean((2, 3)).to(self.dtype)
        logits = self.head(x, torch.float32)
        return (logits, ctx.new) if train else logits


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3))
