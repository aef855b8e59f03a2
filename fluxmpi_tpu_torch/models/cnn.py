"""CIFAR-10 CNN with BatchNorm (BASELINE config 2).

Counterpart of :class:`fluxmpi_tpu.models.cnn.CNN`: Conv 3x3 (no bias)
-> BatchNorm -> relu -> 2x2 max pool, once per entry of ``channels``,
then the global mean and an f32 Dense head, over NHWC inputs. The
parameters keep flax's names and layouts (``conv_{i}.kernel`` HWIO,
``bn_{i}.scale``/``bias``, ``head.kernel``/``bias``); the BatchNorm
running statistics are the model state, a dict keyed by flax path
(``bn_{i}.mean``/``var``; :meth:`CNN.init_batch_stats`), passed in and
returned by a training forward as flax's ``mutable=["batch_stats"]`` does.

Batch statistics in training: with ``axis_name`` set, over the whole
data-parallel world (sync-BN); without it, inside the default
``style="auto"`` train step over the global batch (every worker's rows,
as the JAX package's ``"auto"`` step normalizes whatever ``axis_name``
is), and under ``style="shard_map"`` or a bare forward over the worker's
own batch.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import resolve_device
from ._layers import (BatchNorm, Conv, StatsContext, at_least_f32, init_batch_stats,
                      max_pool, name_norms)
from .transformer import Dense, _Init

__all__ = ["CNN"]


class CNN(nn.Module):
    """Conv(3x3)-BN-relu x len(channels) with max-pooling, then a Dense
    head. ``forward(x, batch_stats, train=True)`` returns ``(logits,
    new_batch_stats)``; with ``train=False``, the logits from the running
    statistics. Weights from the CPU ``generator`` (default seeded with 0)
    on ``device`` (default CUDA; ``"cpu"`` only when asked);
    ``in_features`` is the input's channel count (flax infers it)."""

    def __init__(self, num_classes: int = 10,
                 channels: Sequence[int] = (32, 64, 128),
                 dtype: torch.dtype = torch.float32, axis_name: str | None = None,
                 *, in_features: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.num_classes, self.channels = num_classes, tuple(channels)
        self.dtype, self.axis_name = dtype, axis_name
        width = in_features
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv_{i}", Conv(width, ch, (3, 3), init=init, dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(ch, init=init, dtype=dtype,
                                                 axis_name=axis_name))
            width = ch
        self.head = Dense((width, num_classes), (num_classes,), init, width)
        name_norms(self)

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        """The initial running statistics (means 0, variances 1)."""
        return init_batch_stats(self)

    def forward(self, x, batch_stats: dict, *, train: bool = True):
        ctx = StatsContext(batch_stats, train)
        x = torch.as_tensor(x, device=self.device).permute(0, 3, 1, 2).to(self.dtype)
        for i in range(len(self.channels)):
            x = getattr(self, f"conv_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x, ctx))
            x = max_pool(x, (2, 2), (2, 2))
        # jnp.mean of a bf16 tensor sums in f32 and rounds once.
        x = at_least_f32(x).mean((2, 3)).to(self.dtype)
        logits = self.head(x, torch.float32)
        return (logits, ctx.new) if train else logits
