"""Quick-start MLP.

Counterpart of :class:`fluxmpi_tpu.models.mlp.MLP` (the reference README's
example model): a Dense chain with gelu between layers, regressing
``y = x^2`` in the quick start. Parameters keep flax's names and layouts
(``dense_{i}.kernel [in, out]``, ``dense_{i}.bias [out]``), so
:func:`~fluxmpi_tpu_torch.models.load_flax_params` copies the JAX
module's weights in. flax infers the input width at its first call; here
it is ``in_features``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import resolve_device
from .transformer import Dense, _Init

__all__ = ["MLP"]


class MLP(nn.Module):
    """Dense chain ``in_features → features[0] → … → features[-1]`` with
    flax's gelu (the tanh form) after every layer but the last. Weights
    are drawn from the CPU ``generator`` (default seeded with 0) on
    ``device`` (default CUDA; ``"cpu"`` only when asked)."""

    def __init__(self, features: Sequence[int] = (16, 16, 16, 1), *,
                 in_features: int = 1, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.features = tuple(features)
        width = in_features
        for i, out in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense((width, out), (out,), init, width))
            width = out

    def forward(self, x):
        x = torch.as_tensor(x, device=self.device).float()
        for i in range(len(self.features)):
            x = getattr(self, f"dense_{i}")(x, torch.float32)
            if i < len(self.features) - 1:
                x = F.gelu(x, approximate="tanh")
        return x
