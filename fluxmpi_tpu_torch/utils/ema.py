"""Exponential moving average of a parameter tree.

Counterpart of :mod:`fluxmpi_tpu.utils.ema`: the running mean accumulates
in (at least) f32 whatever the parameters' dtype (with bf16 parameters
and decay 0.999 a bf16 accumulator would stop moving), the decay is
recorded in the state at :func:`ema_init`, and :func:`ema_params` applies
Adam's ``1 - decay**count`` debias. The state's tensors live on the
parameters' device and :func:`ema_update` runs there with no host read,
so it can sit inside a captured CUDA graph; the state is a pytree of
tensors and checkpoints like any other.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["EMAState", "ema_init", "ema_params", "ema_update"]


class EMAState(NamedTuple):
    """Running average and bookkeeping: ``mean`` (the parameters' tree in
    f32 or wider), ``count`` (int32 scalar) and ``decay`` (f32 scalar,
    fixed at :func:`ema_init`)."""

    mean: Any
    count: torch.Tensor
    decay: torch.Tensor


def _device(tree) -> torch.device:
    leaves = [t for t in pytree.tree_leaves(tree) if torch.is_tensor(t)]
    return leaves[0].device if leaves else torch.device("cpu")


def ema_init(params, decay: float = 0.999) -> EMAState:
    """Start an EMA at zero with count 0 (the debias makes the zero start
    exact: after one update :func:`ema_params` returns the parameters)."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    dev = _device(params)
    zeros = pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
                              device=p.device), params)
    return EMAState(mean=zeros, count=torch.zeros((), dtype=torch.int32, device=dev),
                    decay=torch.tensor(decay, dtype=torch.float32, device=dev))


def ema_update(state: EMAState, params) -> EMAState:
    """One step: ``mean <- decay * mean + (1 - decay) * params`` (in the
    accumulator's dtype; the decay comes from the state)."""
    d = state.decay
    mean = pytree.tree_map(
        lambda m, p: d * m + (1.0 - d) * p.detach().to(m.dtype), state.mean, params)
    return EMAState(mean=mean, count=state.count + 1, decay=d)


def ema_params(state: EMAState):
    """The debiased average, ``mean / (1 - decay**count)``. Raises before
    any update (the debias would divide by zero); the check reads the count
    on the host, so it is skipped while a CUDA graph is being captured,
    where the caller owns that invariant."""
    dev = state.count.device
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing and int(state.count) == 0:
        raise ValueError("ema_params before any ema_update")
    corr = 1.0 - state.decay ** state.count.to(torch.float32)
    return pytree.tree_map(lambda m: m / corr.to(m.dtype), state.mean)
