"""Gradient all-reduce for data-parallel training.

Counterpart of :func:`fluxmpi_tpu.allreduce_gradients` and
:func:`fluxmpi_tpu.DistributedOptimizer` (the reference's
``allreduce_gradients`` and ``DistributedOptimizer``). Gradients are
**summed** across workers by default, as the reference does (scale the
loss by ``1 / total_workers()``), or averaged with ``reduce_op="mean"``;
the leaves travel as one flat collective per dtype.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from .comm import _all_reduce, _axis, fused
from .optim import GradientTransformation
from .runtime import _require_init, _state

__all__ = ["DistributedOptimizer", "allreduce_gradients"]


def allreduce_gradients(grads: Any, *, axis_name: str | None = None,
                        reduce_op: str = "sum") -> Any:
    """All-reduce a gradient tree (a dict, list or tuple of tensors)
    across the workers and return the reduced tree; or, given an
    ``nn.Module``, reduce its parameters' ``.grad`` in place and return
    the module. ``axis_name``: reduce over that axis of the global mesh
    only (the workers that differ only along it), as the JAX package's
    ``psum`` over a bound axis; default the whole world."""
    if reduce_op not in ("sum", "mean"):
        raise ValueError("reduce_op must be 'sum' or 'mean'")
    _require_init()
    axis = _axis(None, axis_name) if axis_name is not None else None
    size = _state.world if axis is None else axis.size

    def run(flat):
        _all_reduce(flat, "sum", axis)
        if reduce_op == "mean":
            flat.div_(size)

    if isinstance(grads, nn.Module):
        params = [p for p in grads.parameters() if p.grad is not None]
        reduced = fused([p.grad for p in params], run)
        with torch.no_grad():
            for p, g in zip(params, reduced):
                p.grad.copy_(g)
        return grads
    return fused(grads, run)


class DistributedOptimizerState(NamedTuple):
    inner: Any


def DistributedOptimizer(optimizer: GradientTransformation, *,
                         axis_name: str | None = None,
                         reduce_op: str = "sum") -> GradientTransformation:
    """Wrap an :mod:`fluxmpi_tpu_torch.optim` rule so that its incoming
    gradients are all-reduced across the workers (summed unless
    ``reduce_op="mean"``; over one mesh axis with ``axis_name``, as
    :func:`allreduce_gradients`) before the inner update. Use it with
    ``make_train_step(grad_reduce=None)`` so gradients are not reduced
    twice."""
    if reduce_op not in ("sum", "mean"):
        raise ValueError("reduce_op must be 'sum' or 'mean'")

    def init(params):
        return DistributedOptimizerState(inner=optimizer.init(params))

    def update(grads, state, params=None):
        grads = allreduce_gradients(grads, axis_name=axis_name, reduce_op=reduce_op)
        updates, inner = optimizer.update(grads, state.inner, params)
        return updates, DistributedOptimizerState(inner=inner)

    return GradientTransformation(init, update)
