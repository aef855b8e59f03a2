"""Data-parallel train and eval steps.

Counterpart of :mod:`fluxmpi_tpu.parallel.train` in its explicit
per-worker form (the JAX package's ``style="shard_map"``, the reference's
training loop): each worker runs forward and backward on its local shard
of the batch, the gradients are all-reduced across the workers in one
flat collective per dtype (``grad_reduce="mean"`` by default, ``"sum"``,
or ``None`` when a :func:`~fluxmpi_tpu_torch.DistributedOptimizer`
reduces them), and the optimizer rule updates the parameters in place.
PyTorch runs eagerly, so the step is a plain Python function; its
kernels launch asynchronously and the returned loss stays on the device.

Not ported yet (each raises ``NotImplementedError`` when passed):
``parallel=``, ``mesh=``, ``axis_name=``, ``style=``, ``state_reduce=``,
``donate=``,
``state_sharding=``, ``batch_spec=``, ``remat=``, ``policy=``,
``metrics=`` and ``model_stats=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..optim import GradientTransformation, apply_updates
from ..optimizer import allreduce_gradients

__all__ = ["TrainState", "make_eval_step", "make_train_step"]

_WAITING = ("parallel", "mesh", "axis_name", "style", "state_reduce",
            "donate", "state_sharding", "batch_spec", "remat", "policy",
            "metrics", "model_stats")


def _refuse_waiting(fn: str, waiting: dict) -> None:
    unknown = [k for k in waiting if k not in _WAITING]
    if unknown:
        raise TypeError(f"{fn}() got unexpected arguments {unknown}")
    passed = sorted(k for k, v in waiting.items()
                    if v is not None and v is not False)
    if passed:
        raise NotImplementedError(
            f"{fn}({', '.join(passed)}=...) is not ported yet: the port's "
            f"step is one worker's forward, backward and gradient all-reduce "
            f"over torch.distributed")


@dataclasses.dataclass
class TrainState:
    """Training state: the update count, the parameters (a dict of the
    model's parameter tensors, keyed by state-dict name, which the step
    updates in place), the optimizer state and the mutable model state."""

    step: int
    params: dict
    opt_state: Any
    model_state: Any = None

    @classmethod
    def create(cls, params: Any, optimizer: GradientTransformation,
               model_state: Any = None) -> "TrainState":
        """``params``: an ``nn.Module`` (its named parameters) or a dict of
        tensors."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        return cls(step=0, params=dict(params),
                   opt_state=optimizer.init(params), model_state=model_state)


def _split(batch: Any, k: int) -> list[Any]:
    """``k`` micro-batches along each leaf's leading dimension."""
    leaves, spec = pytree.tree_flatten(batch)
    for x in leaves:
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"grad_accum_steps {k}")
    parts = [x.chunk(k) for x in leaves]
    return [pytree.tree_unflatten([p[i] for p in parts], spec) for i in range(k)]


def make_train_step(
    loss_fn: Callable[[dict, Any, Any], tuple[torch.Tensor, Any]],
    optimizer: GradientTransformation,
    *,
    grad_reduce: str | None = "mean",
    grad_accum_steps: int = 1,
    scan_steps: int = 1,
    **waiting,
) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """Build ``step(state, batch) -> (state, loss)``.

    ``loss_fn(params, model_state, batch) -> (loss, new_model_state)``
    computes this worker's scalar loss on its local batch (stateless
    models return ``None``; the new model state stays each worker's own).
    ``grad_reduce``: ``"mean"`` averages the gradients and the loss over
    the workers, ``"sum"`` sums them, ``None`` leaves them local.
    ``grad_accum_steps=k`` splits each batch into ``k`` micro-batches and
    averages their gradients before the one update. ``scan_steps=K`` takes
    ``K`` batches stacked on a leading axis, runs ``K`` updates and returns
    the ``[K]`` losses. The parameters and optimizer state update in place;
    the returned loss is a detached tensor on the device (reading it
    synchronizes)."""
    _refuse_waiting("make_train_step", waiting)
    if grad_reduce not in ("mean", "sum", None):
        raise ValueError("grad_reduce must be 'mean', 'sum', or None")
    if grad_accum_steps < 1:
        raise ValueError("grad_accum_steps must be >= 1")
    if scan_steps < 1:
        raise ValueError("scan_steps must be >= 1")

    def grads_of(ts: TrainState, batch):
        keys = list(ts.params)
        vals = [ts.params[k] for k in keys]
        loss_sum, acc, mstate = None, None, ts.model_state
        for mb in _split(batch, grad_accum_steps) if grad_accum_steps > 1 else [batch]:
            loss, mstate = loss_fn(ts.params, mstate, mb)
            g = torch.autograd.grad(loss, vals, allow_unused=True)
            g = [torch.zeros_like(v) if x is None else x for x, v in zip(g, vals)]
            if acc is None:
                acc, loss_sum = g, loss.detach()
            else:
                torch._foreach_add_(acc, g)
                loss_sum = loss_sum + loss.detach()
        if grad_accum_steps > 1:
            torch._foreach_div_(acc, float(grad_accum_steps))
            loss_sum = loss_sum / grad_accum_steps
        return dict(zip(keys, acc)), loss_sum, mstate

    def single(ts: TrainState, batch):
        grads, loss, mstate = grads_of(ts, batch)
        if grad_reduce is not None:
            # The loss rides in the gradients' flat f32 collective.
            grads, loss = allreduce_gradients((grads, loss), reduce_op=grad_reduce)
        updates, ts.opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        apply_updates(ts.params, updates)
        ts.model_state = mstate
        ts.step += 1
        return ts, loss

    if scan_steps == 1:
        step = single
    else:
        def step(ts: TrainState, batches):
            losses = []
            for i in range(scan_steps):
                ts, loss = single(ts, pytree.tree_map(lambda x: x[i], batches))
                losses.append(loss)
            return ts, torch.stack(losses)

    step.scan_steps = scan_steps  # read by train_loop
    return step


def make_eval_step(metric_fn: Callable[[dict, Any, Any], Any], **waiting):
    """Build ``eval_step(state, batch) -> metrics``:
    ``metric_fn(params, model_state, batch)`` without autograd, on this
    worker's batch (reduce across workers with
    :func:`~fluxmpi_tpu_torch.allreduce` where a global value is
    wanted)."""
    _refuse_waiting("make_eval_step", waiting)

    def step(ts: TrainState, batch):
        with torch.no_grad():
            return metric_fn(ts.params, ts.model_state, batch)

    return step
