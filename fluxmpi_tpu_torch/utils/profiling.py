"""Honest step timing (the ported part of
:mod:`fluxmpi_tpu.utils.profiling`: :func:`step_timer` and
:func:`block_on`).

PyTorch launches a step's kernels asynchronously and returns, so a host
clock read right after the call measures the launch, not the work.
:func:`step_timer` stops its clock only after the outputs are complete
on the card (the ``MPI.Waitall!`` of timing); :func:`block_on` waits for
a tree of tensors.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

import torch
from torch.utils import _pytree as pytree

__all__ = ["block_on", "step_timer"]


def _cuda_devices(tree: Any) -> set[torch.device]:
    return {leaf.device for leaf in pytree.tree_leaves(tree)
            if torch.is_tensor(leaf) and leaf.is_cuda}


class _TimerHandle:
    def __init__(self) -> None:
        self._watched: list[Any] = []

    def watch(self, tree: Any) -> Any:
        """Register outputs to wait for before the clock stops (returns the
        tree for inline use: ``out = t.watch(step(...))``)."""
        self._watched.append(tree)
        return tree


@contextlib.contextmanager
def step_timer(
    result_holder: dict,
    key: str = "seconds",
    *,
    metric: str | None = None,
    registry: Any | None = None,
) -> Iterator[_TimerHandle]:
    """Time the enclosed block including the device work it launched.

    Register the block's outputs with ``handle.watch(out)``: the timer
    waits until the devices they live on have finished every kernel
    launched so far (which includes the outputs) before it stops the
    clock. With nothing watched it waits for the current CUDA device,
    if CUDA is in use. The elapsed seconds land in
    ``result_holder[key]``.

    ``metric="train.step_seconds"`` additionally observes the elapsed
    time into a telemetry histogram of that name (on ``registry``, or the
    default :func:`fluxmpi_tpu_torch.telemetry.get_registry` when
    omitted)."""
    handle = _TimerHandle()
    t0 = time.perf_counter()
    yield handle
    if handle._watched:
        devices = _cuda_devices(handle._watched)
    elif torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    else:
        devices = set()
    for dev in devices:
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    result_holder[key] = elapsed
    if metric is not None:
        if registry is None:
            from ..telemetry import get_registry

            registry = get_registry()
        registry.histogram(metric).observe(elapsed)


def block_on(tree: Any) -> Any:
    """Wait until every CUDA tensor in ``tree`` is computed (the timing
    analogue of ``MPI.Waitall!``). Returns the tree."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree
