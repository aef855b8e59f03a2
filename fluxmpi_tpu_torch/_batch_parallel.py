"""The batch axes bound around a running train step.

The JAX package's default ``style="auto"`` step computes the loss over the
global batch, so every layer that couples the rows of a batch couples all
of them: BatchNorm's statistics, the DEQ solvers' stopping test, the MoE
layer's explicit ``n_groups``. The port's ``style="auto"`` step hands each
worker's ``loss_fn`` its own rows, inside a :class:`BatchAxes` context
naming the workers whose rows make up the global batch (the ``dp`` and
``fsdp`` axes of a plan, the axes of the step's batch spec, or the whole
world without a plan). Those layers then couple every row the batch axes
hold:

- :class:`~fluxmpi_tpu_torch.models._layers.BatchNorm` (``axis_name=None``)
  averages its statistics over the group (a differentiable all-reduce);
- the DEQ solvers (:mod:`~fluxmpi_tpu_torch.models.deq`) take the MAX of
  each residual over the group before the freeze test;
- :class:`~fluxmpi_tpu_torch.models.MoEMLP` with ``n_groups`` routes its
  share of the global grouping.

``style="shard_map"`` enters none: JAX's ``shard_map`` body is per device.
Under ``remat=`` the recompute re-enters the forward's context (it runs
on autograd's device thread on the card), and the DEQ's backward carries
the forward's group itself.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn

__all__ = ["BatchAxes", "active", "current", "reduce_max"]

_local = threading.local()


class BatchAxes:
    """The workers that share this worker's coordinates on every mesh axis
    but ``axes`` (``mesh=None``: the whole world), ordered by their block
    index along ``axes`` (the first outermost): ``size`` of them, this
    worker ``index``, ``ranks[j]`` the world rank of member ``j``."""

    def __init__(self, mesh: Any = None, axes: Sequence[str] = ()):
        self.mesh, self.axes = mesh, tuple(axes)
        if mesh is None:
            self.size, self.index = dist.get_world_size(), dist.get_rank()
            self.ranks = list(range(self.size))
            return
        me = mesh.my_rank()
        self.index, self.size = mesh.block_index(me, self.axes)
        mine = mesh.coords(me)
        self.ranks = [0] * self.size
        for r in mesh.devices.flat:
            c = mesh.coords(int(r))
            if all(c[a] == mine[a] for a in mesh.axis_names if a not in self.axes):
                self.ranks[mesh.block_index(int(r), self.axes)[0]] = int(r)

    @property
    def group(self) -> Any:
        """The members' process group (made collectively on first use)."""
        if self.mesh is None:
            return dist.group.WORLD
        return self.mesh.group(self.axes)

    def with_axis(self, name: str) -> "BatchAxes":
        """These axes and ``name`` (innermost): the members of a batch that
        is also cut along ``name``."""
        if self.mesh is None:
            raise ValueError(f"axis {name!r} needs a mesh")
        return BatchAxes(self.mesh, self.axes + (name,))

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the members; the backward reduces too."""
        return dfn.all_reduce(t, group=self.group) / self.size

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The MAX of ``t`` over the members, on the device (no gradient,
        no host read)."""
        out = t.detach().reshape(1).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out.reshape(t.shape)


def current() -> BatchAxes | None:
    """The active batch axes, or None (one worker's rows are the batch)."""
    return getattr(_local, "batch", None)


def reduce_max(t: torch.Tensor, batch: BatchAxes | None) -> torch.Tensor:
    """``t``'s MAX over ``batch``'s members, or ``t`` without one."""
    return t if batch is None else batch.max(t)


class active:
    """``with active(batch):`` installs ``batch`` (or nothing, for None) as
    the running computation's batch axes."""

    def __init__(self, batch: BatchAxes | None):
        self.batch = batch

    def __enter__(self):
        self.prev = current()
        _local.batch = self.batch
        return self.batch

    def __exit__(self, *exc):
        _local.batch = self.prev
        return False
