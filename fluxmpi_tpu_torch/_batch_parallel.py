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

The JAX step's random draws are the global batch's too: a key draws one
value per global row whatever the device count. Under the batch axes the
port's draws are made so (ROADMAP C.32):

- a generator draw (the DDPM loss's timesteps and noise, the MoE router's
  noise, ViT's embedding dropout) is drawn whole, at the global batch's
  shape, and each worker keeps its rows (:func:`draw`): a worker draws what
  one worker holding the whole batch draws;
- the counter-based dropout hash of the flash kernels and of the dense
  attend keys each row and head by its place in the whole batch
  (:func:`place`): the first row is this worker's block index times
  its rows, and under a tensor-parallel head split (:class:`heads`) the
  first head is this worker's.

A pipeline stage keeps its own draws (JAX's pipeline runs in a
``shard_map`` body over ``pp``), as do the ring and Ulysses attends, which
call the kernels themselves.

``style="shard_map"`` enters none: JAX's ``shard_map`` body is per device.
Under ``remat=`` the recompute re-enters the forward's context (it runs
on autograd's device thread on the card), and the DEQ's backward carries
the forward's group itself.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn

__all__ = ["BatchAxes", "active", "current", "draw", "heads", "place", "reduce_max"]

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


def _drawing() -> BatchAxes | None:
    """The batch axes whose global draws this worker takes its block of:
    the active ones, but none inside a pipeline stage."""
    from . import _sequence_parallel

    seq = _sequence_parallel.current()
    return None if seq is not None and seq.stage else current()


def draw(make: Callable[[tuple], torch.Tensor], shape: Sequence[int],
         cuts: Sequence[tuple[int, int, int]] = ()) -> torch.Tensor:
    """This worker's block ``shape`` of a random draw over the global
    batch: ``make(whole)`` draws the whole (``shape``'s leading axis times
    the batch axes' size, and each ``(dim, index, count)`` of ``cuts``
    another axis cut into ``count`` blocks, this worker's the ``index``-th),
    and the block is sliced out of it. Without batch axes or cuts it is
    ``make(shape)``."""
    shape, cuts = tuple(shape), list(cuts)
    rows = _drawing()
    if rows is not None:
        cuts.insert(0, (0, rows.index, rows.size))
    if not cuts:
        return make(shape)
    whole = list(shape)
    for dim, _, count in cuts:
        whole[dim] *= count
    out = make(tuple(whole))
    for dim, index, _ in cuts:
        out = out.narrow(dim, index * shape[dim], shape[dim])
    return out


def place(b: int, h: int) -> tuple[int, int, int]:
    """``(b0, h0, heads)`` of an attention over ``b`` rows and ``h`` heads
    of this worker: its first row, its first head and the head count in
    the whole batch's grid of the counter-based dropout hash
    (:func:`~fluxmpi_tpu_torch.ops.flash_attention.hash_rows`). ``(0, 0,
    h)`` without batch axes or a head split."""
    rows = _drawing()
    h0, heads_ = getattr(_local, "heads", None) or (0, h)
    return (rows.index * b if rows is not None else 0), h0, heads_


class heads:
    """``with heads(h0, total):`` the attention inside computes heads
    ``h0 ..`` of ``total``: a tensor-parallel worker's head block, whose
    dropout hash keys the whole batch's heads (:func:`place`)."""

    def __init__(self, h0: int, total: int):
        self.block = (int(h0), int(total))

    def __enter__(self):
        self.prev = getattr(_local, "heads", None)
        _local.heads = self.block
        return self

    def __exit__(self, *exc):
        _local.heads = self.prev
        return False
