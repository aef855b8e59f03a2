"""The mesh axes bound around a running computation: the sequence- and
pipeline-parallel axes.

The JAX package binds a mesh axis by running inside ``shard_map``; the
port's counterpart is a context. :func:`bound` answers, for an axis name,
whether this worker computes on one block of what is sharded over that
axis, and where along it: under an active :class:`SequenceParallel` (the
``style="auto"`` step over a plan with ``sp`` or ``pp``, or the eager
wrappers ``make_ring_attention``, ``make_ulysses_attention`` and
``make_pipeline_fn``) its mesh decides; otherwise the runtime's mesh does,
when it has the axis. An unbound sequence axis means the whole sequence
is local (the n = 1 ring).

Under the step's context with an ``sp`` axis the port's transformer layers
run their attention as a ring over it with global positions, and the step
checks that the loss entered a sequence-parallel attention: ``entered``
counts the ring and Ulysses attends that bound the context's ``sp``
axis. A pipeline stage runs under a context of its own (``stage=True``,
no ``sp``): the pipeline replicates every axis but ``pp``, as the JAX
package's ``shard_map`` over ``pp`` does.
"""

from __future__ import annotations

import threading
from typing import Any

from ._collective_ops import MeshAxis

__all__ = ["SequenceParallel", "active", "bound", "current"]

_local = threading.local()


class SequenceParallel:
    """The mesh of the running computation, and its axis ``sp`` (or None)
    over which the sequences are sharded; ``entered`` counts the
    sequence-parallel attends that ran over ``sp``; ``stage``: the
    computation is a pipeline stage."""

    def __init__(self, mesh: Any, sp: str | None = None, stage: bool = False):
        self.mesh = mesh
        self.sp = sp
        self.stage = stage
        self.entered = 0
        self._axes: dict[str, MeshAxis] = {}

    def axis(self, name: str) -> MeshAxis:
        if name not in self._axes:
            self._axes[name] = MeshAxis(self.mesh, name)
        return self._axes[name]


def current() -> SequenceParallel | None:
    """The active sequence-parallel context, or None."""
    return getattr(_local, "sp", None)


def bound(name: str) -> MeshAxis | None:
    """The axis ``name`` as this worker sees it (its size and index), or
    None when it is not bound (no active context and no runtime mesh
    with that axis)."""
    ctx = current()
    if ctx is not None and name in ctx.mesh.shape:
        if name == ctx.sp:
            ctx.entered += 1
        return ctx.axis(name)
    from . import runtime

    if runtime.is_initialized():
        mesh = runtime.global_mesh()
        if name in mesh.shape:
            return MeshAxis(mesh, name)
    return None


class active:
    """``with active(sp):`` installs ``sp`` (or nothing, for None) as the
    running computation's sequence-parallel context."""

    def __init__(self, sp: SequenceParallel | None):
        self.sp = sp

    def __enter__(self):
        self.prev = current()
        _local.sp = self.sp
        return self.sp

    def __exit__(self, *exc):
        _local.sp = self.prev
        return False
