"""Tensor-parallel compute for the transformer layers inside a layout step.

Under a plan with ``tp > 1`` the ``style="auto"`` step runs the loss inside
a :class:`TensorParallel` context over the mesh's tp axis. The port's
transformer layers (:class:`~fluxmpi_tpu_torch.models.transformer.EncoderBlock`,
:class:`~fluxmpi_tpu_torch.models.transformer.TransformerLM` and the MoE
models built on them) then compute on this worker's blocks of the leaves
``transformer_tp_rules`` shards, as Megatron-LM splits a transformer and
as the JAX package's partitioner splits the same layout:

- Q/K/V project with this worker's heads (``[d, h/tp, hd]``) and the
  attention runs over those heads; ``ff1`` is column-parallel;
- the attention's out projection (``[h/tp, hd, d]``) and ``ff2``
  (``[d_ff/tp, d]``) give partial sums, summed by one all-reduce each over
  the tp group (:meth:`TensorParallel.reduce`, Megatron's "g"); their
  biases are added once, after the sum;
- the input of each column-parallel product goes through
  :meth:`TensorParallel.enter` (Megatron's "f": the identity forward, an
  all-reduce of the gradient in the backward), so the gradients of the
  replicated LayerNorms and biases are whole on every worker;
- the embedding is vocab-parallel: a masked lookup of this worker's rows
  and an all-reduce; the tied head is the vocab-parallel cross-entropy.

A layer computes split when its weights arrive with their block shapes.
The step decides which leaves it hands over as blocks: in its first update
it gathers every sharded leaf (the whole-weight compute every loss can
run), the layers note, through :meth:`TensorParallel.claim`, the leaves
they would consume as blocks, and :meth:`TensorParallel.watch` notes every
leaf that anything else in the loss reads (code outside the layers'
:func:`owned` regions: a penalty on the weights, a custom head). From the
second update on a claimed group is handed over as blocks only when no
leaf of it has such a reader; the rest stay gathered, so every expression
of the loss sees the whole leaf, as in the JAX package's partitioned step.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

__all__ = ["TensorParallel", "current", "owned", "owning", "require"]

# Functions that read a tensor's metadata, not its values.
_METADATA = {"size", "dim", "numel", "is_floating_point", "is_complex", "element_size",
             "data_ptr", "stride", "is_contiguous", "storage_offset", "__len__",
             "__get__"}

_local = threading.local()


class _Enter(torch.autograd.Function):
    """Megatron's "f": identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """The tp axis of a layout step's mesh: its process group, size and
    this worker's index along it. ``names`` (the first update only) maps
    the tensors the loss was handed to their state-dict names, and
    ``claims`` collects the ``(name, dim)`` groups the layers would take as
    blocks split along ``dim``."""

    def __init__(self, mesh: Any, axis: str, names: dict[int, str] | None = None):
        self.mesh = mesh
        self.axis = axis
        self.size = int(mesh.shape[axis])
        self.index = mesh.block_index(mesh.my_rank(), axis)[0]
        self.group = mesh.group((axis,))
        self.names = names
        self.claims: list[list[tuple[str, int]]] = []
        self.outside: set[str] = set()
        self.depth = 0

    def note(self, params: dict) -> None:
        """Name the tensors of ``params`` (a dict keyed by state-dict name,
        such as the compute-dtype casts a policy hands the loss) while the
        step is collecting claims."""
        if self.names is not None:
            self.names.update({id(t): k for k, t in params.items()
                               if torch.is_tensor(t)})

    def claim(self, weights: Sequence[tuple[torch.Tensor, int]]) -> None:
        """Note that a layer computes on ``weights`` (each ``(tensor,
        dim)``) and would take them as blocks split along ``dim``. A group
        holding a tensor the step did not hand the loss is not noted."""
        if self.names is None:
            return
        names = [self.names.get(id(t)) for t, _ in weights]
        if None not in names:
            self.claims.append([(n, d) for n, (_, d) in zip(names, weights)])

    def watch(self) -> TorchFunctionMode:
        """A mode that, while the step collects claims, notes in
        ``outside`` the name of every handed tensor that a function reads
        outside the layers' :func:`owned` regions."""
        return _ReadWatch(self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product (identity; its gradient
        is summed over the tp group)."""
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the tp group of a row-parallel product's partial
        results (its gradient passes through)."""
        return _Reduce.apply(x, self.group)


class _ReadWatch(TorchFunctionMode):
    def __init__(self, tp: TensorParallel):
        super().__init__()
        self.tp = tp

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tp = self.tp
        if tp.depth == 0 and tp.names and getattr(func, "__name__", "") not in _METADATA:
            for a in torch.utils._pytree.tree_leaves((args, kwargs)):
                if torch.is_tensor(a):
                    name = tp.names.get(id(a))
                    if name is not None:
                        tp.outside.add(name)
        return func(*args, **kwargs)


class owned:
    """``with owned():`` marks code that handles the tensor-parallel blocks
    itself (the transformer layers, the step's own casts): its reads of
    the parameters are not a loss's own reads."""

    def __enter__(self):
        self.tp = current()
        if self.tp is not None:
            self.tp.depth += 1
        return self

    def __exit__(self, *exc):
        if self.tp is not None:
            self.tp.depth -= 1
        return False


def owning(method):
    """Decorate a layer method that handles the blocks itself: its body
    runs in an :class:`owned` region."""
    @functools.wraps(method)
    def wrapped(*args, **kwargs):
        with owned():
            return method(*args, **kwargs)

    return wrapped


def current() -> TensorParallel | None:
    """The tensor-parallel context of the running layout step, or None."""
    return getattr(_local, "tp", None)


def require(what: str) -> TensorParallel:
    """:func:`current`, raising when there is none: ``what`` arrived as a
    tensor-parallel block outside a layout step."""
    tp = current()
    if tp is None:
        raise ValueError(
            f"{what} holds a tensor-parallel block (its shape is the tp "
            f"slice of the layer's), which only a layout step's tp context "
            f"computes on; gather the parameters first")
    return tp


class active:
    """``with active(tp):`` installs ``tp`` (or nothing, for None) as the
    running step's context."""

    def __init__(self, tp: TensorParallel | None):
        self.tp = tp

    def __enter__(self):
        self.prev = current()
        _local.tp = self.tp
        return self.tp

    def __exit__(self, *exc):
        _local.tp = self.prev
        return False
