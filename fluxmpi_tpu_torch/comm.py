"""Collectives over the data-parallel world.

Counterpart of the eager collectives of :mod:`fluxmpi_tpu.comm` (the
reference's ``allreduce!``, ``bcast!``, ``reduce!``, ``Iallreduce!``,
``Ibcast!`` and ``MPI.Barrier``), on ``torch.distributed``: NCCL between
GPUs, gloo on the CPU. Each worker passes its own value: a tensor, or a
nested dict/list/tuple of tensors (numpy arrays and Python numbers are
taken as tensors). The leaves of a tree travel as one flat collective per
dtype, so the number of collectives does not grow with the number of
leaves. Results are new tensors on the leaves' own devices and dtypes; the
inputs are left as they were, unless ``donate=True`` hands them over.

The non-blocking :func:`iallreduce` and :func:`ibcast` start the same
collectives as ``torch.distributed`` work handles (``async_op=True``) and
return a :class:`Request`. The ``host_*`` collectives take and give numpy
arrays, one value per process, over a gloo group (the default group on the
CPU, a gloo group beside NCCL on the card), so they never touch the card.
:func:`cpu` and :func:`device` move tensors and numpy arrays between the
host and the worker's device.

Each collective checks its fault site (``comm.allreduce``, ``comm.bcast``,
``comm.reduce``, ``comm.barrier``, ``comm.host_*``) before it runs.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import faults
from .errors import CollectiveError
from .runtime import _require_init, _state, resolve_device

__all__ = ["Request", "allreduce", "barrier", "bcast", "cpu", "device",
           "host_allgather", "host_allreduce", "host_bcast", "iallreduce",
           "ibcast", "reduce"]

_OP_ALIASES = {
    "+": "sum", "sum": "sum", "add": "sum",
    "*": "prod", "prod": "prod", "mul": "prod",
    "min": "min", "max": "max",
    "mean": "mean", "avg": "mean",
}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "mean": dist.ReduceOp.SUM}
_NUMPY_OPS = {"sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max,
              "mean": np.mean}


def cpu(x: Any) -> Any:
    """A tensor moved to host memory, a numpy array as it is; anything
    else unchanged (the reference's ``cpu``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def device(x: Any, d: Any = None) -> Any:
    """A tensor or numpy array moved to device ``d`` (default: the
    worker's device after :func:`~fluxmpi_tpu_torch.init`, else
    ``cuda:0``); anything else unchanged (the reference's ``gpu``)."""
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    if d is None:
        d = _state.device if _state.initialized else resolve_device(None)
    return torch.as_tensor(x).to(d)


def _canonical_op(op: str) -> str:
    try:
        return _OP_ALIASES[op]
    except (KeyError, TypeError):
        raise ValueError(
            f"unsupported reduction op {op!r}; expected one of "
            f"{sorted(set(_OP_ALIASES))}"
        ) from None


def _check_root(root: int) -> int:
    world = _state.world
    if not isinstance(root, (int, np.integer)) or not 0 <= root < world:
        raise ValueError(f"root {root!r} out of range for {world} worker(s)")
    return int(root)


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        return torch.as_tensor(leaf)
    raise CollectiveError(
        f"collectives take tensors, numpy arrays or numbers, not "
        f"{type(leaf).__name__}"
    )


class _Packed:
    """A tree's leaves packed into one flat buffer per dtype on ``dev``
    (dtypes in a fixed order, so every worker's collectives line up), and
    the tree of results: views of the buffers where a leaf lives on
    ``dev``, else tensors filled by :meth:`finish`."""

    def __init__(self, tree: Any, dev: torch.device):
        leaves, self.spec = pytree.tree_flatten(tree)
        tensors = [_as_tensor(x) for x in leaves]
        groups: dict[torch.dtype, list[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        self.flats: list[torch.Tensor] = []
        self.out: list[Any] = [None] * len(tensors)
        self._copies: list[tuple[torch.Tensor, torch.Tensor]] = []
        for dtype in sorted(groups, key=str):
            idxs = groups[dtype]
            flat = torch.cat([tensors[i].detach().reshape(-1).to(dev) for i in idxs])
            offset = 0
            for i in idxs:
                t = tensors[i]
                view = flat[offset:offset + t.numel()].reshape(t.shape)
                if t.device == dev:
                    self.out[i] = view
                else:
                    self.out[i] = torch.empty_like(t)
                    self._copies.append((self.out[i], view))
                offset += t.numel()
            self.flats.append(flat)

    def finish(self) -> Any:
        for dst, src in self._copies:
            dst.copy_(src)
        return pytree.tree_unflatten(self.out, self.spec)


def _run(flat: torch.Tensor, fn: Callable[[torch.Tensor], Any]) -> Any:
    try:
        return fn(flat)
    except RuntimeError as exc:
        raise CollectiveError(f"collective on {flat.dtype} leaves failed: {exc}") from exc


def fused(tree: Any, fn: Callable[[torch.Tensor], None]) -> Any:
    """Run the in-place collective ``fn`` on one flat buffer per dtype,
    on the worker's device, holding copies of ``tree``'s leaves; returns
    the tree of results, each leaf on its own device and dtype."""
    packed = _Packed(tree, _state.device)
    for flat in packed.flats:
        _run(flat, fn)
    return packed.finish()


def _collective(x: Any, fn: Callable[[torch.Tensor], None], donate: bool) -> Any:
    """Run the in-place collective ``fn(flat)`` over ``x``: on one
    flat buffer per dtype (a new result tree), or, with ``donate=True``,
    on each leaf in place (one collective per leaf, no copy; ``x`` itself
    is returned, its leaves contiguous tensors on the worker's device)."""
    dev = _state.device
    if donate:
        leaves = pytree.tree_leaves(x)
        for leaf in leaves:
            if (not isinstance(leaf, torch.Tensor) or leaf.device != dev
                    or not leaf.is_contiguous()):
                raise ValueError(
                    f"donate=True needs contiguous tensors on the worker's "
                    f"device ({dev}); got "
                    + (f"a tensor on {leaf.device}" if isinstance(leaf, torch.Tensor)
                       else type(leaf).__name__))
        with torch.no_grad():
            for leaf in leaves:
                _run(leaf, fn)
        return x
    return fused(x, fn)


def _mean_fix(flat: torch.Tensor, world: int) -> None:
    if flat.is_floating_point():
        flat.div_(world)
    else:
        flat.floor_divide_(world)


def allreduce(x: Any, op: str = "sum", *, donate: bool = False) -> Any:
    """Every worker gets the reduction (``sum``, ``prod``, ``min``,
    ``max`` or ``mean``) of all workers' values. ``donate=True`` reduces
    each leaf (a contiguous tensor on the worker's device) in place and
    returns ``x`` itself."""
    _require_init()
    op = _canonical_op(op)
    if faults.ARMED:
        faults.check("comm.allreduce")
    world = _state.world

    def run(flat):
        dist.all_reduce(flat, op=_REDUCE_OPS[op])
        if op == "mean":
            _mean_fix(flat, world)

    return _collective(x, run, donate)


def bcast(x: Any, root: int = 0, *, donate: bool = False) -> Any:
    """Every worker gets the ``root`` worker's value. ``donate=True``
    broadcasts into each leaf in place and returns ``x`` itself."""
    _require_init()
    root = _check_root(root)
    if faults.ARMED:
        faults.check("comm.bcast")
    return _collective(x, lambda flat: dist.broadcast(flat, src=root), donate)


def reduce(x: Any, op: str = "sum", root: int = 0, *,
           donate: bool = False) -> Any:
    """The ``root`` worker gets the reduction of all workers' values;
    every other worker gets its own input back. ``donate=True`` reduces
    into the root's leaves in place and returns ``x`` itself on every
    worker (the others' values unchanged)."""
    _require_init()
    op = _canonical_op(op)
    root = _check_root(root)
    if faults.ARMED:
        faults.check("comm.reduce")
    world, rank = _state.world, _state.rank

    def run(flat):
        # An all-reduce whose result only the root keeps: a rooted reduce
        # may use the other workers' buffers as scratch, which their
        # donated inputs forbid.
        own = None if rank == root else flat.clone()
        dist.all_reduce(flat, op=_REDUCE_OPS[op])
        if own is not None:
            flat.copy_(own)
        elif op == "mean":
            _mean_fix(flat, world)

    return _collective(x, run, donate)


class Request:
    """Completion handle of :func:`iallreduce` and :func:`ibcast` (the
    reference's ``MPI.Request``): ``wait()`` waits on the collectives'
    ``torch.distributed`` work handles (on the card, the current stream
    waits for NCCL's) and returns ``value``, the result tree, which holds
    the result from then on."""

    def __init__(self, value: Any) -> None:
        self._value = value
        self._pending: tuple | None = None

    def wait(self) -> Any:
        if self._pending is not None:
            packed, works, post = self._pending
            for work in works:
                work.wait()
            if post is not None:
                for flat in packed.flats:
                    post(flat)
            packed.finish()
            self._pending = None
        return self._value

    @staticmethod
    def wait_all(requests: "list[Request]") -> list[Any]:
        return [r.wait() for r in requests]


def _start(x: Any, fn: Callable[[torch.Tensor], Any],
           post: Callable | None = None) -> tuple[Any, Request]:
    """Start ``fn(flat)`` (an ``async_op=True`` collective) on each flat
    buffer of ``x``; returns the result tree and its request."""
    packed = _Packed(x, _state.device)
    works = [_run(flat, fn) for flat in packed.flats]
    value = pytree.tree_unflatten(packed.out, packed.spec)
    req = Request(value)
    req._pending = (packed, works, post)
    return value, req


def iallreduce(x: Any, op: str = "sum") -> tuple[Any, Request]:
    """Non-blocking all-reduce: returns ``(value, request)`` at once; the
    value holds the reduction once ``request.wait()`` returns (the
    reference's ``Iallreduce!``)."""
    _require_init()
    op = _canonical_op(op)
    if faults.ARMED:
        faults.check("comm.allreduce")
    world = _state.world
    post = (lambda flat: _mean_fix(flat, world)) if op == "mean" else None
    return _start(x, lambda flat: dist.all_reduce(flat, op=_REDUCE_OPS[op], async_op=True),
                  post)


def ibcast(x: Any, root: int = 0) -> tuple[Any, Request]:
    """Non-blocking broadcast from ``root`` (the reference's ``Ibcast!``)."""
    _require_init()
    root = _check_root(root)
    if faults.ARMED:
        faults.check("comm.bcast")
    return _start(x, lambda flat: dist.broadcast(flat, src=root, async_op=True))


def barrier(tag: str = "fluxmpi_barrier") -> None:
    """Block until every worker reaches this point (device work queued
    before it included). ``tag`` names the barrier."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.barrier")
    if _state.device.type == "cuda":
        torch.cuda.synchronize(_state.device)
    dist.barrier()


def _host_gathered(h: np.ndarray) -> np.ndarray:
    """Every process's ``h`` stacked on a new leading axis, over the gloo
    group."""
    t = torch.from_numpy(np.ascontiguousarray(h))
    parts = [torch.empty_like(t) for _ in range(_state.world)]
    try:
        dist.all_gather(parts, t, group=_state.host_group)
    except RuntimeError as exc:
        raise CollectiveError(f"host collective failed: {exc}") from exc
    return torch.stack(parts).numpy()


def host_allreduce(x: Any, op: str = "sum") -> np.ndarray:
    """Reduce a per-process host value across all processes: numpy's
    reduction (``sum``, ``prod``, ``min``, ``max``, ``mean``) over the
    gathered values, in the input's dtype (``mean`` of integers in
    numpy's float)."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_allreduce")
    op = _canonical_op(op)
    h = np.asarray(x)
    if _state.world == 1:
        return h
    out = _NUMPY_OPS[op](_host_gathered(h), axis=0)
    return np.asarray(out if op == "mean" else out.astype(h.dtype, copy=False))


def host_allgather(x: Any) -> np.ndarray:
    """Gather a per-process host value from every process: an array with a
    leading ``process_count()`` axis (this process's value at its own
    index)."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_allgather")
    h = np.asarray(x)
    if _state.world == 1:
        return h[None]
    return _host_gathered(h)


def host_bcast(x: Any, root: int = 0) -> np.ndarray:
    """Broadcast a per-process host value from the ``root`` process to
    all."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_bcast")
    root = _check_root(root)
    h = np.asarray(x)
    if _state.world == 1:
        return h
    t = torch.from_numpy(np.array(h, copy=True))
    try:
        dist.broadcast(t, src=root, group=_state.host_group)
    except RuntimeError as exc:
        raise CollectiveError(f"host collective failed: {exc}") from exc
    return t.numpy()
