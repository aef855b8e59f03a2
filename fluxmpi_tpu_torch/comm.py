"""Collectives over the data-parallel world.

Counterpart of the eager collectives of :mod:`fluxmpi_tpu.comm` (the
reference's ``allreduce!``, ``bcast!``, ``reduce!`` and ``MPI.Barrier``),
on ``torch.distributed``: NCCL between GPUs, gloo on the CPU. Each worker
passes its own value: a tensor, or a nested dict/list/tuple of tensors
(numpy arrays and Python numbers are taken as tensors). The leaves of a
tree travel as one flat collective per dtype, so the number of collectives
does not grow with the number of leaves. Results are new tensors on the
leaves' own devices and dtypes; the inputs are left as they were.

Not ported yet: the non-blocking ``iallreduce``/``ibcast`` with their
``Request`` handles, and the ``host_*`` collectives.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .errors import CollectiveError, refuse_unported
from .runtime import _require_init, _state

__all__ = ["allreduce", "barrier", "bcast", "reduce"]

_OP_ALIASES = {
    "+": "sum", "sum": "sum", "add": "sum",
    "*": "prod", "prod": "prod", "mul": "prod",
    "min": "min", "max": "max",
    "mean": "mean", "avg": "mean",
}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "mean": dist.ReduceOp.SUM}


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


def fused(tree: Any, fn: Callable[[torch.Tensor], None]) -> Any:
    """Run the in-place collective ``fn`` on one flat buffer per dtype,
    on the worker's device, holding copies of ``tree``'s leaves; returns
    the tree of results, each leaf on its own device and dtype."""
    leaves, spec = pytree.tree_flatten(tree)
    tensors = [_as_tensor(x) for x in leaves]
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    out: list[Any] = [None] * len(tensors)
    dev = _state.device
    # Identical flatten order on every worker keeps the collectives aligned.
    for dtype in sorted(groups, key=str):
        idxs = groups[dtype]
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev) for i in idxs])
        try:
            fn(flat)
        except RuntimeError as exc:
            raise CollectiveError(f"collective on {dtype} leaves failed: {exc}") from exc
        offset = 0
        for i in idxs:
            t = tensors[i]
            out[i] = flat[offset:offset + t.numel()].reshape(t.shape).to(t.device)
            offset += t.numel()
    return pytree.tree_unflatten(out, spec)


def allreduce(x: Any, op: str = "sum", *, donate: bool = False) -> Any:
    """Every worker gets the reduction (``sum``, ``prod``, ``min``,
    ``max`` or ``mean``) of all workers' values. ``donate=True`` is not
    ported yet."""
    refuse_unported("allreduce", {"donate": donate})
    _require_init()
    op = _canonical_op(op)
    world = _state.world

    def run(flat):
        dist.all_reduce(flat, op=_REDUCE_OPS[op])
        if op == "mean":
            if flat.is_floating_point():
                flat.div_(world)
            else:
                flat.floor_divide_(world)

    return fused(x, run)


def bcast(x: Any, root: int = 0, *, donate: bool = False) -> Any:
    """Every worker gets the ``root`` worker's value. ``donate=True`` is
    not ported yet."""
    refuse_unported("bcast", {"donate": donate})
    _require_init()
    root = _check_root(root)
    return fused(x, lambda flat: dist.broadcast(flat, src=root))


def reduce(x: Any, op: str = "sum", root: int = 0, *,
           donate: bool = False) -> Any:
    """The ``root`` worker gets the reduction of all workers' values;
    every other worker gets its own input back. ``donate=True`` is not
    ported yet."""
    refuse_unported("reduce", {"donate": donate})
    _require_init()
    op = _canonical_op(op)
    root = _check_root(root)
    world = _state.world

    def run(flat):
        dist.reduce(flat, dst=root, op=_REDUCE_OPS[op])
        if op == "mean" and _state.rank == root:
            if flat.is_floating_point():
                flat.div_(world)
            else:
                flat.floor_divide_(world)

    out = fused(x, run)
    if _state.rank != root:
        return pytree.tree_map(lambda leaf: _as_tensor(leaf).clone(), x)
    return out


def barrier(tag: str = "fluxmpi_barrier") -> None:
    """Block until every worker reaches this point (device work queued
    before it included). ``tag`` is not ported yet."""
    refuse_unported("barrier", {"tag": tag != "fluxmpi_barrier"})
    _require_init()
    if _state.device.type == "cuda":
        torch.cuda.synchronize(_state.device)
    dist.barrier()
