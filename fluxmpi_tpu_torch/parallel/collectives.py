"""In-step collectives over a mesh axis.

Counterpart of :mod:`fluxmpi_tpu.parallel.collectives`: the helpers a
per-worker step body calls (the compiled-side analogue of the eager
:mod:`fluxmpi_tpu_torch.comm`). ``axis_name`` names an axis (or a tuple of
axes) of the runtime's mesh (:func:`fluxmpi_tpu_torch.global_mesh`); each
collective runs over the process group of the workers that differ only
along it, through ``torch.distributed.nn.functional`` so that autograd
differentiates the sum, mean, broadcast and product as JAX does.
"""

from __future__ import annotations

from typing import Any

from .. import config
from .._collective_ops import allreduce_by_op, masked_psum_bcast

__all__ = ["pallreduce", "pbroadcast", "pmean_tree", "psum_tree"]


def _axis(axis_name: Any) -> tuple[Any, int, int]:
    """``(group, size, index)`` of this worker along ``axis_name``."""
    from ..runtime import global_mesh

    mesh = global_mesh()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    missing = [n for n in names if n not in mesh.shape]
    if missing:
        raise ValueError(f"unbound axis name {missing[0]!r}: the mesh has "
                         f"axes {tuple(mesh.axis_names)}")
    size = mesh.group_size(names)
    index, _ = mesh.block_index(mesh.my_rank(), names)
    return mesh.group(names), size, index


def psum_tree(tree: Any, axis_name: str | None = None) -> Any:
    """Sum a tree of tensors across a mesh axis (the reference's per-leaf
    ``allreduce!(+)``)."""
    group, size, _ = _axis(axis_name or config.DP_AXIS_NAME)
    return allreduce_by_op(tree, "sum", group, size)


def pmean_tree(tree: Any, axis_name: str | None = None) -> Any:
    """Mean-reduce a tree of tensors across a mesh axis."""
    group, size, _ = _axis(axis_name or config.DP_AXIS_NAME)
    return allreduce_by_op(tree, "mean", group, size)


def pallreduce(x: Any, op: str = "sum", axis_name: str | None = None) -> Any:
    """All-reduce with a named op (``sum``/``+``, ``mean``/``avg``,
    ``max``, ``min``, ``prod``/``*``/``mul``); ``prod`` is an all-gather
    and a local product."""
    aliases = {"+": "sum", "avg": "mean", "*": "prod", "mul": "prod"}
    group, size, _ = _axis(axis_name or config.DP_AXIS_NAME)
    return allreduce_by_op(x, aliases.get(op, op), group, size)


def pbroadcast(x: Any, root: int = 0, axis_name: str | None = None) -> Any:
    """Broadcast the ``root`` member's value across a mesh axis (the
    reference's ``bcast!``) as one masked all-reduce."""
    group, size, index = _axis(axis_name or config.DP_AXIS_NAME)
    return masked_psum_bcast(x, root, group, index)
