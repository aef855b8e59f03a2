"""Make every worker's state the root worker's.

Counterpart of :func:`fluxmpi_tpu.synchronize` (the reference's
``synchronize!``): after initialization diverges per worker (a model built
from a per-rank seed, an optimizer's fresh state), one call makes every
worker hold the root's values.

The two adapters of :mod:`fluxmpi_tpu.sync`: :class:`FluxModelWrapper`
marks an arbitrary object whose public attributes hold the state (the
reference's ``FluxMPIFluxModel``), and :class:`FlatParamVector` holds a
whole parameter tree in one flat buffer (the reference's ComponentArray
path), a ``torch.utils._pytree`` node whose only leaf is that buffer, so a
collective over it is one collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from .comm import _check_root, _staging, eager
from .runtime import _require_init, _state

__all__ = ["FlatParamVector", "FluxModelWrapper", "synchronize"]


def _sync_tree(tree: Any, root: int) -> Any:
    leaves, spec = pytree.tree_flatten(tree)
    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    tensors = [x for x, t in zip(leaves, is_tensor) if t]
    others = [x for x, t in zip(leaves, is_tensor) if not t]
    synced = eager(tensors, lambda flat, group=None: dist.broadcast(
        flat, src=root, group=group)) if tensors else []
    if others:
        # Scalars and other objects (an optimizer's step counts and
        # hyperparameters) travel in one object broadcast.
        dist.broadcast_object_list(
            others, src=root, group=_state.host_group if _staging() else None)
    it_t, it_o = iter(synced), iter(others)
    out = [next(it_t) if t else next(it_o) for t in is_tensor]
    return pytree.tree_unflatten(out, spec)


def synchronize(tree: Any, *, root_rank: int = 0) -> Any:
    """Every worker returns the ``root_rank`` worker's values.

    ``tree`` is an ``nn.Module`` (its parameters and buffers are
    overwritten in place; the module is returned), a
    ``torch.optim.Optimizer`` (its state is loaded from the root's), or a
    state dict, an optimizer's state dict or any nested dict/list/tuple of
    tensors (a new tree is returned; non-tensor leaves are taken from the
    root as they are). Tensor leaves are fused into one flat broadcast per
    dtype, staged through host memory when device collectives are disabled
    (:mod:`fluxmpi_tpu_torch.comm`)."""
    _require_init()
    root = _check_root(root_rank)
    if isinstance(tree, FluxModelWrapper):
        return FluxModelWrapper(_sync_object(tree.model, root))
    if isinstance(tree, nn.Module):
        state = tree.state_dict(keep_vars=True)
        synced = _sync_tree({k: v.detach() for k, v in state.items()}, root)
        with torch.no_grad():
            for name, t in state.items():
                t.copy_(synced[name])
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        tree.load_state_dict(_sync_tree(tree.state_dict(), root))
        return tree
    return _sync_tree(tree, root)


@dataclasses.dataclass
class FluxModelWrapper:
    """Marker wrapper for an object that is not a tree (a user class whose
    attributes hold the state): ``synchronize(FluxModelWrapper(obj))``
    walks ``obj``'s public attributes, to depth 32, into nested plain
    objects, and synchronizes every other attribute as a tree (an
    ``nn.Module`` attribute's parameters and buffers in place, tensors and
    nested containers of them, scalars); it returns a wrapper of the same
    object."""

    model: Any


def _plain_object(value: Any) -> bool:
    """An object walked attribute by attribute: one with attributes that
    is not a tree node, a tensor, a module or an optimizer."""
    return (hasattr(value, "__dict__") and pytree.tree_is_leaf(value)
            and not isinstance(value, (torch.Tensor, nn.Module, torch.optim.Optimizer)))


def _sync_object(obj: Any, root: int, _depth: int = 0) -> Any:
    if _depth > 32:
        return obj
    if not _plain_object(obj):
        return synchronize(obj, root_rank=root)
    for name, value in vars(obj).items():
        if name.startswith("_"):
            continue
        if _plain_object(value):
            setattr(obj, name, _sync_object(value, root, _depth + 1))
        else:
            setattr(obj, name, synchronize(value, root_rank=root))
    return obj


class FlatParamVector:
    """A parameter tree flattened into one contiguous 1-D tensor ``flat``
    (the leaves' common dtype); :meth:`to_tree` gives the tree back with
    each leaf's shape and dtype. A collective over it (``synchronize``, an
    all-reduce of its gradient) is one collective for the whole tree."""

    def __init__(self, flat: torch.Tensor, shapes, treedef, sizes, dtypes=None) -> None:
        self.flat = flat
        self._shapes = tuple(shapes)
        self._treedef = treedef
        self._sizes = tuple(sizes)
        self._dtypes = None if dtypes is None else tuple(dtypes)

    @classmethod
    def from_tree(cls, tree: Any) -> "FlatParamVector":
        leaves, treedef = pytree.tree_flatten(tree)
        tensors = [torch.as_tensor(leaf) for leaf in leaves]
        flat = (torch.cat([t.reshape(-1) for t in tensors]) if tensors
                else torch.zeros((0,)))
        return cls(flat, [t.shape for t in tensors], treedef,
                   [t.numel() for t in tensors], [t.dtype for t in tensors])

    def to_tree(self) -> Any:
        leaves, offset = [], 0
        dtypes = self._dtypes or [self.flat.dtype] * len(self._sizes)
        for shape, size, dtype in zip(self._shapes, self._sizes, dtypes):
            leaves.append(self.flat[offset:offset + size].reshape(shape).to(dtype))
            offset += size
        return pytree.tree_unflatten(leaves, self._treedef)

    def __len__(self) -> int:
        return int(self.flat.shape[0])


pytree.register_pytree_node(
    FlatParamVector,
    lambda v: ([v.flat], (v._shapes, v._treedef, v._sizes, v._dtypes)),
    lambda children, aux: FlatParamVector(children[0], *aux),
    serialized_type_name="fluxmpi_tpu_torch.sync.FlatParamVector",
)
