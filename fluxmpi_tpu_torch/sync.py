"""Make every worker's state the root worker's.

Counterpart of :func:`fluxmpi_tpu.synchronize` (the reference's
``synchronize!``): after initialization diverges per worker (a model built
from a per-rank seed, an optimizer's fresh state), one call makes every
worker hold the root's values.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from .comm import _check_root, fused
from .runtime import _require_init

__all__ = ["synchronize"]


def _sync_tree(tree: Any, root: int) -> Any:
    leaves, spec = pytree.tree_flatten(tree)
    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    tensors = [x for x, t in zip(leaves, is_tensor) if t]
    others = [x for x, t in zip(leaves, is_tensor) if not t]
    synced = fused(tensors, lambda flat: dist.broadcast(flat, src=root)) if tensors else []
    if others:
        # Scalars and other objects (an optimizer's step counts and
        # hyperparameters) travel in one object broadcast.
        dist.broadcast_object_list(others, src=root)
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
    dtype."""
    _require_init()
    root = _check_root(root_rank)
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
