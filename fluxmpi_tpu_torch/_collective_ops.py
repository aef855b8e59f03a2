"""Shared in-step collective lowerings.

Counterpart of :mod:`fluxmpi_tpu._collective_ops`: the masked-sum
broadcast (one O(bytes) all-reduce, no all-gather) and the named-op
all-reduce with the gather-based ``prod``, over one process group. They go
through ``torch.distributed.nn.functional``, so autograd sees them where
the JAX lowering is differentiable: the sum, mean, broadcast and product;
``max``/``min`` raise in the backward, as JAX's ``pmax``/``pmin`` have no
differentiation rule.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn
from torch.utils import _pytree as pytree

__all__ = ["allreduce_by_op", "masked_psum_bcast"]

_EXTREMA = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _Extremum(torch.autograd.Function):
    """``max``/``min`` all-reduce; no gradient, as in JAX."""

    @staticmethod
    def forward(ctx, tensor, op, group):
        ctx.op = op
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_EXTREMA[op], group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"Differentiation rule for 'p{ctx.op}' not implemented")


def _sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    if group is None:
        return x
    if not x.requires_grad:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out
    return dfn.all_reduce(x, group=group)


def masked_psum_bcast(x: Any, root: int, group: Any, index: int) -> Any:
    """Broadcast member ``root``'s value over ``group`` (this worker is
    member ``index``) as one all-reduce: the other members contribute
    exact zeros. Bools ride through int32."""

    def leaf(t):
        t = torch.as_tensor(t)
        as_bool = t.dtype == torch.bool
        ti = t.to(torch.int32) if as_bool else t
        keep = torch.tensor(index == root, device=ti.device)
        out = _sum(torch.where(keep, ti, torch.zeros_like(ti)), group)
        return out.to(torch.bool) if as_bool else out

    return pytree.tree_map(leaf, x)


def allreduce_by_op(x: Any, op: str, group: Any, size: int) -> Any:
    """All-reduce ``x`` (a tensor or a tree) with the named op over
    ``group`` of ``size`` members: ``sum``, ``mean``, ``max``, ``min``
    natively, ``prod`` as an all-gather and a local product."""
    if op == "sum":
        return pytree.tree_map(lambda t: _sum(t, group), x)
    if op == "mean":
        return pytree.tree_map(lambda t: _sum(t, group) / size, x)
    if op in _EXTREMA:
        return pytree.tree_map(
            lambda t: t if group is None else _Extremum.apply(t, op, group), x)
    if op == "prod":
        def prod(t):
            if group is None:
                return t
            parts = dfn.all_gather(t.contiguous(), group=group)
            return torch.stack(parts).prod(dim=0)

        return pytree.tree_map(prod, x)
    raise ValueError(f"unsupported in-trace reduction {op!r}")
