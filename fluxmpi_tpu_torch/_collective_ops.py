"""Shared in-step collective lowerings.

Counterpart of :mod:`fluxmpi_tpu._collective_ops`: the masked-sum
broadcast (one O(bytes) all-reduce, no all-gather) and the named-op
all-reduce with the gather-based ``prod``, over one process group. They go
through ``torch.distributed.nn.functional``, so autograd sees them where
the JAX lowering is differentiable: the sum, mean, broadcast and product;
``max``/``min`` raise in the backward, as JAX's ``pmax``/``pmin`` have no
differentiation rule.

Beside them, the exchanges of the sequence- and pipeline-parallel
schedules over one mesh axis: :class:`Exchanges`, the counterpart of
``jax.lax.ppermute`` (point-to-point sends along a permutation, one
``batch_isend_irecv`` for a tuple of tensors, the cotangents sent back
along the reversed permutation), and :func:`shard_along` /
:func:`unshard_along`, the step between a replicated tensor and this
worker's block of it that the eager wrappers take.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn
from torch.utils import _pytree as pytree

__all__ = ["Exchanges", "MeshAxis", "allreduce_by_op", "masked_psum_bcast",
           "shard_along", "sum_shared", "unshard_along"]

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


# -- neighbour exchange over one mesh axis (``jax.lax.ppermute``) ------


class MeshAxis:
    """One axis of a mesh as this worker sees it: its ``name``, ``size``,
    this worker's ``index`` along it and the world rank of each member
    (``ranks[j]``: the worker that shares every other coordinate with this
    one and sits at ``j`` on the axis)."""

    def __init__(self, mesh: Any, name: str):
        me = mesh.my_rank()
        coords = mesh.coords(me)
        self.mesh, self.name = mesh, name
        self.size = int(mesh.shape[name])
        self.index = coords[name]
        dims = list(mesh.axis_names)
        self.ranks = []
        for j in range(self.size):
            at = [coords[a] for a in dims]
            at[dims.index(name)] = j
            self.ranks.append(int(mesh.devices[tuple(at)]))

    @property
    def group(self) -> Any:
        """The axis's process group (made collectively on first use)."""
        return self.mesh.group((self.name,))


def _send_recv(axis: MeshAxis, perms: Any, tensors: Any) -> list:
    """Each tensor sent along its permutation (``[(src, dst)]`` pairs of
    axis indices) in one ``batch_isend_irecv``; a member that receives
    nothing gets zeros."""
    me, ops, outs = axis.index, [], []
    for tag, (t, perm) in enumerate(zip(tensors, perms)):
        t = t.contiguous()
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if dst == [me]:
            outs.append(t.clone())
            continue
        out = torch.empty_like(t) if src else torch.zeros_like(t)
        if dst:
            ops.append(dist.P2POp(dist.isend, t, axis.ranks[dst[0]], tag=tag))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, axis.ranks[src[0]], tag=tag))
        outs.append(out)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _Permute(torch.autograd.Function):
    """``(chain, *tensors) -> (chain, *received)``: one exchange of every
    tensor along its permutation; the backward sends each floating
    tensor's cotangent along the reversed permutation in one exchange.
    ``chain`` is a scalar token threaded through every exchange of one
    schedule (see :func:`ppermute`)."""

    @staticmethod
    def forward(ctx, axis, perms, chain, *tensors):
        ctx.axis, ctx.perms = axis, perms
        ctx.floating = [t.is_floating_point() for t in tensors]
        outs = _send_recv(axis, perms, tensors)
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floating) if not f])
        return (chain.clone(), *outs)

    @staticmethod
    def backward(ctx, gchain, *grads):
        idx = [i for i, f in enumerate(ctx.floating) if f]
        back = [[(d, s) for s, d in ctx.perms[i]] for i in idx]
        sent = _send_recv(ctx.axis, back, [grads[i] for i in idx])
        out = [None] * len(grads)
        for i, g in zip(idx, sent):
            out[i] = g
        return (None, None, gchain, *out)


class _Anchor(torch.autograd.Function):
    """A scalar zero that depends on ``tensors``: the first token of an
    exchange chain. Its backward hands them no gradient."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.n = len(tensors)
        return torch.zeros((), dtype=torch.float32, device=tensors[0].device)

    @staticmethod
    def backward(ctx, g):
        return (None,) * ctx.n


class _Attach(torch.autograd.Function):
    """``x`` unchanged, with the chain token as a second input: the
    backward reaches every exchange of the chain from ``x``'s
    cotangent."""

    @staticmethod
    def forward(ctx, x, chain):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


class Exchanges:
    """The neighbour exchanges of one schedule over ``axis``, the
    counterpart of ``jax.lax.ppermute``: ``xs(tensors, perms)`` sends
    each tensor of the tuple along its permutation (``[(src, dst)]`` axis
    indices; a member that receives nothing gets zeros) in one
    ``batch_isend_irecv``, differentiably: the backward sends the
    cotangents along the reversed permutations.

    Every exchange of a schedule rides one chain: a scalar token that
    starts at the schedule's inputs (``start``) and that :meth:`attach`
    ties to its output. So each worker's backward runs every exchange,
    whether or not its own compute read what arrived, and runs them in
    the reverse order of the forward: blocking point-to-point operations
    then meet in the same order on every worker. A schedule must make
    the same exchanges in the same order on every member of the axis."""

    def __init__(self, axis: MeshAxis, start: Any):
        self.axis = axis
        grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in start)
        device = start[0].device
        self.chain = (_Anchor.apply(*start) if grad
                      else torch.zeros((), dtype=torch.float32, device=device))

    def __call__(self, tensors: Any, perms: Any) -> tuple:
        if len(perms) != len(tensors):
            raise ValueError("one permutation per tensor")
        self.chain, *out = _Permute.apply(self.axis, [list(p) for p in perms],
                                          self.chain, *tensors)
        return tuple(out)

    def attach(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, tied to the chain (its backward runs the exchanges)."""
        if not self.chain.requires_grad:
            return x
        return _Attach.apply(x, self.chain)


# -- replicated <-> sharded along one axis ------------------------------


class _Shard(torch.autograd.Function):
    """This member's block of each replicated tensor along its dim; the
    backward all-gathers the blocks' cotangents (one all-gather per
    dtype), so every member gets the cotangent of each whole tensor, as
    JAX's global arrays do."""

    @staticmethod
    def forward(ctx, axis, dims, *xs):
        ctx.axis, ctx.dims = axis, dims
        ctx.floating = [x.is_floating_point() for x in xs]
        outs = [x.chunk(axis.size, d)[axis.index].clone() for x, d in zip(xs, dims)]
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floating) if not f])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n, out = ctx.axis.size, [None] * len(grads)
        by_dtype: dict = {}
        for i, (g, f) in enumerate(zip(grads, ctx.floating)):
            if f:
                by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=ctx.axis.group)
            at = 0
            for i in idx:
                size, shape = grads[i].numel(), grads[i].shape
                out[i] = torch.cat([p[at:at + size].reshape(shape) for p in parts],
                                   ctx.dims[i])
                at += size
        return (None, None, *out)


class _Unshard(torch.autograd.Function):
    """The whole tensor from every member's block along ``dim``; the
    backward keeps this member's block of the cotangent (every member
    computes the same function of the whole)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index].contiguous(), None, None


class _SumShared(torch.autograd.Function):
    """The sum over an axis of every member's ``x``, for a sum that every
    member's loss reads alike (the MoE layers' group statistics under
    sequence parallelism): the forward all-reduces; the backward hands
    each member ``size`` times its own cotangent, which is what the
    all-reduce's backward (a sum of the members' cotangents) gives when
    they are equal, with no collective in the backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.size = axis.size
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def sum_shared(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x`` summed over ``axis``, differentiable for a sum that every
    member's loss reads alike (see :class:`_SumShared`)."""
    return _SumShared.apply(x, axis) if axis.size > 1 else x


def shard_along(xs: Any, axis: MeshAxis, dims: Any) -> tuple:
    """This worker's block of each replicated tensor of ``xs`` along its
    dim of ``dims`` (one backward all-gather for them all)."""
    if axis.size == 1:
        return tuple(xs)
    return tuple(_Shard.apply(axis, list(dims), *xs))


def unshard_along(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The whole tensor from every member's block of it along ``dim``."""
    return _Unshard.apply(x, axis, dim) if axis.size > 1 else x
