"""Pipeline parallelism: GPipe-style stage partitioning over a mesh axis.

Counterpart of :mod:`fluxmpi_tpu.parallel.pipeline`, with its schedule:

- every stage's parameters carry a leading ``n_stages`` dimension sharded
  over the ``pp`` axis (one stage per worker along that axis);
- the schedule runs ticks: each worker applies its stage to what arrived,
  and the activations hop to the next stage in a neighbour exchange
  (:class:`~fluxmpi_tpu_torch._collective_ops.Exchanges`, the counterpart
  of ``jax.lax.ppermute``);
- finished microbatches leave the last stage on a second, wrap-around
  "conveyor" exchange and are captured by their owning worker, so the
  output is **sharded over the pp axis** (each worker keeps its ``M/S``
  microbatches);
- with ``input_sharded`` the inputs are sharded too: each worker holds its
  own ``M/S`` microbatches, which travel to stage 0 just in time on a
  backward "feed" exchange;
- everything is differentiable: each exchange's backward sends the
  cotangents back along the reversed permutation.

With S stages and M microbatches the bubble is ``(S-1)/(M+S-1)``.
``remat_stages=True`` recomputes each stage call in the backward
(``torch.utils.checkpoint``). **Interleaved** (``interleave=v > 1``): each
worker owns ``v`` non-adjacent chunks of the layer stack (chunk ``c`` on
worker ``c mod S``) and the schedule runs ``v`` overlapping sweeps of
period ``P = max(M_pad, 3S-3)``: chunk ``q`` of microbatch ``m`` runs on
its worker at tick ``q·P + m + d``; a sweep's captured outputs are
re-injected on the feed exchange for the next. Total ticks:
:func:`pipeline_tick_count`.

Every mesh axis but ``pp`` replicates the pipeline, as the JAX package's
``shard_map`` over ``pp`` does: a stage runs under a context of its own
that binds no sequence-parallel axis and no tensor-parallel context (its
transformer layers compute on whole sequences and whole weights), and a
step over a plan with ``pp`` hands the loss whole sequences and gathers
the stage leaves that its rules lay out over ``tp`` or ``ep``
(:mod:`~fluxmpi_tpu_torch.parallel.train`). An ``MoEMLP`` built with
``mesh=`` raises inside a stage, as the JAX package's does.

The worker knows its stage and the tick on the host, so the JAX package's
``jnp.where`` selections become host branches, and a bubble tick (no
microbatch of the schedule at this stage) computes nothing. The exchanges
are never skipped: every worker makes the same exchanges in the same
order. The inter-stage activation must be uniform: ``stage_fn(params, x)
-> y`` with ``y.shape == x.shape`` and ``y.dtype == x.dtype``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as _checkpoint

from .. import _sequence_parallel as _sp
from .. import _tensor_parallel as _tp
from .._collective_ops import Exchanges, MeshAxis, shard_along, unshard_along
from .plan import plan_axis_name
from .sharding import P

__all__ = [
    "pipeline_apply",
    "make_pipeline_fn",
    "stack_stage_params",
    "pipeline_rules",
    "pipeline_tick_count",
]


def _schedule_period(m_pad: int, n_stages: int, interleave: int) -> int:
    """Sweep period of the interleaved schedule: ``3S-3`` is the
    worst-case conveyor-capture to feed-reinjection round trip, so a period
    of ``max(M_pad, 3S-3)`` has every chunk-``q`` output back with its
    owner before chunk ``q+1`` needs it. Plain GPipe (v=1) keeps
    P = M_pad."""
    if interleave == 1:
        return m_pad
    return max(m_pad, 3 * n_stages - 3)


def pipeline_tick_count(
    n_microbatches: int, n_stages: int, interleave: int = 1
) -> int:
    """Ticks one :func:`pipeline_apply` schedule runs (each worker does one
    chunk compute per tick, ``v·M_pad`` of them useful)."""
    m_pad = -(-n_microbatches // n_stages) * n_stages
    period = _schedule_period(m_pad, n_stages, interleave)
    return (interleave - 1) * period + m_pad + 2 * (n_stages - 1)


def _keystr(path) -> str:
    return "".join(f"[{getattr(k, 'key', getattr(k, 'idx', k))!r}]" for k in path)


def _check_stacked_leaves(tree: Any, expected_dim: int, what: str) -> None:
    """Every leaf must carry a leading stage dimension of ``expected_dim``;
    raise naming the offending leaf path (a Python scalar counts as rank
    0)."""
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0 or leaf.shape[0] != expected_dim:
            got = (
                "a scalar (rank 0)" if ndim == 0 else f"leading dim {leaf.shape[0]}"
            )
            raise ValueError(
                f"stacked stage leaf {_keystr(path)} has {got}, "
                f"expected {what} {expected_dim}: build the tree with "
                f"stack_stage_params over the per-stage parameter list"
            )


def stack_stage_params(
    stage_params_list: list[Any],
    *,
    n_stages: int | None = None,
    interleave: int = 1,
) -> Any:
    """Stack per-stage parameter trees into one tree whose leaves have a
    leading ``n_stages`` dimension (shard it over the ``pp`` axis).

    For the interleaved schedule pass ``interleave=v`` and ``n_stages=S``
    with the ``v·S`` chunks in natural layer order: they are stacked in
    **round-robin worker order** (worker d's block = chunks ``d, S+d,
    …``), the layout :func:`make_pipeline_fn` consumes, so the reorder
    happens once here and a stacked flax tree loads as it is."""
    chunks = list(stage_params_list)
    if interleave > 1:
        if n_stages is None:
            raise ValueError("interleave > 1 requires n_stages")
        if len(chunks) != n_stages * interleave:
            raise ValueError(
                f"expected n_stages·interleave = {n_stages * interleave} "
                f"chunks, got {len(chunks)}"
            )
        chunks = [
            chunks[q * n_stages + d]
            for d in range(n_stages)
            for q in range(interleave)
        ]
    return pytree.tree_map(lambda *leaves: torch.stack(leaves), *chunks)


def pipeline_rules(pp_axis: str | None = None):
    """Sharding rule for stacked stage parameters: leading (stage)
    dimension over the ``pp`` mesh axis, everything else replicated."""
    name = pp_axis or plan_axis_name("pp")

    def rule(path: str, shape: tuple[int, ...]):
        if not shape:
            return None
        return P(name, *([None] * (len(shape) - 1)))

    return rule


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    n_microbatches: int,
    axis_name: str | None = None,
    remat_stages: bool = False,
    input_sharded: bool = False,
    interleave: int = 1,
):
    """Run the stage-partitioned network over the bound ``pp`` axis (a
    step over a plan with ``pp``, :func:`make_pipeline_fn`, or the
    runtime's mesh).

    ``stacked_params`` leaves arrive stage-local (leading dim
    ``interleave``: this worker's chunks of the round-robin stack). ``x``
    is the full batch ``[B, ...]`` (``input_sharded=False``; ``B``
    divisible by ``n_microbatches``) or this worker's own microbatch block
    ``[M_pad/S · mb, ...]`` (``input_sharded=True``, with ``M_pad =
    ceil(M/S)·S``), whose microbatches ride the backward feed exchange to
    stage 0 just in time.

    ``interleave=v > 1`` (requires ``input_sharded``) runs the interleaved
    virtual-stage schedule (module docstring).

    Returns the **pp-sharded** local output block ``[M_pad/S · mb, ...]``:
    worker ``d`` holds microbatches ``[d·M_pad/S, (d+1)·M_pad/S)``.
    ``remat_stages=True`` recomputes each stage call in the backward.
    """
    axis_name = axis_name or plan_axis_name("pp")
    axis = _sp.bound(axis_name)
    if axis is None:
        raise NameError(f"unbound axis name: {axis_name}")
    n_stages, stage_idx = axis.size, axis.index
    v = int(interleave)
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if v > 1 and not input_sharded:
        raise ValueError(
            "interleave > 1 requires input_sharded=True (sweep outputs are "
            "re-fed from the pp-sharded accumulator)"
        )
    _check_stacked_leaves(
        stacked_params, v,
        f"local leading dim (the '{axis_name}'-axis shard of "
        f"{v}·n_stages chunks)",
    )
    stage_ctx = _sp.SequenceParallel(axis.mesh, stage=True)

    def staged(p, inp):
        # Every axis but pp replicates the pipeline (module docstring).
        with _sp.active(stage_ctx), _tp.active(None):
            return stage_fn(p, inp)

    fn = staged
    if remat_stages:
        def fn(p, inp):
            return _checkpoint.checkpoint(staged, p, inp, use_reentrant=False)

    chunks = [pytree.tree_map(lambda p, q=q: p[q], stacked_params) for q in range(v)]

    # Pad the microbatch grid to a multiple of S so every worker owns an
    # equal output block (padding microbatches are never captured).
    m_pad = -(-n_microbatches // n_stages) * n_stages
    per_dev = m_pad // n_stages
    period = _schedule_period(m_pad, n_stages, v)
    if input_sharded:
        if x.shape[0] % per_dev:
            raise ValueError(
                f"sharded input block {x.shape[0]} not divisible by the "
                f"{per_dev} microbatches each device owns"
            )
        mb = x.shape[0] // per_dev
    else:
        if x.shape[0] % n_microbatches:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by n_microbatches "
                f"{n_microbatches}"
            )
        mb = x.shape[0] // n_microbatches
    x_mb = x.reshape(-1, mb, *x.shape[1:]).unbind(0)
    shape = (mb, *x.shape[1:])

    n_ticks = (v - 1) * period + m_pad + 2 * (n_stages - 1)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    ring_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    back_perm = [(i, (i - 1) % n_stages) for i in range(n_stages)]
    perms = [fwd_perm, ring_perm] + ([back_perm] if input_sharded else [])
    hops = (stage_idx + 1) % n_stages  # conveyor distance from stage S-1
    xs = Exchanges(axis, (*pytree.tree_leaves(stacked_params), x))

    zeros = x.new_zeros(shape)
    act = conv = feed = zeros
    acc: list = [None] * per_dev
    for t in range(n_ticks):
        outgoing = None
        if input_sharded:
            # Feed: this worker's outgoing value is (sweep qf, microbatch
            # mf) with qf·P + mf = t + d, from its own storage when it owns
            # mf (sweep 0: the input block; later sweeps: the previous
            # sweep's captured output), else what arrived.
            g = t + stage_idx
            qf, mf = divmod(g, period)
            outgoing = feed
            if mf // per_dev == stage_idx and qf < v:
                local_g = mf - stage_idx * per_dev
                if qf == 0:
                    outgoing = x_mb[min(local_g, len(x_mb) - 1)]
                elif acc[local_g] is not None:
                    outgoing = acc[local_g]
                else:
                    outgoing = zeros
            inp = outgoing if stage_idx == 0 else act
        else:
            inp = x_mb[min(t, n_microbatches - 1)] if stage_idx == 0 else act
        # This tick's chunk (sweep q) and microbatch m; other ticks are
        # bubbles, whose output the schedule never captures.
        q = min(max((t - stage_idx) // period, 0), v - 1)
        m = t - stage_idx - q * period
        if 0 <= m < n_microbatches:
            out = fn(chunks[q], inp)
            if tuple(out.shape) != shape or out.dtype != x.dtype:
                raise ValueError(
                    f"stage_fn must preserve the activation shape and dtype: got "
                    f"{tuple(out.shape)}/{out.dtype} for input {shape}/{x.dtype}"
                )
        else:
            out = zeros
        # Capture: what arrives on this worker's conveyor this tick (the
        # last stage's own output) finished sweep qc at tick
        # qc·P + wc + (S-1) and rode `hops` hops.
        item = out if stage_idx == n_stages - 1 else conv
        tc = t - (n_stages - 1) - hops
        qc, wc = divmod(tc, period)
        if (tc >= 0 and qc < v and wc < n_microbatches
                and wc // per_dev == stage_idx):
            acc[wc - stage_idx * per_dev] = item
        if t < n_ticks - 1:
            sent = (out, item) + ((outgoing,) if input_sharded else ())
            act, conv, *rest = xs(sent, perms)
            if input_sharded:
                feed = rest[0]
    acc = [zeros if a is None else a for a in acc]
    return xs.attach(torch.cat(acc, dim=0))


def make_pipeline_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh=None,
    *,
    n_microbatches: int,
    axis_name: str | None = None,
    remat_stages: bool = False,
    interleave: int = 1,
):
    """Eager wrapper: ``fn(stacked_params, x) -> y`` over ``mesh`` (default
    the runtime's). Every worker passes the global ``x [B, ...]`` and gets
    the global ``y``; each worker runs its stage on its own ``M/S`` input
    microbatches (they reach stage 0 on the feed exchange), and the output
    is gathered back. ``stacked_params``: the stacked tree of all
    ``interleave·n_stages`` chunks (each worker takes its block), or this
    worker's block of it (leading dim ``interleave``, as a step over a
    plan with ``pp`` hands the loss its blocks). Differentiable: the
    gradient of a whole stacked tree or of ``x`` comes back whole on every
    worker, that of a block is this worker's.

    ``interleave=v > 1`` selects the interleaved virtual-stage schedule:
    the stacked tree then carries ``v·n_stages`` chunks in the
    **round-robin worker order** of ``stack_stage_params(chunks,
    n_stages=S, interleave=v)``."""
    from ..runtime import global_mesh

    axis_name = axis_name or plan_axis_name("pp")
    v = int(interleave)

    def fn(stacked_params, x):
        # Default: the mesh of an enclosing step over a plan with this
        # axis, else the runtime's.
        ctx = _sp.current()
        on = mesh or (ctx.mesh if ctx is not None and axis_name in ctx.mesh.shape
                      else global_mesh())
        n_stages = on.shape[axis_name]
        m_pad = -(-n_microbatches // n_stages) * n_stages
        n_chunks = v * n_stages
        axis = MeshAxis(on, axis_name)
        leaves, spec = pytree.tree_flatten(stacked_params)
        local = n_stages > 1 and bool(leaves) and all(
            getattr(t, "ndim", 0) and t.shape[0] == v for t in leaves)
        if not local:
            _check_stacked_leaves(
                stacked_params, n_chunks,
                f"leading dim == {'interleave·' if v > 1 else ''}n_stages"
            )
        if x.shape[0] % n_microbatches:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by n_microbatches "
                f"{n_microbatches}"
            )
        mb = x.shape[0] // n_microbatches
        # Pad the batch rows up to the M_pad microbatch grid so the pp
        # blocks are equal blocks of whole microbatches.
        pad_rows = (m_pad - n_microbatches) * mb
        x_padded = (torch.cat([x, x.new_zeros((pad_rows, *x.shape[1:]))])
                    if pad_rows else x)
        if local:
            (x_blk,) = shard_along((x_padded,), axis, [0])
        else:
            *leaves, x_blk = shard_along((*leaves, x_padded), axis,
                                         [0] * (len(leaves) + 1))
        params = pytree.tree_unflatten(list(leaves), spec)
        if ctx is None or ctx.mesh is not on:
            ctx = _sp.SequenceParallel(on)
        with _sp.active(ctx):
            y = pipeline_apply(
                stage_fn, params, x_blk, n_microbatches=n_microbatches,
                axis_name=axis_name, remat_stages=remat_stages,
                input_sharded=True, interleave=v)
        # Trim the microbatch padding.
        return unshard_along(y, axis, 0)[: x.shape[0]]

    return fn
