"""Data-parallel train and eval steps.

Counterpart of :mod:`fluxmpi_tpu.parallel.train` in its explicit
per-worker form (the JAX package's ``style="shard_map"``, the reference's
training loop): each worker runs forward and backward on its local shard
of the batch, the gradients are all-reduced across the workers in one
flat collective per dtype (``grad_reduce="mean"`` by default, ``"sum"``,
or ``None`` when a :func:`~fluxmpi_tpu_torch.DistributedOptimizer`
reduces them), and the optimizer rule updates the parameters in place.
Under the default ``style="auto"`` the layers that couple the rows of a
batch couple the global batch, as in JAX's partitioned step, whose loss
sees the global batch (:mod:`~fluxmpi_tpu_torch._batch_parallel`);
under ``style="shard_map"`` each worker's batch is its own, and the
floating leaves of the new model state (BatchNorm's running statistics)
are averaged across the workers (``state_reduce="mean"`` by default, or
kept per worker with ``"local"``).
PyTorch runs eagerly, so the step is a plain Python function; its
kernels launch asynchronously and the returned loss stays on the device.
``policy=`` casts the parameters to a compute dtype entering the loss
(f32 masters, bf16 compute); ``remat=`` recomputes the forward during the
backward.

:func:`make_window_program` fuses a flush window (``width`` updates, the
batch gathers included) into one program: on the card a CUDA graph,
captured once and replayed once per window; on the CPU the same window
run eagerly. ``train_loop(fuse="auto"|"window")`` drives it.

``metrics=`` instruments the step as the JAX package's does: the step
carries the global norm of the reduced gradients out beside the loss, and
each call is a ``train.step`` span, timed by
:func:`~fluxmpi_tpu_torch.utils.profiling.step_timer` (the clock stops
once the outputs are complete on the card), a watchdog tick and a record
into the registry, monitor or hook. ``train_loop`` runs the
uninstrumented core instead and records the same names at its flush
boundaries. ``model_stats=`` builds the model-internals plane's per-layer
stats into the step (:mod:`~fluxmpi_tpu_torch.telemetry.modelstats`).

Layouts (``parallel=``, ``style=``, ``state_sharding=``): with a plan
(:class:`~fluxmpi_tpu_torch.parallel.ParallelConfig`, or one installed by
``init(parallel=)``) the default ``style="auto"`` step keeps each
worker's block of every leaf the plan shards (what
:meth:`~fluxmpi_tpu_torch.parallel.plan.ResolvedPlan.shard_state` placed;
the same shapes as the JAX package's addressable shards) and inserts the
collectives itself: before the forward it all-gathers every parameter
sharded over the ``fsdp`` axis (the ZeRO-3 gather), and after the
backward it sums each gradient over the workers that hold the same block
and keeps this worker's block, so the update runs on the blocks alone.
The leaves sharded over ``tp`` stay blocks: the transformer layers
compute on this worker's heads, columns and vocab rows and sum the
row-parallel products over the tp group
(:mod:`~fluxmpi_tpu_torch._tensor_parallel`); the step's first update
gathers them too while the layers note which leaves they take, and a
leaf no layer takes stays gathered.
Each worker's ``loss_fn`` sees its own rows of the global batch (the
loader's ``mesh=`` rows), and the step's loss and gradients are those of
the mean over the global batch, as JAX's partitioned step computes them;
the loss runs inside the batch axes' context (the plan's ``dp`` and
``fsdp``, or the whole world without a plan), so BatchNorm's statistics,
the DEQ solvers' stopping test and the MoE layer's ``n_groups`` couple
every row of the global batch, as they do in JAX.
The ``ep`` axis is not gathered: the MoE layers built with ``mesh=`` run
their local experts and exchange tokens with an all-to-all
(:mod:`~fluxmpi_tpu_torch.models.moe`). Under ``sp`` each worker's
``loss_fn`` sees its sequence block of the batch (the dims ``batch_spec``
shards over ``sp``) inside a sequence-parallel context
(:mod:`~fluxmpi_tpu_torch._sequence_parallel`): the port's transformer
layers take global positions and run their attention as a ring over the
axis (an ``attention_fn`` such as ``ulysses_attention_fn`` runs as
given), and a loss that entered no sequence-parallel attention raises;
the loss and gradients are reduced over ``sp`` as well. The ``pp`` axis
is not gathered either: the stacked stages (``pipeline_rules``) stay this
worker's block, the loss calls ``make_pipeline_fn`` (or
``pipeline_apply``) over the axis, every ``pp`` worker computes the same
loss, and a stage block's gradient is summed over the workers holding
it. Every other axis replicates the pipeline, as the JAX package's
``shard_map`` over ``pp`` does: under ``pp`` with ``sp`` the loss gets
whole sequences (a batch leaf already cut over ``sp`` is all-gathered)
and computes on them, under ``pp`` with ``tp`` or ``ep`` the stage leaves
the rules lay out over those axes are gathered before the forward (their
gradients cut back to the blocks), and every worker of those axes
computes the same loss, which the reduction counts once. Under ``sp``
with ``tp`` each tp worker runs its heads
(:mod:`~fluxmpi_tpu_torch._tensor_parallel`) and the ring (or Ulysses,
whose worker's heads must divide by ``sp``) runs over the sp group on
those heads; the exchanges of both are issued in the same program order
on every worker, so their backward passes line up. Under ``sp`` with
``ep`` the MoE layers route each group as a whole over the sp group and
exchange tokens over the ep group at their own sp index
(:mod:`~fluxmpi_tpu_torch.models.moe`). ``style="shard_map"`` is the
explicit per-worker step, its gradients reduced over the ``axis_name``
axis of the mesh. ``donate=False`` copies the state before the update,
so the caller's stays valid.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as _checkpoint

from .. import _batch_parallel, _sequence_parallel, _tensor_parallel, config, runtime
from ..data import _gather_batch
from ..optim import GradientTransformation, apply_updates
from ..optimizer import allreduce_gradients
from . import sharding as _sharding

__all__ = ["TrainState", "make_eval_step", "make_train_step",
           "make_window_program", "replicate", "shard_batch"]

# Step arguments of the JAX package not ported yet: none left.
_WAITING: tuple = ()

# metrics=True: record into whatever the default registry is at record
# time (set_registry may swap it after the step is built).
_DEFAULT_REGISTRY = object()


@dataclasses.dataclass
class TrainState:
    """Training state: the update count, the parameters (a dict of the
    model's parameter tensors, keyed by state-dict name, which the step
    updates in place), the optimizer state and the mutable model state."""

    step: int
    params: dict
    opt_state: Any
    model_state: Any = None

    @classmethod
    def create(cls, params: Any, optimizer: GradientTransformation,
               model_state: Any = None) -> "TrainState":
        """``params``: an ``nn.Module`` (its named parameters) or a dict of
        tensors."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        return cls(step=0, params=dict(params),
                   opt_state=optimizer.init(params), model_state=model_state)


def _worker_tensor(x: Any) -> Any:
    """An array leaf as a tensor on this worker's device; other leaves
    as they are."""
    if not isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return x
    return torch.as_tensor(x).to(runtime.worker_device())


def replicate(tree: Any, mesh: Any = None) -> Any:
    """The whole value on this worker's device, each array leaf a tensor
    (the JAX package's replicated layout: every device holds the full
    value). A :class:`TrainState` stays one, its leaves moved."""
    del mesh  # every worker holds the whole value, whatever the mesh
    if isinstance(tree, TrainState):
        return TrainState(step=tree.step, params=replicate(tree.params),
                          opt_state=replicate(tree.opt_state),
                          model_state=replicate(tree.model_state))
    return pytree.tree_map(_worker_tensor, tree)


def shard_batch(batch: Any, mesh: Any = None, axis_name: str | None = None, *,
                spec: Any = None) -> Any:
    """This worker's block of a host global batch, on its device: each
    leaf cut by ``spec`` over the mesh coordinates (default: the leading
    dimension over the data-parallel axis; ``P("dp", "sp")`` also cuts
    the sequence), as the loader's ``mesh=`` rows cut it
    (:meth:`~fluxmpi_tpu_torch.parallel.sharding.NamedSharding.local_block`,
    by :meth:`~fluxmpi_tpu_torch.parallel.sharding.Mesh.block_index`).
    Each block carries its layout."""
    from .sharding import NamedSharding, P, with_sharding

    mesh = mesh or runtime.global_mesh()
    if spec is not None and axis_name is not None:
        raise ValueError("pass either axis_name or spec, not both")
    if spec is None:
        spec = P(axis_name or config.DP_AXIS_NAME)
    sharding = NamedSharding(mesh, P(*spec))

    def cut(x):
        x = _worker_tensor(x)
        if not torch.is_tensor(x):
            return x
        return with_sharding(sharding.local_block(x), sharding)

    return pytree.tree_map(cut, batch)


def _split(batch: Any, k: int) -> list[Any]:
    """``k`` micro-batches along each leaf's leading dimension."""
    leaves, spec = pytree.tree_flatten(batch)
    for x in leaves:
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"grad_accum_steps {k}")
    parts = [x.chunk(k) for x in leaves]
    return [pytree.tree_unflatten([p[i] for p in parts], spec) for i in range(k)]


def _microbatch_rows(batch: Any, rows: Any, k: int) -> Any:
    """This worker's rows of the global batch exchanged over the batch
    axes ``rows`` (N members, this one ``rows.index``) so that its ``j``-th
    of ``k`` chunks is its block of the JAX package's microbatch ``j``, the
    global batch's ``j``-th slice: global rows ``j * B/k + index * m`` on,
    ``m = B / (N * k)``. In blocks of ``m`` global rows, block ``q`` lives
    on member ``q // k`` as its chunk ``q % k`` and goes to member ``q % N``
    as its chunk ``q // N``: one ``all_to_all_single`` a tensor leaf over
    the group, its split sizes known on the host (so a CUDA graph records
    it), no gradient through it. Raises ``ValueError`` where the rows do
    not divide (ROADMAP C.35)."""
    import torch.distributed as dist

    n, me, group = rows.size, rows.index, rows.group
    members = dist.get_process_group_ranks(group)
    # The batch-axes index of the member at each place of the group.
    index_at = [rows.ranks.index(r) for r in members]

    def exchange(x):
        if not torch.is_tensor(x):
            return x
        local = x.shape[0]
        if (local * n) % k:
            raise ValueError(f"batch dim {local * n} not divisible by "
                             f"grad_accum_steps {k}")
        if local % k:
            raise ValueError(
                f"grad_accum_steps={k} over {n} batch workers of {local} rows each: "
                f"each microbatch of {local * n // k} global rows would spread unevenly "
                f"over the workers, which the port does not run (ROADMAP C.35); the "
                f"JAX package runs this case")
        m = local // k
        send = {d: [c for c in range(k) if (me * k + c) % n == d] for d in range(n)}
        recv = {s: [j for j in range(k) if (j * n + me) // k == s] for s in range(n)}
        order = [c for d in index_at for c in send[d]]
        arrived = [j for s in index_at for j in recv[s]]
        x = x.detach()
        if order != list(range(k)):
            x = torch.cat([x.narrow(0, c * m, m) for c in order])
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, [m * len(recv[s]) for s in index_at],
                               [m * len(send[d]) for d in index_at], group=group)
        if arrived != list(range(k)):
            at = {j: i for i, j in enumerate(arrived)}
            out = torch.cat([out.narrow(0, at[j] * m, m) for j in range(k)])
        return out

    return pytree.tree_map(exchange, batch)


# The matrix products whose outputs remat="dots" keeps (the analogue of
# jax.checkpoint_policies.checkpoint_dots); everything else recomputes.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    policy = _checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOT_OPS else policy.PREFER_RECOMPUTE


class _CastWatch:
    """The graph nodes of the parameters that ``policy`` cast in the first
    update's forward, until the step has checked that the loss reached
    one of them."""

    def __init__(self):
        self.armed, self.nodes = True, set()

    def check(self, loss: torch.Tensor) -> None:
        """Raise unless ``loss`` was computed from a cast parameter (when
        the policy cast any); disarm once it was."""
        nodes, self.nodes = self.nodes, set()
        todo, seen = [loss.grad_fn], set()
        while nodes and todo:
            fn = todo.pop()
            if fn in nodes:
                nodes = None
            elif fn is not None and fn not in seen:
                seen.add(fn)
                todo.extend(f for f, _ in fn.next_functions)
        if not nodes:
            self.armed = False
            return
        raise ValueError(
            "policy= has no effect: loss_fn computed its loss without the "
            "cast parameters it was given (a closure over the module's own "
            "tensors?); compute from them with torch.func.functional_call, "
            "or give the model a compute dtype instead")


def _with_policy_and_remat(loss_fn, policy, remat, watch):
    """``loss_fn`` with the parameters cast by ``policy`` entering it
    (their graph nodes noted in ``watch`` while it is armed), and its
    forward recomputed during the backward under ``remat``."""
    if policy is not None:
        inner = loss_fn

        def loss_fn(p, mstate, batch):  # noqa: F811 - deliberate rewrap
            with _tensor_parallel.owned():
                cast = policy.cast_to_compute(p)
            tp = _tensor_parallel.current()
            if tp is not None:
                tp.note(cast)
            if watch.armed:
                watch.nodes.update(c.grad_fn for k, c in cast.items()
                                   if c is not p[k] and c.grad_fn is not None)
            return inner(cast, mstate, batch)

    if remat:
        if remat == "dots":
            opts = dict(context_fn=functools.partial(
                _checkpoint.create_selective_checkpoint_contexts, _save_dots))
        elif remat is True:
            opts = {}
        else:
            raise ValueError(f"remat must be False, True, or 'dots', got {remat!r}")
        plain = loss_fn

        def loss_fn(p, mstate, batch):  # noqa: F811 - deliberate rewrap
            # The recompute runs where the backward runs: on the card,
            # autograd's device thread, which sees none of this thread's
            # contexts; it re-enters the tensor-, sequence- and
            # batch-parallel contexts of the forward (ROADMAP C.22, C.25).
            tp, seq = _tensor_parallel.current(), _sequence_parallel.current()
            rows = _batch_parallel.current()

            def run(p, mstate, batch):
                with (_tensor_parallel.active(tp), _sequence_parallel.active(seq),
                      _batch_parallel.active(rows)):
                    return plain(p, mstate, batch)

            return _checkpoint.checkpoint(run, p, mstate, batch,
                                          use_reentrant=False, **opts)

    return loss_fn


def _resolve_metrics(metrics: Any) -> tuple[Any, Any, Any]:
    """Normalize a ``metrics=`` spec to (registry, monitor, hook)."""
    from ..telemetry import MetricsRegistry, TrainingMonitor

    if metrics is True:
        return _DEFAULT_REGISTRY, None, None
    if isinstance(metrics, TrainingMonitor):
        return metrics.registry, metrics, None
    if isinstance(metrics, MetricsRegistry):
        return metrics, None, None
    if callable(metrics):
        return None, None, metrics
    raise ValueError(
        "metrics must be True, a MetricsRegistry, a TrainingMonitor, or a "
        f"callable hook; got {metrics!r}"
    )


def _live_registry(reg: Any) -> Any:
    from ..telemetry import get_registry

    return get_registry() if reg is _DEFAULT_REGISTRY else reg


def _global_norm(grads: dict) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all the gradients as one
    vector, in f32."""
    vals = [g.float() for g in grads.values()]
    if not vals:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(vals)))


def _instrument_step(core: Callable, metrics: Any, scan_steps: int, *,
                     stats_plans: list | None = None, stats_workers: int = 1) -> Callable:
    """Wrap ``core(state, batch) -> (state, (loss, grad_norm[,
    model_stats]))`` into the public ``(state, loss)`` signature,
    recording telemetry per call: a ``train.step`` span, a
    :func:`~fluxmpi_tpu_torch.utils.profiling.step_timer` that waits for
    the loss and the norm before it stops the clock, a watchdog tick, and
    ``train.step_seconds``, ``train.loss``, ``train.grad_norm``,
    ``train.examples_per_sec``, ``train.steps`` and ``train.examples``
    into the registry (or the monitor's, which also observes the step; or
    the hook, which gets the record). With the model stats built in
    (``stats_plans``: the step's stats plan, made at its first update), the
    per-layer stats are copied to the host and
    emitted per call (``train_loop`` consumes them per flush instead); a
    ``metrics`` of ``None``/``False`` then records nothing else (the
    stats-only wrapper)."""
    from ..telemetry import modelstats as _modelstats
    from ..telemetry import tracing as _tracing
    from ..telemetry.watchdog import notify_progress
    from ..utils.profiling import step_timer

    record_metrics = metrics is not None and metrics is not False
    reg = monitor = hook = None
    if record_metrics:
        reg, monitor, hook = _resolve_metrics(metrics)

    def step(state, batch):
        holder: dict[str, float] = {}
        with _tracing.span("train.step"):
            with step_timer(holder) as t:
                new_state, aux = core(state, batch)
                loss, gnorm = aux[0], aux[1]
                t.watch((loss, gnorm))
        notify_progress()
        seconds = holder["seconds"]
        leaves = pytree.tree_leaves(batch)
        examples = 0
        if leaves and getattr(leaves[0], "ndim", 0):
            examples = int(leaves[0].shape[0])
            if scan_steps > 1:  # leading axis is scan time, not data
                examples *= int(leaves[0].shape[1])
        if stats_plans is not None:
            ms = _modelstats.get_model_stats()
            if ms is not None and ms.enabled:
                ms.observe_flush(
                    _modelstats.stats_tree(stats_plans[0].names, *aux[2]),
                    registry=_live_registry(reg) if record_metrics else None,
                    batch_examples=examples / scan_steps if scan_steps else None,
                    workers=stats_workers)
        if not record_metrics:
            return new_state, loss
        record = {
            "step_seconds": seconds,
            "loss": float(loss.float().mean()),
            "grad_norm": float(gnorm.float().mean()),
            "examples": examples,
            "examples_per_sec": examples / seconds if seconds > 0 else 0.0,
            "steps": scan_steps,
        }
        registry = _live_registry(reg)
        if registry is not None:
            registry.histogram("train.step_seconds").observe(seconds)
            registry.gauge("train.loss").set(record["loss"])
            registry.gauge("train.grad_norm").set(record["grad_norm"])
            registry.gauge("train.examples_per_sec").set(
                record["examples_per_sec"])
            registry.counter("train.steps").inc(scan_steps)
            registry.counter("train.examples").inc(examples)
        if monitor is not None:
            monitor.observe_step(seconds)
        if hook is not None:
            hook(record)
        return new_state, loss

    return step


def _spec_axes(spec: Any) -> list[tuple[int, tuple[str, ...]]]:
    """``[(dim, axis names)]`` of the partitioned dims of ``spec``."""
    out = []
    for d, names in enumerate(spec or ()):
        if names is None:
            continue
        out.append((d, (names,) if isinstance(names, str) else tuple(names)))
    return out


class _Layout:
    """A parameter layout over a mesh, as the ``style="auto"`` step runs
    it: which parameters are sharded over which axes (``specs``, by
    state-dict name), and which axes the model consumes itself
    (``native``: the ``ep`` axis, whose expert blocks the MoE layers run
    locally). The rest are gathered before the forward, but for the
    leaves that the transformer layers take as tensor-parallel blocks
    (``tp_blocks``: decided in the first update, see
    :mod:`fluxmpi_tpu_torch._tensor_parallel`)."""

    def __init__(self, mesh: Any, specs: dict, native: set, tp_axis: str | None = None,
                 sp_axis: str | None = None, pp_axis: str | None = None):
        self.mesh = mesh
        self.sp_axis = sp_axis if mesh.shape.get(sp_axis, 1) > 1 else None
        self.pp_axis = pp_axis if mesh.shape.get(pp_axis, 1) > 1 else None
        # The pipeline replicates every axis but pp (JAX's shard_map over
        # pp): under pp the loss computes on whole sequences.
        self.whole_sp = None
        if self.pp_axis is not None and self.sp_axis is not None:
            self.whole_sp, self.sp_axis = self.sp_axis, None
        self.world = mesh.size
        self.native = set(native)
        self.plans: dict[str, tuple] = {}
        for name, spec in specs.items():
            dims = _spec_axes(spec)
            # A stage leaf (sharded over pp) runs inside the pipeline, which
            # replicates the expert axis too: its ep dims are gathered.
            stage = self.pp_axis is not None and any(self.pp_axis in n for _, n in dims)
            native_here = {self.pp_axis} if stage else self.native
            gathered, local = [], []
            for d, names in dims:
                kinds = {n in native_here for n in names}
                if len(kinds) > 1:
                    raise NotImplementedError(
                        f"{name}: dim {d} is sharded over {names}, which mixes "
                        f"an expert axis with others")
                (local if kinds == {True} else gathered).append((d, names))
            self.plans[name] = (gathered, local)
        self.tp_axis = tp_axis if mesh.shape.get(tp_axis, 1) > 1 else None
        self.tp_blocks: set[str] | None = None if self.tp_axis else set()
        self._tp = None
        self._owned: dict[tuple, list] = {}

    @property
    def shards(self) -> bool:
        return any(g or lo for g, lo in self.plans.values())

    def axes_context(self) -> Any:
        """The sequence-parallel context of one update's loss (None
        without an sp or pp axis): the mesh, which binds both axes, and
        the sp axis, over which the transformer layers run their
        attention as a ring (none under pp, whose pipeline replicates
        it)."""
        if self.sp_axis is None and self.pp_axis is None:
            return None
        return _sequence_parallel.SequenceParallel(self.mesh, self.sp_axis)

    def local_batch(self, batch: Any, batch_spec: Any) -> Any:
        """This worker's sequence block of each batch leaf, along the dims
        ``batch_spec`` shards over the sp axis (the loader's rows are the
        same on workers that differ only in sp). A leaf that
        :func:`shard_batch` already cut over the sp axis is its block;
        under pp, whose pipeline replicates sp, such a leaf is all-gathered
        and the others stay whole."""
        from .sharding import sharding_of

        if self.whole_sp is not None:
            return pytree.tree_map(self._whole_sequence, batch)
        if self.sp_axis is None:
            return batch
        dims = [d for d, names in _spec_axes(batch_spec) if self.sp_axis in names]
        n = self.mesh.shape[self.sp_axis]
        i = self.mesh.coords(self.mesh.my_rank())[self.sp_axis]

        def cut(x):
            if not torch.is_tensor(x):
                return x
            sh = sharding_of(x)
            if sh is not None and any(self.sp_axis in names
                                      for _, names in _spec_axes(sh.spec)):
                return x
            for d in dims:
                if d < x.ndim:
                    if x.shape[d] % n:
                        raise ValueError(
                            f"batch dim {d} of length {x.shape[d]} is sharded over "
                            f"'{self.sp_axis}' of size {n}, which does not divide it")
                    x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
            return x

        return pytree.tree_map(cut, batch)

    def _whole_sequence(self, x: Any) -> Any:
        """``x`` gathered along every dim its layout cuts over the
        replicated sp axis (a leaf cut by :func:`shard_batch`)."""
        from .._collective_ops import MeshAxis, unshard_along
        from .sharding import sharding_of

        sh = sharding_of(x) if torch.is_tensor(x) else None
        if sh is None:
            return x
        for d, names in _spec_axes(sh.spec):
            if self.whole_sp in names:
                if names != (self.whole_sp,):
                    raise ValueError(
                        f"batch dim {d} is sharded over {names}; under pp the "
                        f"sequence axis '{self.whole_sp}' must shard a dim alone")
                x = unshard_along(x, MeshAxis(self.mesh, self.whole_sp), d)
        return x

    def dims(self, name: str) -> tuple[list, list]:
        """``(gathered, local)`` sharded dims of leaf ``name`` as the
        step runs it."""
        gathered, local = self.plans.get(name, ([], []))
        if self.tp_blocks and name in self.tp_blocks:
            return [], local + gathered
        return gathered, local

    def tp_context(self) -> Any:
        """The tensor-parallel context of one update's loss (None without
        a tp axis): a new one collecting the layers' claims until the
        blocks are decided, then one kept for every update."""
        if self.tp_axis is None:
            return None
        if self.tp_blocks is None:
            return _tensor_parallel.TensorParallel(self.mesh, self.tp_axis, {})
        if self._tp is None:
            self._tp = _tensor_parallel.TensorParallel(self.mesh, self.tp_axis)
        return self._tp

    def settle(self, tp: Any) -> None:
        """After the first update: every claimed group whose leaves are
        all sharded over the tp axis alone, each along the dim its layer
        splits, and none of them read by the loss outside the layers
        (``tp.outside``; nor claimed in a group with such a leaf), is
        handed over as blocks from then on."""
        if tp is None or self.tp_blocks is not None:
            return

        def tp_only(name, dim):
            return self.plans.get(name) == ([(dim, (self.tp_axis,))], [])

        kept = set(tp.outside)
        for group in tp.claims:
            if not all(tp_only(n, d) for n, d in group):
                kept.update(n for n, _ in group)
        grown = True
        while grown:  # a group with a kept leaf is kept whole
            grown = False
            for group in tp.claims:
                names = {n for n, _ in group}
                if names & kept and not names <= kept:
                    kept |= names
                    grown = True
        self.tp_blocks = {n for group in tp.claims for n, _ in group} - kept

    def owned(self, keys: list) -> list:
        """For each leaf of ``keys``: does this worker count its block once
        in a sum over the world (it sits at index 0 of every axis the leaf
        is not sharded over)? Worked out once per key list."""
        if self._owned.get(tuple(keys)) is None:
            coords = self.mesh.coords(self.mesh.my_rank())

            def owns(name):
                spec_axes = {n for _, names in sum(self.plans.get(name, ([], [])), [])
                             for n in names}
                return all(i == 0 for a, i in coords.items() if a not in spec_axes)

            self._owned[tuple(keys)] = [owns(k) for k in keys]
        return self._owned[tuple(keys)]

    def gather(self, params: dict) -> dict:
        """The parameters the loss sees: each gathered to its full shape
        over its non-native sharded axes (a leaf that requires grad), the
        rest as they are."""
        import torch.distributed as dist

        out = {}
        for k, p in params.items():
            gathered = self.dims(k)[0]
            if not gathered or not self.world > 1:
                out[k] = p
                continue
            axes = tuple(n for _, names in gathered for n in names)
            group = self.mesh.group(axes)
            ranks = dist.get_process_group_ranks(group)
            parts = [torch.empty_like(p) for _ in ranks]
            dist.all_gather(parts, p.detach().contiguous(), group=group)
            shape = list(p.shape)
            for d, names in gathered:
                shape[d] *= self.mesh.group_size(names)
            full = p.new_empty(shape)
            for r, part in zip(ranks, parts):
                index = [slice(None)] * p.ndim
                for d, names in gathered:
                    i, _ = self.mesh.block_index(r, names)
                    index[d] = slice(i * p.shape[d], (i + 1) * p.shape[d])
                full[tuple(index)] = part
            out[k] = full.requires_grad_(p.requires_grad)
        return out

    def reduce(self, grads: dict, loss: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """The gradients of the global mean loss, each this worker's block:
        summed over the workers that hold the same block of the
        parameter, divided by the world (by the data workers for a
        tensor-parallel block, whose gradient each tp worker computes
        once), then cut to the block; and the loss averaged over the
        world."""
        from ..comm import fused
        import torch.distributed as dist

        if not self.world > 1:
            return grads, loss
        world = self.world
        every = tuple(self.mesh.axis_names)
        buckets = self._buckets(list(grads))
        out = dict(grads)
        for axes, div in sorted(buckets):
            keys = buckets[(axes, div)]
            group = self.mesh.group(axes)
            vals = [grads[k] for k in keys]
            if (axes, div) == (every, world):
                vals.append(loss.detach().float().reshape(1))

            def run(flat, group=group, div=div):
                if group is not None:
                    dist.all_reduce(flat, group=group)
                flat.div_(div)

            red = fused(vals, run)
            if (axes, div) == (every, world):
                loss = red.pop().reshape(()).to(loss.dtype)
            out.update(zip(keys, red))
        me = self.mesh.my_rank()
        for k, g in out.items():
            for d, names in self.dims(k)[0]:
                i, n = self.mesh.block_index(me, names)
                size = g.shape[d] // n
                g = g.narrow(d, i * size, size)
            out[k] = g.contiguous()
        return out, loss

    def _buckets(self, keys: list) -> dict[tuple, list[str]]:
        """``{(axes, divisor): leaves}``: the gradients :meth:`reduce` sums
        together, over the workers that differ only along ``axes``."""
        world = self.world
        every = tuple(self.mesh.axis_names)
        buckets: dict[tuple, list[str]] = {(every, world): []}
        for k in keys:
            keep = {n for _, names in self.dims(k)[1] for n in names}
            axes = tuple(a for a in every if a not in keep)
            div = world
            if self.tp_blocks and k in self.tp_blocks:
                div = world // self.mesh.shape[self.tp_axis]
            elif self.pp_axis in keep:
                # Every pp worker computes the same loss, and the stage
                # blocks' gradients each once (make_pipeline_fn).
                div = world // self.mesh.shape[self.pp_axis]
            buckets.setdefault((axes, div), []).append(k)
        return buckets

    def used_axes(self, keys: list) -> list[tuple]:
        """The axes of every process group an update of the settled layout
        runs a collective over (each gathered leaf's, each reduce bucket's,
        the whole mesh's among them, and the tp axis's), in one order on
        every worker."""
        out: list[tuple] = []
        for k in keys:
            gathered = self.dims(k)[0]
            if gathered:
                out.append(tuple(n for _, names in gathered for n in names))
        out += [axes for axes, _ in sorted(self._buckets(keys))]
        if self.tp_axis is not None:
            out.append((self.tp_axis,))
        return list(dict.fromkeys(out))

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The 2-norm of the whole gradient, each block counted once."""
        import torch.distributed as dist

        if not self.world > 1:
            return _global_norm(grads)
        total = None
        for k, g in grads.items():
            spec_axes = [n for d, names in sum(self.plans.get(k, ([], [])), [])
                         for n in names]
            copies = self.world // self.mesh.group_size(spec_axes)
            term = g.float().square().sum() / copies
            total = term if total is None else total + term
        total = total.reshape(1).clone()
        dist.all_reduce(total)
        return total.reshape(()).sqrt()


def _plan_defaults(parallel: Any, mesh: Any, axis_name: str | None,
                   batch_spec: Any, state_sharding: Any, caller: str):
    """A step factory's layout defaults from ``parallel=`` (explicit
    arguments win): the plan's mesh, dp axis name, batch spec and banked
    state sharding."""
    from .plan import resolve_parallel

    plan = resolve_parallel(parallel)
    mesh = mesh or plan.mesh
    if axis_name is None:
        axis_name = plan.dp_axis_name
    if batch_spec is None:
        batch_spec = plan.batch_spec
    if state_sharding is None:
        state_sharding = plan.state_sharding
        if state_sharding is None and plan.shards_parameters:
            raise ValueError(
                f"this ParallelConfig shards parameters (fsdp/tp axes or "
                f"a rules table) but no layout is banked — call "
                f"plan.shard_state(state) before {caller}(parallel=plan) "
                f"so the compiled program pins the same layout the state "
                f"was placed with"
            )
    return plan, mesh, axis_name, batch_spec, state_sharding


def _installed_plan_defaults(mesh: Any, axis_name: str | None, batch_spec: Any):
    """The installed plan's batch layout and data axis for a step built
    without ``parallel=``, when its mesh carries the plan's data axes; an
    explicit ``axis_name`` or ``batch_spec`` opts out."""
    if axis_name is not None or batch_spec is not None:
        return None, mesh, axis_name, batch_spec
    plan = runtime.global_plan()
    if plan is None or not plan.covers(mesh):
        return None, mesh, axis_name, batch_spec
    return plan, mesh, plan.dp_axis_name, plan.batch_spec


def _batch_group(mesh: Any, plan: Any, batch_spec: Any) -> Any:
    """The ``style="auto"`` step's batch axes: the axes the batch spec
    cuts the rows over (a plan's ``dp`` and ``fsdp``), or the whole world
    without a plan; None when this worker's rows are the whole batch."""
    if not runtime.is_initialized() or runtime.total_workers() < 2:
        return None
    lead = batch_spec[0] if batch_spec is not None and len(batch_spec) else None
    if isinstance(lead, str):
        lead = (lead,)
    if not isinstance(lead, tuple) and plan is not None:
        lead = plan.data_axes
    if isinstance(lead, tuple) and mesh is not None:
        rows = _batch_parallel.BatchAxes(mesh, lead)
    else:
        rows = _batch_parallel.BatchAxes()
    return rows if rows.size > 1 else None


def _make_layout(plan: Any, mesh: Any, state_sharding: Any) -> _Layout:
    """The step's :class:`_Layout` from the banked or given shardings."""
    specs = {}
    params = getattr(state_sharding, "params", None) or {}
    for k, sh in params.items():
        specs[k] = sh.spec
    ep = plan.axis_name("ep") if plan is not None else None
    if ep is None and config.EP_AXIS_NAME in mesh.shape:
        ep = config.EP_AXIS_NAME
    tp = plan.axis_name("tp") if plan is not None else config.TP_AXIS_NAME
    sp = plan.axis_name("sp") if plan is not None else None
    pp = plan.axis_name("pp") if plan is not None else None
    return _Layout(mesh, specs, {a for a in (ep, pp) if a}, tp, sp, pp)


def _copy_state(ts: "TrainState") -> "TrainState":
    """A new TrainState whose tensors are copies of ``ts``'s (a block
    keeps its layout tag)."""
    from .sharding import sharding_of, with_sharding

    def copy(t):
        if not torch.is_tensor(t):
            return t
        return with_sharding(t.detach().clone().requires_grad_(t.requires_grad),
                             sharding_of(t))

    return TrainState(step=ts.step, params={k: copy(v) for k, v in ts.params.items()},
                      opt_state=pytree.tree_map(copy, ts.opt_state),
                      model_state=pytree.tree_map(copy, ts.model_state))


def make_train_step(
    loss_fn: Callable[[dict, Any, Any], tuple[torch.Tensor, Any]],
    optimizer: GradientTransformation,
    *,
    parallel: Any = None,
    mesh: Any = None,
    axis_name: str | None = None,
    style: str = "auto",
    grad_reduce: str | None = "mean",
    state_reduce: str = "mean",
    donate: bool | None = None,
    state_sharding: Any = None,
    batch_spec: Any = None,
    remat: bool | str = False,
    grad_accum_steps: int = 1,
    scan_steps: int = 1,
    policy: Any = None,
    metrics: Any = None,
    model_stats: Any = None,
) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """Build ``step(state, batch) -> (state, loss)``.

    ``loss_fn(params, model_state, batch) -> (loss, new_model_state)``
    computes this worker's scalar loss on its local batch (stateless
    models return ``None``).
    ``grad_reduce``: ``"mean"`` averages the gradients and the loss over
    the workers, ``"sum"`` sums them, ``None`` leaves them local.
    ``state_reduce``: how to combine the per-worker model state under
    ``style="shard_map"`` (as in JAX, it matters only there):
    ``"mean"`` averages every floating leaf of the new model state over
    the workers (BatchNorm's running statistics; integer leaves are kept),
    in one flat collective per dtype; ``"local"`` keeps each worker's own.
    Under ``style="auto"`` the loss runs inside the batch axes' context
    (module docstring), so the statistics are the global batch's on every
    worker already. Before :func:`~fluxmpi_tpu_torch.init` there is one
    worker and nothing to average.
    ``grad_accum_steps=k`` splits each batch into ``k`` micro-batches and
    averages their gradients before the one update. Micro-batch ``j`` is
    the global batch's ``j``-th slice, as in JAX: under ``style="auto"``
    with batch axes of ``N > 1`` workers, the step first exchanges rows
    over them (one all-to-all a batch leaf), so that this worker's share
    of micro-batch ``j`` is its block of that slice, and the layers that
    couple rows (BatchNorm, the DEQ's stopping test, ``n_groups``, the
    random draws) see the JAX package's micro-batches. Each worker's rows
    must divide into ``k`` blocks. ``scan_steps=K`` takes
    ``K`` batches stacked on a leading axis, runs ``K`` updates and returns
    the ``[K]`` losses. The parameters and optimizer state update in place;
    the returned loss is a detached tensor on the device (reading it
    synchronizes).

    ``policy``: a :class:`~fluxmpi_tpu_torch.utils.Policy`; the parameters
    enter ``loss_fn`` cast to its compute dtype while the state keeps its
    f32 masters and optimizer state (the cast is differentiable, so the
    gradients come back in the masters' dtype and the update runs in
    f32). ``loss_fn`` must then compute from the ``params`` it is given
    (e.g. ``torch.func.functional_call``): the first update raises
    ``ValueError`` if its loss reached none of the cast parameters (a
    closure over the module's own tensors would train in f32). A model
    built with a compute ``dtype=`` needs no policy. ``remat=True``
    recomputes the whole forward during the backward
    (``torch.utils.checkpoint``, non-reentrant); ``remat="dots"`` keeps the
    matrix products' outputs and recomputes the rest
    (``create_selective_checkpoint_contexts``). Both wrap the whole loss,
    so with eager PyTorch the backward's recompute holds every activation
    at once again: they add a forward's work and do not lower the peak
    memory (a checkpoint per block would).

    The step carries its single-update body for ``train_loop``'s fused
    windows (``fuse="auto"``, the default), which on the card capture
    ``width`` updates as one CUDA graph and replay it: ``loss_fn`` must
    then hold no host-side state that changes between updates (a Python
    counter or schedule, numpy or Python randomness, a CPU generator),
    whose capture-time values the graph would keep; pass ``fuse=False`` to
    ``train_loop`` for such a ``loss_fn``. Draws from the default CUDA
    generator, or from a CUDA generator the loss notes with
    :func:`~fluxmpi_tpu_torch.runtime.note_graph_generator` (as
    ``ddpm_loss`` does), advance on every replay. In a world of several
    workers the window fuses under every plan of the default
    ``style="auto"`` step, ``pp`` included (a pipeline's ticks, its
    exchanges and their backward are a static schedule per worker, which
    the graph records); a ``style="shard_map"`` step runs pipelined there.

    ``metrics``: ``None``/``False`` (off), ``True`` (the default
    registry), a :class:`~fluxmpi_tpu_torch.telemetry.MetricsRegistry`, a
    :class:`~fluxmpi_tpu_torch.telemetry.TrainingMonitor` (its registry,
    and its periodic collect), or a callable that gets a dict per step.
    The step then also computes the global norm of the reduced gradients
    (``optax.global_norm`` of what the optimizer consumes) and records,
    per call, ``train.step_seconds`` (the clock waits for the step's
    outputs on the card), ``train.loss``, ``train.grad_norm``,
    ``train.examples_per_sec`` and the cumulative ``train.steps`` /
    ``train.examples``; the wait serializes the host with the card, so
    drive an instrumented step through ``train_loop``, which records at
    flush boundaries without it. The parameters it computes are the
    uninstrumented step's, bit for bit.

    ``parallel``: a :class:`~fluxmpi_tpu_torch.parallel.ParallelConfig`
    or resolved plan (or ``"auto"``: the installed plan); the step takes
    its mesh, data axis, batch spec and the state sharding that
    :meth:`~fluxmpi_tpu_torch.parallel.plan.ResolvedPlan.shard_state`
    banked (a plan that shards parameters raises without one), and runs
    the layout as the module docstring says (every composition of its
    axes); ``style="auto"`` only.
    Without ``parallel=``, ``style="auto"`` follows a plan installed by
    ``init(parallel=)``. ``mesh``/``axis_name``: the mesh and data axis
    (default the plan's, else the runtime's and ``dp``).
    ``state_sharding``: the tree of
    :class:`~fluxmpi_tpu_torch.parallel.sharding.NamedSharding` the state
    was placed with. ``batch_spec``: the batch layout the loader's rows
    follow (default the plan's). ``style="shard_map"``: the per-worker
    step over ``axis_name`` (its gradients and loss reduced over that
    axis's workers; no ``grad_accum_steps``/``scan_steps``). ``donate``:
    ``True``/``None`` (the ``donate_buffers`` preference) updates the
    state in place; ``False`` copies it first, so the caller's stays
    valid. ``grad_reduce`` applies to the step without a plan and to
    ``"shard_map"``; under a plan the reduction is the layout's (the
    global mean). Under ``sp`` and ``pp`` the step runs as the module
    docstring says, with any of the other axes.

    ``model_stats``: build the model-internals plane's per-layer stats
    into the step (``None``, the default, follows the installed
    :class:`~fluxmpi_tpu_torch.telemetry.ModelStats` plane —
    ``init(model_stats=True)`` / ``FLUXMPI_TPU_MODEL_STATS=1``;
    ``True``/``False`` force it, an int sets the grouping depth):
    per-layer gradient, parameter and update norms and nonfinite-gradient
    counts (NaN provenance), grouped by the JAX package's leaf paths at
    that depth, plus — with a ``grad_reduce`` — the workers' mean
    pre-all-reduce gradient sq-norm and the reduced gradient's sq-norm
    that the gradient-noise-scale estimate (B_simple) needs (one more
    one-element all-reduce per update). Computed from the tensors the
    step already holds, before the parameters update; the update is
    untouched (a run with it on is bit-identical to one with it off). The
    step then also carries the global gradient norm. Consumed at
    ``train_loop`` flush boundaries (one host copy per flush; in a fused
    window only the window's last update computes them, inside its CUDA
    graph) or per call when the step is driven directly. Under a layout
    that shards parameters the norms sum each leaf's blocks over the
    workers that hold them, each block once (one all-reduce per update),
    and there is no noise scale, as the JAX package's partitioned step
    has none."""
    plan = None
    if isinstance(parallel, str):
        if parallel != "auto":
            raise ValueError(
                f'parallel= accepts a ParallelConfig, a ResolvedPlan, or '
                f'the string "auto", got {parallel!r}'
            )
        parallel = runtime.global_plan()
        if parallel is None:
            raise ValueError(
                'make_train_step(parallel="auto") found no installed '
                "plan — run the layout search first: "
                "fluxmpi_tpu.parallel.autotune.autotune(loss_fn, "
                "optimizer, params, sample_batch) under "
                'init(parallel="auto") installs its winner as the '
                "global plan (a banked winner is reused without trials)"
            )
    if parallel is not None:
        if style != "auto":
            raise ValueError(
                "parallel= requires style='auto' (the plan's layouts are "
                "partitioner-driven; shard_map takes explicit axis_name=)"
            )
        plan, mesh, axis_name, batch_spec, state_sharding = _plan_defaults(
            parallel, mesh, axis_name, batch_spec, state_sharding, "make_train_step")
    elif style == "auto":
        plan, mesh, axis_name, batch_spec = _installed_plan_defaults(
            mesh, axis_name, batch_spec)
    if style not in ("auto", "shard_map"):
        raise ValueError("style must be 'auto' or 'shard_map'")
    if donate is None:
        donate = bool(config.load_preference("donate_buffers"))
    if grad_accum_steps > 1 and style != "auto":
        raise ValueError("grad_accum_steps requires style='auto'")
    if scan_steps > 1 and style != "auto":
        raise ValueError("scan_steps requires style='auto'")
    if style == "shard_map" and (state_sharding is not None or batch_spec is not None):
        raise ValueError(
            "state_sharding/batch_spec require style='auto' (shard_map style "
            "replicates state per the reference's layout)"
        )
    name = axis_name or config.DP_AXIS_NAME
    if mesh is None and runtime.is_initialized():
        mesh = runtime.global_mesh()
    layout = None
    if style == "auto" and (plan is not None or state_sharding is not None):
        layout = _make_layout(plan, mesh, state_sharding)
    # shard_map over an axis narrower than the world reduces over its group.
    axis_group = None
    if style == "shard_map" and mesh is not None:
        if name not in mesh.shape:
            raise ValueError(f"unbound axis name {name!r}: the mesh has axes "
                             f"{tuple(mesh.axis_names)}")
        if mesh.shape[name] != mesh.size:
            axis_group = (mesh.group((name,)), mesh.shape[name])
    instrument = metrics is not None and metrics is not False
    if instrument:
        _resolve_metrics(metrics)  # reject bad specs at build, not step 1
    # The model-internals plane, resolved at build time: off, the step
    # computes nothing extra.
    from ..telemetry import modelstats as _modelstats

    stats_depth = _modelstats.resolve_step_spec(model_stats)
    stats_on = stats_depth is not None
    noise_on = stats_on and grad_reduce in ("mean", "sum") and layout is None
    stats_workers = runtime.total_workers() if runtime.is_initialized() else 1
    if plan is not None:
        stats_workers = plan.data_parallel_size
    elif axis_group is not None:
        stats_workers = axis_group[1]
    plans: list = []  # the StatsPlan, made from the first update's params
    carry_norm = instrument or stats_on
    watch = _CastWatch()
    loss_fn = _with_policy_and_remat(loss_fn, policy, remat, watch)
    if grad_reduce not in ("mean", "sum", None):
        raise ValueError("grad_reduce must be 'mean', 'sum', or None")
    if state_reduce not in ("mean", "local"):
        raise ValueError("state_reduce must be 'mean' or 'local'")
    if grad_accum_steps < 1:
        raise ValueError("grad_accum_steps must be >= 1")
    if scan_steps < 1:
        raise ValueError("scan_steps must be >= 1")

    unused_checked = []
    batch_group: list = []

    def batch_axes():
        """The workers whose rows make up the global batch (made at the
        first update): under ``style="auto"`` the layers that couple rows
        couple theirs; ``"shard_map"`` binds none."""
        if not batch_group:
            batch_group.append(_batch_group(mesh, plan, batch_spec)
                               if style == "auto" else None)
        return batch_group[0]

    def grads_of(ts: TrainState, batch):
        keys = list(ts.params)
        params = ts.params if layout is None else layout.gather(ts.params)
        vals = [params[k] for k in keys]
        tp = layout.tp_context() if layout is not None else None
        if tp is not None:
            tp.note(params)
        axes = layout.axes_context() if layout is not None else None
        if axes is not None:
            batch = layout.local_batch(batch, batch_spec)
        rows = batch_axes()
        if grad_accum_steps > 1 and rows is not None:
            batch = _microbatch_rows(batch, rows, grad_accum_steps)
        loss_sum, acc, mstate = None, None, ts.model_state
        for mb in _split(batch, grad_accum_steps) if grad_accum_steps > 1 else [batch]:
            with (_tensor_parallel.active(tp), _sequence_parallel.active(axes),
                  _batch_parallel.active(rows)):
                if tp is not None and tp.names is not None:
                    with tp.watch():
                        loss, mstate = loss_fn(params, mstate, mb)
                else:
                    loss, mstate = loss_fn(params, mstate, mb)
                if watch.armed:
                    watch.check(loss)
                g = torch.autograd.grad(loss, vals, allow_unused=True)
            if layout is not None and not unused_checked:
                unused_checked.append(True)
                if all(x is None for x in g):
                    raise ValueError(
                        "loss_fn computed its loss without the params it was "
                        "given; under a layout they are the gathered blocks, "
                        "so compute from them (torch.func.functional_call)")
                if layout.sp_axis is not None and not axes.entered:
                    raise ValueError(
                        f"under a plan with sp={layout.mesh.shape[layout.sp_axis]} "
                        f"loss_fn gets this worker's sequence block of the batch, "
                        f"but no sequence-parallel attention ran over "
                        f"'{layout.sp_axis}' (the port's TransformerLM and "
                        f"EncoderBlock, ring_attention, zigzag_ring_attention or "
                        f"ulysses_attention): its result would be a block's, "
                        f"not the sequence's")
            g = [torch.zeros_like(v) if x is None else x for x, v in zip(g, vals)]
            if acc is None:
                acc, loss_sum = g, loss.detach()
            else:
                torch._foreach_add_(acc, g)
                loss_sum = loss_sum + loss.detach()
        if grad_accum_steps > 1:
            torch._foreach_div_(acc, float(grad_accum_steps))
            loss_sum = loss_sum / grad_accum_steps
        return dict(zip(keys, acc)), loss_sum, mstate, tp

    def single(ts: TrainState, batch, want_stats: bool | None = None):
        """One update: ``(state, loss, grad_norm, model_stats)``, the norm
        None unless the step carries it, the stats None unless the step
        has them and ``want_stats`` (default: the step's own setting)
        asks: ``(table, noise)``, the
        :func:`~fluxmpi_tpu_torch.telemetry.modelstats.stats_tensor` of
        this update and its ``[2]`` noise ingredients (or None)."""
        want = stats_on if want_stats is None else (stats_on and want_stats)
        grads, loss, mstate, tp = grads_of(ts, batch)
        local_sq = _global_norm(grads).square() if want and noise_on else None
        if layout is not None:
            grads, loss = layout.reduce(grads, loss)
            # The first update's claims decide the blocks of the next.
            layout.settle(tp)
            gnorm = layout.global_norm(grads) if carry_norm else None
        else:
            if grad_reduce is not None:
                # The loss rides in the gradients' flat f32 collective.
                grads, loss = _reduce((grads, loss), grad_reduce, axis_group)
            gnorm = _global_norm(grads) if carry_norm else None
        if (style == "shard_map" and state_reduce == "mean" and mstate is not None
                and runtime.is_initialized()):
            mstate = _mean_floating(mstate, axis_group)
        updates, ts.opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        stats = None
        if want:
            # Read before the parameters update in place (the μP ratio's
            # denominator is the pre-update norm).
            if not plans:
                plans.append(_modelstats.StatsPlan(ts.params, stats_depth))
            owned = None
            if layout is not None and layout.shards:
                owned = layout.owned(plans[0].keys)
            table = _modelstats.stats_tensor(plans[0], grads, ts.params, updates,
                                             owned=owned)
            noise = None
            if noise_on:
                # Each worker's pre-all-reduce sq-norm, averaged over the
                # workers, and the reduced gradient's; a summed gradient
                # is workers x the mean, so its sq-norm is rescaled.
                (local_mean,) = allreduce_gradients([local_sq.reshape(1)],
                                                    reduce_op="mean")
                global_sq = gnorm.square()
                if grad_reduce == "sum":
                    global_sq = global_sq / float(stats_workers) ** 2
                noise = torch.stack([local_mean.reshape(()), global_sq])
            stats = (table, noise)
        apply_updates(ts.params, updates)
        ts.model_state = mstate
        ts.step += 1
        return ts, loss, gnorm, stats

    def aux(loss, gnorm, stats):
        if not carry_norm:
            return loss
        return (loss, gnorm, stats) if stats_on else (loss, gnorm)

    if scan_steps == 1:
        def core(ts: TrainState, batch):
            if not donate:
                ts = _copy_state(ts)
            ts, loss, gnorm, stats = single(ts, batch)
            return ts, aux(loss, gnorm, stats)
    else:
        def core(ts: TrainState, batches):
            if not donate:
                ts = _copy_state(ts)
            losses, norms = [], []
            for i in range(scan_steps):
                # The stats describe the newest update, as a flush reads.
                ts, loss, gnorm, stats = single(
                    ts, pytree.tree_map(lambda x: x[i], batches),
                    want_stats=i == scan_steps - 1)
                losses.append(loss)
                norms.append(gnorm)
            return ts, aux(torch.stack(losses),
                           torch.stack(norms) if carry_norm else None, stats)

    if carry_norm:
        step = _instrument_step(core, metrics if instrument else False, scan_steps,
                                stats_plans=plans if stats_on else None,
                                stats_workers=stats_workers)
        # train_loop drives the uninstrumented core (a per-step wait is
        # what it exists to avoid) and honours the spec at its flushes.
        step.__fluxmpi_compiled__ = core
        step.__fluxmpi_metrics__ = metrics if instrument else None
    else:
        step = core
    step.scan_steps = scan_steps  # read by train_loop
    # The layout the step runs (read by train_loop's checkpoint guard) and
    # the batch layout its rows follow.
    step.__fluxmpi_layout__ = layout
    step.batch_spec = batch_spec
    aux_names = ("loss", "grad_norm") if carry_norm else ("loss",)
    if stats_on:
        aux_names += ("model_stats",)
        # What train_loop needs to turn the flushed stats into the plane's
        # tree: the plan the first update makes (its group names) and the
        # worker count the noise scale divides by.
        core.__fluxmpi_model_stats_meta__ = {
            "depth": stats_depth, "workers": stats_workers, "plans": plans}
    def prepare(ts: TrainState, device: Any, noted: list) -> None:
        """Every process group an update of this step runs a collective
        over, made and warmed once (a one-element all-reduce each, in one
        order on every worker), so that a CUDA graph captured next makes
        no group and finds every NCCL communicator up: the world, the
        subgroups ``noted`` (``[(mesh, axes)]``: those the eager first
        window asked :meth:`~fluxmpi_tpu_torch.parallel.sharding.Mesh.group`
        for, the model's own among them: the MoE layers' ep exchanges and sp
        gathers, Ulysses' all-to-alls, the batch axes'; the ring's exchanges
        run point to point over the world's communicator), and those of the
        settled layout,
        whose tensor-parallel blocks the first update settles, so that a
        1-update first window has not yet run its later updates'
        gathers and reductions. Called by the window program after its
        eager first window."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
            return
        dist.all_reduce(torch.zeros(1, device=device))
        if layout is not None and layout.world > 1:
            noted = noted + [(layout.mesh, a) for a in layout.used_axes(list(ts.params))]
        for mesh, axes in {(id(m), a): (m, a) for m, a in noted}.values():
            mesh.warm(axes, device)

    # What make_window_program needs to fuse this step's math into a flush
    # window: the single-update body (the window sequences updates itself,
    # so a scan_steps wrapper is irrelevant there), the aux it carries and
    # the groups it warms; and why train_loop keeps this step pipelined
    # across workers (None: it fuses there too, under every plan axis).
    across = None
    if style == "shard_map":
        across = ('fused windows across workers run the default style="auto" '
                  'step; a style="shard_map" step runs pipelined there, as the '
                  'JAX package declines it')
    step.__fluxmpi_window_meta__ = {"single": single, "aux": aux_names,
                                    "prepare": prepare, "across_workers": across}
    return step


def _reduce(tree: Any, op: str, axis_group: Any = None) -> Any:
    """``tree`` reduced (``"mean"``/``"sum"``) over the world, or over
    ``axis_group`` (``(group, size)``) in one flat collective per dtype."""
    if axis_group is None:
        return allreduce_gradients(tree, reduce_op=op)
    import torch.distributed as dist

    from ..comm import fused

    group, size = axis_group

    def run(flat):
        dist.all_reduce(flat, group=group)
        if op == "mean":
            flat.div_(size)

    return fused(tree, run)


def _mean_floating(tree: Any, axis_group: Any = None) -> Any:
    """``tree`` with its floating tensor leaves averaged over the workers
    (or over ``axis_group``; one flat collective per dtype); other leaves
    as they are."""
    leaves, spec = pytree.tree_flatten(tree)
    idx = [i for i, x in enumerate(leaves)
           if torch.is_tensor(x) and x.is_floating_point()]
    if idx:
        reduced = _reduce([leaves[i].detach() for i in idx], "mean", axis_group)
        for i, r in zip(idx, reduced):
            leaves[i] = r
    return pytree.tree_unflatten(leaves, spec)


def _state_tensors(ts: TrainState) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves((ts.params, ts.opt_state, ts.model_state))
            if torch.is_tensor(t)]


def _any_worker(flag: bool) -> bool:
    """``flag`` OR-ed over the runtime's workers, in one exchange over its
    host (gloo) group; ``flag`` itself in a world of one."""
    if not runtime.is_initialized() or runtime.process_count() < 2:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=runtime._state.host_group)
    return bool(t.item())


def _agree_outcome(error: str | None, what: str) -> None:
    """Raise on every worker when ``error`` (this worker's failure of
    ``what``, None when it succeeded) is set on any worker, naming those
    workers: one exchange over the runtime's host (gloo) group; nothing in
    a world of one, where the caller raises its own error."""
    if not runtime.is_initialized() or runtime.process_count() < 2:
        return
    import torch.distributed as dist

    views: list = [None] * runtime.process_count()
    dist.all_gather_object(views, error, group=runtime._state.host_group)
    failed = [(r, e) for r, e in enumerate(views) if e is not None]
    if failed:
        who = ", ".join(str(r) for r, _ in failed)
        raise RuntimeError(
            f"{what} failed on worker {who} ({failed[0][1]}); every worker "
            f"raises, none replays")


def _launch_counts() -> dict[str, int]:
    """The attention kernels' launch counters (one increment per launch
    their wrappers make, captured launches included)."""
    from ..ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    return {f.__name__: f.launches for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}


class WindowProgram:
    """``(state, data, perm, start) -> (state, metrics)``: ``width``
    updates of a step's single-update body, update ``i`` on the batch
    :func:`~fluxmpi_tpu_torch.data._gather_batch` takes at sample offset
    ``start + i * lbs`` of the epoch permutation ``perm`` from the staged
    dataset ``data``. ``metrics`` holds f32 scalars: ``loss`` (the last
    update's, the value the pipelined flush reports), ``loss_sum`` and
    ``loss_max`` over the window (the sum in update order, in f32), and,
    for an instrumented step, ``grad_norm`` (the last update's; on the
    card a device output the graph writes); for a step with the model
    stats built in, also ``model_stats`` (the last update's
    ``[groups, 4]`` table) and ``noise`` (its ``[2]`` noise ingredients,
    where the step has them), computed by the last update only.

    On the CPU each call runs the window eagerly. On the card the first
    call runs it eagerly as real updates on the program's capture stream
    (cuBLAS, the allocator, autograd and the kernels' first-use build warm
    up there); the second call captures the window as one CUDA graph
    (``capture_seconds``: capture and instantiation), and every call from
    then on is one replay: the host copies the permutation and the start
    offset into the graph's static buffers and replays, and the state
    advances in place. The graph is recaptured when the state's or the
    dataset's tensors are other tensors than it was captured against (a
    fresh ``TrainState``, a restaged dataset; ``recaptures`` counts them,
    ``captures`` every capture). A capture or replay that fails raises;
    nothing falls back to eager windows.

    In a world of several workers (one per card) the window holds the
    step's collectives (NCCL's, on the device; under a plan over the world
    and its subgroups, the model's own exchanges among them, and under
    ``pp`` every tick of the pipeline's schedule: its point-to-point
    exchanges over the world's communicator, bubble ticks' included, and
    their backward): the eager first window runs them for real, noting
    every subgroup it asks a mesh for, and then ``prepare`` (the step's)
    warms those and every group the
    settled layout uses with one collective each, so their communicators
    exist before the capture records them (a capture that asks for a
    subgroup nobody warmed raises), and every card
    replays its graph in lockstep with its peers'. A recapture is agreed
    over the runtime's host group before each replay (one exchange per
    window): when any worker must capture, every worker does, so no card
    waits in a collective another card never issues; and the capture's
    outcome is agreed before the first replay: a capture that failed on
    one worker raises on every worker, naming it.

    Launch accounting per attention kernel: ``captured_launches`` are the
    launches inside the current graph. The wrappers' counters rise while a
    graph is captured, which launches nothing; ``capture_counted`` sums
    those rises over every capture. A replay launches the graph's kernels
    without the wrappers; ``replayed_launches`` adds the replayed graph's
    ``captured_launches`` on every replay. So the device ran the wrappers'
    counts ``- capture_counted + replayed_launches``.

    ``built``: whether the program has finished building (on the card: its
    graph is captured; on the CPU: it has run once), which ``train_loop``
    reads for the compile plane's warmup boundary. Every capture is
    reported to the compile plane as a compile event."""

    def __init__(self, single: Callable, width: int, lbs: int, aux: tuple,
                 prepare: Callable):
        self.single = single
        self.prepare = prepare
        self.width = width
        # The scalar metric names, in the order of the captured output's
        # rows; the model stats are outputs of their own.
        self.names = ("loss", "loss_sum", "loss_max") + tuple(
            a for a in aux[1:] if a != "model_stats")
        self.stats = "model_stats" in aux
        self.lbs = lbs
        self.replays = 0
        self.captured_launches: dict[str, int] = {}
        self.capture_counted: Counter = Counter()
        self.replayed_launches: Counter = Counter()
        self.capture_seconds = 0.0
        # Captures of this program, and those that replaced a graph because
        # the state's or the dataset's tensors moved (train_loop counts each
        # as a window-cache miss: a new build in what should be a replay).
        self.captures = 0
        self.recaptures = 0
        # The seconds of the last call that were the program's compile
        # work: the capture and instantiation of a capturing call; none of
        # an eager window (its updates are real steps) or a replay.
        self.last_compile_seconds = 0.0
        # FLOPs of one call (all ``width`` updates), counted by train_loop
        # on an eager call when the goodput plane asks for them.
        self.flops: float | None = None
        self.graph = None
        self._warm = False
        self._cpu = False
        self._stream = None
        self._bound: tuple = ()
        self._generators: list = []

    def _run(self, ts: TrainState, data: Any, perm: torch.Tensor,
             start: torch.Tensor):
        loss_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
        loss_max = torch.full((), float("-inf"), dtype=torch.float32,
                              device=perm.device)
        gnorm = stats = None
        for i in range(self.width):
            batch = _gather_batch(data, perm, start + i * self.lbs, self.lbs)
            # The model stats describe the window's last update, as the
            # pipelined flush reads them.
            ts, loss, gnorm, stats = self.single(ts, batch,
                                                 want_stats=i == self.width - 1)
            loss = loss.detach().float().reshape(())
            loss_sum = loss_sum + loss
            loss_max = torch.maximum(loss_max, loss)
        metrics = {"loss": loss, "loss_sum": loss_sum, "loss_max": loss_max}
        if gnorm is not None:
            metrics["grad_norm"] = gnorm.detach().float().reshape(())
        if stats is not None:
            metrics["model_stats"] = stats[0]
            if stats[1] is not None:
                metrics["noise"] = stats[1]
        return ts, metrics

    @property
    def built(self) -> bool:
        return self.graph is not None or (self._cpu and self._warm)

    def __call__(self, ts: TrainState, data: Any, perm: torch.Tensor,
                 start: int):
        dev = perm.device
        self.last_compile_seconds = 0.0
        if dev.type != "cuda":
            first = not self._warm
            self._warm = self._cpu = True
            at = torch.full((), int(start), dtype=torch.int64, device=dev)
            with _sharding.noting_groups() as noted:
                ts, metrics = self._run(ts, data, perm, at)
            if first:
                self.prepare(ts, dev, noted)
            return ts, metrics
        if not self._warm:
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream), \
                    runtime.watch_graph_generators() as drawn, \
                    _sharding.noting_groups() as noted:
                at = torch.full((), int(start), dtype=torch.int64, device=dev)
                ts, metrics = self._run(ts, data, perm, at)
            self._generators = drawn
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            self.prepare(ts, dev, noted)
            self._warm = True
            return ts, metrics
        bound = tuple(t.data_ptr() for t in
                      _state_tensors(ts) + pytree.tree_leaves(data))
        if _any_worker(self.graph is None or bound != self._bound):
            self.recaptures += self.graph is not None
            before = self.capture_seconds
            self._capture_agreed(ts, data, perm)
            self._bound = bound
            self.last_compile_seconds = self.capture_seconds - before
        self._perm.copy_(perm)
        self._start.fill_(int(start))
        self.graph.replay()
        self.replays += 1
        self.replayed_launches.update(self.captured_launches)
        ts.step += self.width
        metrics = dict(zip(self.names, self._out.clone()))
        for name, buf in self._extra.items():
            metrics[name] = buf.clone()
        return ts, metrics

    def _capture_agreed(self, ts: TrainState, data: Any, perm: torch.Tensor) -> None:
        """:meth:`_capture`, its outcome agreed over the runtime's host
        group before any worker replays: when the capture failed on any
        worker, every worker drops its graph and raises, naming the
        workers that failed, so no card waits in a collective of a graph
        a peer never replays."""
        error = None
        try:
            self._capture(ts, data, perm)
        except Exception as exc:
            error = exc
        try:
            _agree_outcome(None if error is None else str(error),
                           f"capturing the {self.width}-update window as a CUDA graph")
        except RuntimeError as agreed:
            self.release_graph()
            raise agreed from error
        if error is not None:
            raise error

    def _capture(self, ts: TrainState, data: Any, perm: torch.Tensor) -> None:
        dev = perm.device
        self._perm = torch.empty_like(perm)
        self._start = torch.zeros((), dtype=torch.int64, device=dev)
        step0, mstate0 = ts.step, ts.model_state
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # The CUDA generators the eager window drew from: registered, each
        # replay advances them as the eager updates did (the default
        # generator is registered by the capture itself).
        for gen in self._generators:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this torch cannot register a CUDA generator with a CUDA "
                    "graph, so every replay would repeat the captured draws; "
                    "run this step with train_loop(fuse=False)")
            graph.register_generator_state(gen)
        from ..telemetry import compileplane
        from ..utils.profiling import capture_lock

        # No profiler starts or stops while the graph is captured.
        with capture_lock:
            t0 = time.perf_counter()
            try:
                # thread_local: a checkpoint writer or NCCL's watchdog may
                # use CUDA on their own threads while this one captures.
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    ts, metrics = self._run(ts, data, self._perm, self._start)
                    # The carried model state returns to the tensors the
                    # graph reads, so each replay starts from the last one's.
                    for src, dst in zip(pytree.tree_leaves(ts.model_state),
                                        pytree.tree_leaves(mstate0)):
                        if torch.is_tensor(dst):
                            dst.copy_(src)
                    self._out = torch.stack([metrics[k] for k in self.names])
                    self._extra = {k: metrics[k] for k in ("model_stats", "noise")
                                   if k in metrics}
            except Exception as exc:
                raise RuntimeError(
                    f"capturing the {self.width}-update window as a CUDA graph "
                    f"failed ({exc}); the step must run without reading device "
                    f"values on the host") from exc
            finally:
                ts.step, ts.model_state = step0, mstate0
            seconds = time.perf_counter() - t0
        self.capture_seconds += seconds
        self.captures += 1
        compileplane.note_duration(compileplane.CAPTURE_EVENT, seconds)
        after = _launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.capture_counted.update(self.captured_launches)
        self.graph = graph
        runtime.note_captured_graph(self)

    def release_graph(self) -> None:
        """Drop the captured graph (:func:`~fluxmpi_tpu_torch.runtime.shutdown`
        calls this before the process groups its collectives ran on go);
        the next call captures anew."""
        self.graph, self._bound = None, ()


def make_window_program(step: Any, *, width: int, lbs: int) -> WindowProgram:
    """Fuse a whole flush window into ONE program: ``width`` sequential
    updates of ``step``'s single-update body, each batch gathered from the
    staged dataset inside it, with the interval metrics (last, sum and max
    loss) carried along. Returns a :class:`WindowProgram`, ``(state, data,
    perm, start) -> (state, metrics)``: ``data`` and ``perm`` as
    :meth:`~fluxmpi_tpu_torch.DistributedDataLoader.device_epoch` gives
    them, ``start`` the first sample offset (batch cursor x ``lbs``).

    ``step`` must come from :func:`make_train_step`, which attaches the
    single-update body (``__fluxmpi_window_meta__``); the gather is
    :func:`~fluxmpi_tpu_torch.data._gather_batch`, the loader's own, so
    the fused and the pipelined paths consume identical batches.
    ``train_loop(fuse="window")`` builds and caches these per width."""
    meta = getattr(step, "__fluxmpi_window_meta__", None)
    if meta is None:
        raise ValueError(
            "make_window_program needs a step built by make_train_step — "
            "foreign steps carry no fused-window metadata")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    return WindowProgram(meta["single"], width, lbs, meta["aux"], meta["prepare"])


def _gathered_rows(batch: Any, rows: Any) -> Any:
    """The global batch on every member of the batch axes ``rows``: each
    tensor leaf of this worker's rows all-gathered over their group and
    concatenated in block order (the loader's rows of block ``k`` are the
    ``k``-th slice of the global batch); other leaves as they are."""
    import torch.distributed as dist

    group = rows.group
    members = dist.get_process_group_ranks(group)
    at = [members.index(r) for r in rows.ranks]

    def gather(x):
        if not torch.is_tensor(x):
            return x
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat([parts[i] for i in at])

    return pytree.tree_map(gather, batch)


def make_eval_step(metric_fn: Callable[[dict, Any, Any], Any], *,
                   parallel: Any = None, mesh: Any = None,
                   axis_name: str | None = None, state_sharding: Any = None,
                   batch_spec: Any = None, policy: Any = None):
    """Build ``eval_step(state, batch) -> metrics``.

    ``metric_fn(params, model_state, batch)`` returns any pytree of
    metrics, without autograd; reductions written over the global batch
    (a mean, a sum, a max, a count) see every worker's rows, so the
    returned metrics are already globally correct, and replicated: every
    worker returns the same value, the JAX package's (no separate
    collective pass). ``batch`` is this worker's rows, as the train step
    takes them (the loader's); in a world of several workers the step
    all-gathers the rows over the batch axes (a plan's ``dp`` and
    ``fsdp``, or the whole world without a plan) and runs ``metric_fn``
    once on the global batch on every worker, which costs the batch axes'
    size times one worker's share of the eval compute. Under ``sp`` the
    rows are gathered and each worker's sequence block is cut as in
    training.

    ``parallel``/``state_sharding``/``batch_spec`` as in
    :func:`make_train_step`: a state laid out by a plan evaluates in its
    training layout (its sharded parameters gathered first). ``policy``
    casts the parameters to its compute dtype entering ``metric_fn``, as
    in training."""
    plan = None
    if parallel is not None:
        plan, mesh, axis_name, batch_spec, state_sharding = _plan_defaults(
            parallel, mesh, axis_name, batch_spec, state_sharding, "make_eval_step")
    else:
        plan, mesh, axis_name, batch_spec = _installed_plan_defaults(
            mesh, axis_name, batch_spec)
    if mesh is None and runtime.is_initialized():
        mesh = runtime.global_mesh()
    layout = None
    if plan is not None or state_sharding is not None:
        layout = _make_layout(plan, mesh, state_sharding)
    batch_group: list = []

    def step(ts: TrainState, batch):
        if not batch_group:
            batch_group.append(_batch_group(mesh, plan, batch_spec))
        with torch.no_grad():
            if batch_group[0] is not None:
                batch = _gathered_rows(batch, batch_group[0])
            params = ts.params
            axes = None
            if layout is not None:
                params = layout.gather(params)
                axes = layout.axes_context()
                if axes is not None:
                    batch = layout.local_batch(batch, batch_spec)
            params = params if policy is None else policy.cast_to_compute(params)
            with _sequence_parallel.active(axes):
                return metric_fn(params, ts.model_state, batch)

    return step
