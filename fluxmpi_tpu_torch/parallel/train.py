"""Data-parallel train and eval steps.

Counterpart of :mod:`fluxmpi_tpu.parallel.train` in its explicit
per-worker form (the JAX package's ``style="shard_map"``, the reference's
training loop): each worker runs forward and backward on its local shard
of the batch, the gradients are all-reduced across the workers in one
flat collective per dtype (``grad_reduce="mean"`` by default, ``"sum"``,
or ``None`` when a :func:`~fluxmpi_tpu_torch.DistributedOptimizer`
reduces them), the floating leaves of the new model state (BatchNorm's
running statistics) are averaged across the workers
(``state_reduce="mean"`` by default, or kept per worker with
``"local"``), and the optimizer rule updates the parameters in place.
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
boundaries.

Not ported yet (each raises ``NotImplementedError`` when passed):
``parallel=``, ``mesh=``, ``axis_name=``, ``style=``, ``donate=``,
``state_sharding=``, ``batch_spec=`` and ``model_stats=``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import Counter
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as _checkpoint

from .. import runtime
from ..data import _gather_batch
from ..errors import refuse_unported
from ..optim import GradientTransformation, apply_updates
from ..optimizer import allreduce_gradients

__all__ = ["TrainState", "make_eval_step", "make_train_step",
           "make_window_program"]

_WAITING = ("parallel", "mesh", "axis_name", "style", "donate",
            "state_sharding", "batch_spec", "model_stats")

# metrics=True: record into whatever the default registry is at record
# time (set_registry may swap it after the step is built).
_DEFAULT_REGISTRY = object()


def _refuse_waiting(fn: str, waiting: dict) -> None:
    unknown = [k for k in waiting if k not in _WAITING]
    if unknown:
        raise TypeError(f"{fn}() got unexpected arguments {unknown}")
    refuse_unported(fn, {k: v is not None and v is not False
                         for k, v in waiting.items()},
                    "the port's step is one worker's forward, backward and "
                    "gradient all-reduce over torch.distributed")


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


def _split(batch: Any, k: int) -> list[Any]:
    """``k`` micro-batches along each leaf's leading dimension."""
    leaves, spec = pytree.tree_flatten(batch)
    for x in leaves:
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"grad_accum_steps {k}")
    parts = [x.chunk(k) for x in leaves]
    return [pytree.tree_unflatten([p[i] for p in parts], spec) for i in range(k)]


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
            cast = policy.cast_to_compute(p)
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
            return _checkpoint.checkpoint(plain, p, mstate, batch,
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


def _instrument_step(core: Callable, metrics: Any, scan_steps: int) -> Callable:
    """Wrap ``core(state, batch) -> (state, (loss, grad_norm))`` into the
    public ``(state, loss)`` signature, recording telemetry per call: a
    ``train.step`` span, a :func:`~fluxmpi_tpu_torch.utils.profiling.
    step_timer` that waits for the loss and the norm before it stops the
    clock, a watchdog tick, and ``train.step_seconds``, ``train.loss``,
    ``train.grad_norm``, ``train.examples_per_sec``, ``train.steps`` and
    ``train.examples`` into the registry (or the monitor's, which also
    observes the step; or the hook, which gets the record)."""
    from ..telemetry import tracing as _tracing
    from ..telemetry.watchdog import notify_progress
    from ..utils.profiling import step_timer

    reg, monitor, hook = _resolve_metrics(metrics)

    def step(state, batch):
        holder: dict[str, float] = {}
        with _tracing.span("train.step"):
            with step_timer(holder) as t:
                new_state, (loss, gnorm) = core(state, batch)
                t.watch((loss, gnorm))
        notify_progress()
        seconds = holder["seconds"]
        leaves = pytree.tree_leaves(batch)
        examples = 0
        if leaves and getattr(leaves[0], "ndim", 0):
            examples = int(leaves[0].shape[0])
            if scan_steps > 1:  # leading axis is scan time, not data
                examples *= int(leaves[0].shape[1])
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


def make_train_step(
    loss_fn: Callable[[dict, Any, Any], tuple[torch.Tensor, Any]],
    optimizer: GradientTransformation,
    *,
    grad_reduce: str | None = "mean",
    state_reduce: str = "mean",
    grad_accum_steps: int = 1,
    scan_steps: int = 1,
    remat: bool | str = False,
    policy: Any = None,
    metrics: Any = None,
    **waiting,
) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """Build ``step(state, batch) -> (state, loss)``.

    ``loss_fn(params, model_state, batch) -> (loss, new_model_state)``
    computes this worker's scalar loss on its local batch (stateless
    models return ``None``).
    ``grad_reduce``: ``"mean"`` averages the gradients and the loss over
    the workers, ``"sum"`` sums them, ``None`` leaves them local.
    ``state_reduce``: ``"mean"`` averages every floating leaf of the new
    model state over the workers (BatchNorm's running statistics; integer
    leaves are kept), in one flat collective per dtype, as the JAX
    package's ``style="shard_map"`` step does; ``"local"`` keeps each
    worker's own. Before :func:`~fluxmpi_tpu_torch.init` there is one
    worker and nothing to average.
    ``grad_accum_steps=k`` splits each batch into ``k`` micro-batches and
    averages their gradients before the one update. ``scan_steps=K`` takes
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
    ``ddpm_loss`` does), advance on every replay.

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
    uninstrumented step's, bit for bit."""
    _refuse_waiting("make_train_step", waiting)
    instrument = metrics is not None and metrics is not False
    if instrument:
        _resolve_metrics(metrics)  # reject bad specs at build, not step 1
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

    def grads_of(ts: TrainState, batch):
        keys = list(ts.params)
        vals = [ts.params[k] for k in keys]
        loss_sum, acc, mstate = None, None, ts.model_state
        for mb in _split(batch, grad_accum_steps) if grad_accum_steps > 1 else [batch]:
            loss, mstate = loss_fn(ts.params, mstate, mb)
            if watch.armed:
                watch.check(loss)
            g = torch.autograd.grad(loss, vals, allow_unused=True)
            g = [torch.zeros_like(v) if x is None else x for x, v in zip(g, vals)]
            if acc is None:
                acc, loss_sum = g, loss.detach()
            else:
                torch._foreach_add_(acc, g)
                loss_sum = loss_sum + loss.detach()
        if grad_accum_steps > 1:
            torch._foreach_div_(acc, float(grad_accum_steps))
            loss_sum = loss_sum / grad_accum_steps
        return dict(zip(keys, acc)), loss_sum, mstate

    def single(ts: TrainState, batch):
        """One update: ``(state, loss, grad_norm)``, the norm None unless
        the step is instrumented."""
        grads, loss, mstate = grads_of(ts, batch)
        if grad_reduce is not None:
            # The loss rides in the gradients' flat f32 collective.
            grads, loss = allreduce_gradients((grads, loss), reduce_op=grad_reduce)
        gnorm = _global_norm(grads) if instrument else None
        if state_reduce == "mean" and mstate is not None and runtime.is_initialized():
            mstate = _mean_floating(mstate)
        updates, ts.opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        apply_updates(ts.params, updates)
        ts.model_state = mstate
        ts.step += 1
        return ts, loss, gnorm

    def aux(loss, gnorm):
        return (loss, gnorm) if instrument else loss

    if scan_steps == 1:
        def core(ts: TrainState, batch):
            ts, loss, gnorm = single(ts, batch)
            return ts, aux(loss, gnorm)
    else:
        def core(ts: TrainState, batches):
            losses, norms = [], []
            for i in range(scan_steps):
                ts, loss, gnorm = single(ts, pytree.tree_map(lambda x: x[i], batches))
                losses.append(loss)
                norms.append(gnorm)
            return ts, aux(torch.stack(losses),
                           torch.stack(norms) if instrument else None)

    step = _instrument_step(core, metrics, scan_steps) if instrument else core
    step.scan_steps = scan_steps  # read by train_loop
    if instrument:
        # train_loop drives the uninstrumented core (a per-step wait is
        # what it exists to avoid) and honours the spec at its flushes.
        step.__fluxmpi_compiled__ = core
        step.__fluxmpi_metrics__ = metrics
    # What make_window_program needs to fuse this step's math into a flush
    # window: the single-update body (the window sequences updates itself,
    # so a scan_steps wrapper is irrelevant there) and the aux it carries.
    step.__fluxmpi_window_meta__ = {
        "single": single,
        "aux": ("loss", "grad_norm") if instrument else ("loss",)}
    return step


def _mean_floating(tree: Any) -> Any:
    """``tree`` with its floating tensor leaves averaged over the workers
    (one flat collective per dtype); other leaves as they are."""
    leaves, spec = pytree.tree_flatten(tree)
    idx = [i for i, x in enumerate(leaves)
           if torch.is_tensor(x) and x.is_floating_point()]
    if idx:
        reduced = allreduce_gradients([leaves[i].detach() for i in idx], reduce_op="mean")
        for i, r in zip(idx, reduced):
            leaves[i] = r
    return pytree.tree_unflatten(leaves, spec)


def _state_tensors(ts: TrainState) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves((ts.params, ts.opt_state, ts.model_state))
            if torch.is_tensor(t)]


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
    card a device output the graph writes).

    On the CPU each call runs the window eagerly. On the card the first
    call runs it eagerly as real updates on the program's capture stream
    (cuBLAS, the allocator, autograd and the kernels' first-use build warm
    up there); the second call captures the window as one CUDA graph
    (``capture_seconds``: capture and instantiation), and every call from
    then on is one replay: the host copies the permutation and the start
    offset into the graph's static buffers and replays, and the state
    advances in place. The graph is recaptured when the state's or the
    dataset's tensors are other tensors than it was captured against (a
    fresh ``TrainState``, a restaged dataset). A capture or replay that
    fails raises; nothing falls back to eager windows.

    Launch accounting per attention kernel: ``captured_launches`` are the
    launches inside the current graph. The wrappers' counters rise while a
    graph is captured, which launches nothing; ``capture_counted`` sums
    those rises over every capture. A replay launches the graph's kernels
    without the wrappers; ``replayed_launches`` adds the replayed graph's
    ``captured_launches`` on every replay. So the device ran the wrappers'
    counts ``- capture_counted + replayed_launches``."""

    def __init__(self, single: Callable, width: int, lbs: int,
                 aux: tuple = ("loss",)):
        self.single = single
        self.width = width
        # The metric names, in the order of the captured output's rows.
        self.names = ("loss", "loss_sum", "loss_max") + tuple(aux[1:])
        self.lbs = lbs
        self.replays = 0
        self.captured_launches: dict[str, int] = {}
        self.capture_counted: Counter = Counter()
        self.replayed_launches: Counter = Counter()
        self.capture_seconds = 0.0
        # The seconds of the last call that were the program's compile
        # work: all of an eager first window (warm-up), the capture and
        # instantiation of a capturing call, none of a replay.
        self.last_compile_seconds = 0.0
        # FLOPs of one call (all ``width`` updates), counted by train_loop
        # on an eager call when the goodput plane asks for them.
        self.flops: float | None = None
        self.graph = None
        self._warm = False
        self._stream = None
        self._bound: tuple = ()
        self._generators: list = []

    def _run(self, ts: TrainState, data: Any, perm: torch.Tensor,
             start: torch.Tensor):
        loss_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
        loss_max = torch.full((), float("-inf"), dtype=torch.float32,
                              device=perm.device)
        gnorm = None
        for i in range(self.width):
            batch = _gather_batch(data, perm, start + i * self.lbs, self.lbs)
            ts, loss, gnorm = self.single(ts, batch)
            loss = loss.detach().float().reshape(())
            loss_sum = loss_sum + loss
            loss_max = torch.maximum(loss_max, loss)
        metrics = {"loss": loss, "loss_sum": loss_sum, "loss_max": loss_max}
        if gnorm is not None:
            metrics["grad_norm"] = gnorm.detach().float().reshape(())
        return ts, metrics

    def __call__(self, ts: TrainState, data: Any, perm: torch.Tensor,
                 start: int):
        dev = perm.device
        self.last_compile_seconds = 0.0 if self._warm else math.inf
        if dev.type != "cuda":
            self._warm = True
            at = torch.full((), int(start), dtype=torch.int64, device=dev)
            return self._run(ts, data, perm, at)
        if not self._warm:
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream), \
                    runtime.watch_graph_generators() as drawn:
                at = torch.full((), int(start), dtype=torch.int64, device=dev)
                ts, metrics = self._run(ts, data, perm, at)
            self._generators = drawn
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            self._warm = True
            return ts, metrics
        bound = tuple(t.data_ptr() for t in
                      _state_tensors(ts) + pytree.tree_leaves(data))
        if self.graph is None or bound != self._bound:
            before = self.capture_seconds
            self._capture(ts, data, perm)
            self._bound = bound
            self.last_compile_seconds = self.capture_seconds - before
        self._perm.copy_(perm)
        self._start.fill_(int(start))
        self.graph.replay()
        self.replays += 1
        self.replayed_launches.update(self.captured_launches)
        ts.step += self.width
        out = self._out.clone()
        return ts, dict(zip(self.names, out))

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
        t0 = time.perf_counter()
        try:
            # thread_local: a checkpoint writer or NCCL's watchdog may use
            # CUDA on their own threads while this one captures.
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                ts, metrics = self._run(ts, data, self._perm, self._start)
                # The carried model state returns to the tensors the graph
                # reads, so each replay starts from the last one's.
                for src, dst in zip(pytree.tree_leaves(ts.model_state),
                                    pytree.tree_leaves(mstate0)):
                    if torch.is_tensor(dst):
                        dst.copy_(src)
                self._out = torch.stack([metrics[k] for k in self.names])
        except Exception as exc:
            raise RuntimeError(
                f"capturing the {self.width}-update window as a CUDA graph "
                f"failed ({exc}); the step must run without reading device "
                f"values on the host") from exc
        finally:
            ts.step, ts.model_state = step0, mstate0
        self.capture_seconds += time.perf_counter() - t0
        after = _launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.capture_counted.update(self.captured_launches)
        self.graph = graph


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
    return WindowProgram(meta["single"], width, lbs, meta["aux"])


def make_eval_step(metric_fn: Callable[[dict, Any, Any], Any], *,
                   policy: Any = None, **waiting):
    """Build ``eval_step(state, batch) -> metrics``:
    ``metric_fn(params, model_state, batch)`` without autograd, on this
    worker's batch (reduce across workers with
    :func:`~fluxmpi_tpu_torch.allreduce` where a global value is
    wanted). ``policy`` casts the parameters to its compute dtype entering
    ``metric_fn``, as in training."""
    _refuse_waiting("make_eval_step", waiting)

    def step(ts: TrainState, batch):
        params = ts.params if policy is None else policy.cast_to_compute(ts.params)
        with torch.no_grad():
            return metric_fn(params, ts.model_state, batch)

    return step
