"""The training loop.

Counterpart of the core of :func:`fluxmpi_tpu.parallel.train_loop`: drive
a step from :func:`~fluxmpi_tpu_torch.parallel.make_train_step` over a
batch source for a ``steps`` or ``epochs`` budget, pipelined. PyTorch
launches a step's kernels asynchronously and returns, so the host runs
ahead of the device; the loop lets at most ``in_flight`` steps be
outstanding (waiting on a CUDA event recorded after the oldest) and
never reads a loss per step. Losses stay on the device until a flush:
every ``flush_every`` updates it drains to the newest step, reads that
step's loss and the interval's mean loss, and records the interval's
time per update.

One-program flush windows (``fuse="auto"``, the default, or
``"window"``): over a loader whose device-gather path is active, each
flush window (its batch gathers and its updates) runs as one program from
:func:`~fluxmpi_tpu_torch.parallel.train.make_window_program`, on the card
one CUDA-graph replay: one host dispatch per window instead of thousands
of kernel launches per update; with several workers (data-parallel, or
under a plan over any of dp, fsdp, tp, ep, sp and pp), one graph per
card, its collectives inside.
A replay runs no Python: a ``loss_fn``
with host-side state that changes between updates needs ``fuse=False``
(see :func:`train_loop`).

Fault tolerance: with a :class:`~fluxmpi_tpu_torch.utils.CheckpointManager`
as ``checkpoint=``, the loop banks its state (each worker its blocks of a
sharded one), counters and loader position every ``save_every`` updates,
resumes from the newest committed step with ``resume=True`` (on another
topology too: the restore reshards into the step's layout and the loader
remaps its cursor), and on preemption (:func:`~fluxmpi_tpu_torch.runtime.
request_preemption`, or SIGTERM with the handler installed) drains, banks
an emergency checkpoint and returns. With the resize plane armed
(:mod:`fluxmpi_tpu_torch.fleet.resize`) a requested resize drains the
same way, banks a timed final save and the handoff stamp, and the resumed
world completes the resize record.

Telemetry, as in the JAX package: ``metrics=`` (or the spec the step was
built with) records ``train.*`` at flush boundaries from the interval's
wall time, never per update; the goodput plane books the run's wall time
into its buckets and live MFU (FLOPs counted once, at the first
dispatch); every dispatch is a watchdog tick; a
``torch.cuda.OutOfMemoryError`` escaping the dispatch loop writes the OOM
bundle before it is re-raised. At each flush the run-health and
live-export planes read what the flush drained: the anomaly detector
judges the interval (a ``"halt"`` rule stops the run at that flush), the
compile monitor attributes builds and CUDA-graph captures, the model-stats
plane emits the per-layer stats the step carried, and the exporter's
``/status`` boards (train, model, fleet) are updated. With every plane off
the loop reads no tracker clock and records nothing.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import runtime
from ..comm import WORLD, allreduce
from ..data import DistributedDataLoader, scan_batches
from ..telemetry import anomaly as _anomaly
from ..telemetry import compileplane as _compileplane
from ..telemetry import export as _export
from ..telemetry import fleet as _fleet
from ..telemetry import goodput as _goodput
from ..telemetry import modelstats as _modelstats
from ..telemetry import tracing as _tracing
from ..fleet import resize as _resize
from ..telemetry.watchdog import notify_progress
from ..utils import checkpoint as _ckpt
from ..utils import manifest as _manifest_util
from ..utils.manifest import map_with_path, named_leaves
from .train import (_live_registry, _resolve_metrics, _state_tensors,
                    make_window_program)

__all__ = ["train_loop"]


def _stall_timed(it: Any, gp: Any) -> Iterable[Any]:
    """Wrap an epoch iterator so the host's wait for each batch lands in
    the goodput ``data_stall`` bucket (enabled tracker only; the off path
    iterates the source directly)."""
    clock = gp._clock
    while True:
        t0 = clock()
        try:
            batch = next(it)
        except StopIteration:
            return
        gp.add("data_stall", clock() - t0)
        yield batch


def _maybe_oom_forensics(exc: BaseException, registry: Any) -> None:
    """On a device out-of-memory error escaping the dispatch loop, write
    the OOM bundle (live-tensor census, the allocator's stats, the peak
    watermark, the watchdog's dump sections) before the caller re-raises.
    Any other exception passes through untouched."""
    from ..telemetry import memory as _memory

    if not _memory.is_oom_error(exc):
        return
    try:
        path = _memory.write_oom_bundle(exc, registry=registry)
        warnings.warn(
            f"device out of memory: OOM forensics bundle written to {path} "
            f"(live-tensor census + memory watermark)", stacklevel=3)
    except Exception as bundle_exc:  # forensics must never mask the OOM
        warnings.warn(f"OOM forensics bundle write failed: {bundle_exc!r}",
                      stacklevel=3)


def _first_dispatch(run: Any, gp: Any, updates: int) -> Any:
    """Run the first dispatch of a pipelined run under the goodput
    ``compile`` segment, counting its FLOPs (``updates`` updates) for live
    MFU when the tracker has none yet."""
    with gp.segment("compile"):
        if gp._flops_per_update is not None:
            return run()
        from ..utils.flops import count_flops

        with count_flops() as count:
            out = run()
    gp.set_flops_per_update(count.total / updates)
    return out


def _epoch_iter(batches: Any, scan_steps: int) -> Iterable[Any]:
    if scan_steps > 1 and isinstance(batches, DistributedDataLoader):
        return scan_batches(batches, scan_steps)
    return iter(batches)


def _epoch_len(batches: Any, scan_steps: int) -> int | None:
    try:
        n = len(batches)
    except TypeError:
        return None
    if scan_steps > 1 and isinstance(batches, DistributedDataLoader):
        return n // scan_steps
    return n


def _fused_window_width(step: Any, batches: Any, flush_every: int,
                        steps: int | None, scan_k: int, forced: bool,
                        workers: int = 1) -> tuple[int, str | None]:
    """This worker's fused-window width for ``train_loop(fuse=...)``: the
    updates one window program drives, or 0 when the fused path cannot
    drive this (step, loader) pair, with the failing condition (None when
    ``"auto"`` keeps the pipelined path only to keep what a budget
    means). :func:`_agreed_window_width` makes it the world's.

    The width is ``flush_every`` clamped to the epoch length (an epoch
    shorter than the flush interval fuses as one window per pass), and the
    epoch must divide into whole windows. Across ``workers > 1`` the
    window runs every axis of a plan (dp, fsdp, tp, ep, sp and pp) over
    device collectives, with host staging too (it stages the eager
    collectives only; the step's reductions stay on the device, as in the
    JAX package's jitted step); a ``style="shard_map"`` step declines."""
    if not isinstance(batches, DistributedDataLoader):
        return 0, "batches is not a DistributedDataLoader"
    meta = getattr(step, "__fluxmpi_window_meta__", None)
    if meta is None:
        return 0, ("the step carries no fused-window metadata — build it "
                   "with make_train_step")
    if workers > 1:
        if meta.get("across_workers") is not None:
            return 0, meta["across_workers"]
    why = batches.fusible_declined()
    if why is not None:
        return 0, (f"{why} (the window needs an array-backed dataset without "
                   f"transform=, staged within FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES, "
                   f"whole full batches per epoch)")
    nb = len(batches)
    if nb < 1:
        return 0, "the loader has no full batches"
    width = min(flush_every, nb)
    if nb % width:
        return 0, (f"epoch of {nb} batches does not divide into flush_every="
                   f"{flush_every} windows (width {width}) — pick a flush_every "
                   f"that divides the epoch")
    if not forced and steps is not None and steps % width:
        # Windows round a steps budget up to whole windows; "auto" must not
        # change how many updates `steps` means, so it keeps the pipelined
        # path (fuse="window" opts into the rounding).
        return 0, None
    if not forced and scan_k > 1 and (
            nb % scan_k or (steps is not None and steps % scan_k)):
        # The pipelined path's scan_batches drops a ragged trailing scan
        # group and rounds a steps budget up to whole groups, while the
        # window sequences single updates over every batch: "auto" keeps
        # what an epoch and a budget mean for a scan_steps step.
        return 0, None
    return width, None


def _agreed_window_width(width: int, reason: str | None, forced: bool,
                         workers: int) -> int:
    """The width every worker runs: in a world of several, the MIN of the
    workers' widths over the runtime's host group (one exchange per
    ``train_loop``, before the first window), so no worker replays a
    window's collectives while another runs an eager step. ``forced``
    (``fuse="window"``) raises on every worker, naming the first worker
    that declined and its reason."""
    who = None
    if workers > 1:
        import torch.distributed as dist

        views: list = [None] * workers
        dist.all_gather_object(views, (width, reason), group=runtime._state.host_group)
        width = min(w for w, _ in views)
        who, reason = next(((r, why) for r, (w, why) in enumerate(views)
                            if not w and why is not None), (None, reason))
    if forced and not width:
        where = f" on worker {who}" if who is not None else ""
        raise ValueError(f'fuse="window" unavailable{where}: {reason}')
    return width


def _aval_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """(shape, dtype, device) of each tensor: the part of the window
    program cache's key that makes a cached program safe to reuse."""
    return tuple((tuple(t.shape), str(t.dtype), str(t.device)) for t in tensors)


def _batch_examples(batch: Any, scan_steps: int) -> int:
    leaves = pytree.tree_leaves(batch)
    if not leaves or not getattr(leaves[0], "ndim", 0):
        return 0
    shape = tuple(leaves[0].shape)
    if scan_steps > 1:  # leading axis is scan time, not data
        return int(shape[0]) * int(shape[1]) if len(shape) > 1 else 0
    return int(shape[0])


def _loss_device(loss: Any) -> torch.device | None:
    leaves = [x for x in pytree.tree_leaves(loss) if torch.is_tensor(x)]
    return leaves[0].device if leaves else None


class _Marker:
    """Completion of one dispatched step: a timing CUDA event recorded
    after it on the current stream, or the host clock on the CPU (where
    the step has completed when it returns)."""

    def __init__(self, device: torch.device | None):
        self.event = None
        self.host = time.perf_counter()
        if device is not None and device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def ms_since(self, prev: "_Marker") -> float:
        """Time between two steps' completions (both waited on)."""
        if self.event is not None and prev.event is not None:
            return prev.event.elapsed_time(self.event)
        return (self.host - prev.host) * 1e3


def _untagged_block(state: Any, layout: Any) -> str | None:
    """The first parameter the step's layout shards whose parameter or
    optimizer moment (a tensor under that parameter's key in the state's
    parameters or optimizer state) carries no layout tag, else None."""
    from .sharding import sharding_of

    sharded = {k for k, (gathered, local) in layout.plans.items() if gathered or local}

    def walk(x: Any, key: Any) -> str | None:
        if isinstance(x, dict):
            items = x.items()
        elif isinstance(x, (list, tuple)):
            items = ((key, v) for v in x)
        else:
            return key if (torch.is_tensor(x) and key in sharded
                           and sharding_of(x) is None) else None
        return next((hit for k, v in items if (hit := walk(v, k)) is not None), None)

    return walk([getattr(state, "params", None), getattr(state, "opt_state", None)],
                None)


def train_loop(step: Any, state: Any, batches: Any, *,
               steps: int | None = None, epochs: int | None = None,
               scan_steps: int | None = None, in_flight: int = 2,
               flush_every: int = 50, fuse: Any = "auto",
               metrics: Any = None, checkpoint: Any = None,
               save_every: int | None = None,
               resume: bool = False) -> tuple[Any, dict[str, Any]]:
    """Run ``step`` over ``batches``; returns ``(state, summary)``.

    ``batches``: a :class:`~fluxmpi_tpu_torch.DistributedDataLoader`
    (re-iterated per epoch; wrapped in
    :func:`~fluxmpi_tpu_torch.scan_batches` when the step scans) or any
    iterable of ready batches. ``steps``: total optimizer updates (whole
    dispatches, rounded up to the scan width); ``epochs``: passes over
    ``batches`` (default 1 when ``steps`` is None; with both, whichever
    budget is met first). ``scan_steps``: updates per dispatch, default
    read from the step. ``in_flight``: dispatched steps allowed to be
    outstanding on the device (0 waits for every step). ``flush_every``:
    updates between flushes, the only places the loop reads a loss.

    ``checkpoint``: a :class:`~fluxmpi_tpu_torch.utils.CheckpointManager`.
    Each save banks the state with the loop's counters (``updates``,
    ``examples``, ``epochs``; the epoch count includes the current pass
    when the loader's cursor sits at its end) and the loader's position and
    batch geometry, so a restart continues from that exact dispatch
    boundary. ``save_every``: save every N updates, at dispatch boundaries
    (needs ``checkpoint``). ``resume=True``: restore the newest committed
    step first (its tensors are copied into ``state`` in place; an empty
    directory starts fresh, so the same command restarts a run);
    ``steps``/``epochs`` are total budgets, so a run resumed at update 60
    with ``steps=100`` runs 40 more. The resume reads the step's manifest
    once: a checkpoint from another topology (worker count, mesh, global
    batch) restores into the step's layout, the loader remaps its cursor
    through the global sample offset (sample-exact under a batch-major
    order), a remapped cursor inside a scan group re-seats at the group
    boundary, and ``train.resumes{topology_changed="true"}`` counts it
    beside ``train.resumes``.

    Preemption: the flag of :func:`~fluxmpi_tpu_torch.runtime.
    request_preemption` (set by SIGTERM once
    :func:`~fluxmpi_tpu_torch.runtime.install_preemption_handlers` ran) is
    polled at dispatch boundaries; in a world of several workers it is
    agreed at flush boundaries (one all-reduce), so every worker stops at
    the same update. The loop then drains, flushes, banks an emergency
    checkpoint (with ``checkpoint``) and returns with
    ``summary["preempted"]`` True.

    Live resize: with the resize plane armed (``init(resize=)``) and a
    ``checkpoint`` attached, each flush boundary polls the coordinator (in
    a world of several workers one host max-reduce of the requested
    target, so a request on any worker stops every one at the same
    update); an agreed request (site ``resize.drain``) drains, banks a
    final checkpoint (timed, the wait for an in-flight async save
    included), writes the handoff stamp beside the steps and returns with
    ``summary["resized_to"]``; a SIGTERM with a target requested is a
    resize. A ``resume=True`` that finds a stamp is the reshard phase
    (site ``resize.reshard``): the restore is timed and the
    ``fluxmpi_tpu.resize/v1`` record completed and banked.

    The summary has ``updates``, ``epochs``, ``examples``, ``seconds``,
    ``updates_per_sec``, ``examples_per_sec``, the final ``loss``,
    ``preempted``, ``resized_to``, ``resumed_from``, ``anomaly``,
    ``dispatches`` and ``fused_window`` (the JAX package's keys;
    ``anomaly`` names the rule whose ``"halt"`` policy stopped the run),
    ``goodput`` (the tracker's report) when the goodput plane is on, and
    ``flushes``: for each flush its ``updates``, ``loss`` (the
    newest update's), ``loss_mean`` (the interval's losses summed in update
    order in f32, over their count: the JAX package's window mean, the same
    bits on both paths), ``loss_max`` and ``seconds_per_update`` over the
    interval; and ``step_ms``: for each dispatch after the first (a window
    on the fused path), the time from the previous dispatch's completion to
    its own, read from CUDA events on the device's timeline (host clock on
    the CPU) without a per-step synchronization.

    ``fuse``: ``"auto"`` (default) engages one-program flush windows when
    the loader's device-gather path is active (array-backed, without
    ``transform=``, what the worker stages within
    ``FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES``) and the epoch divides into
    ``flush_every``-update windows (``flush_every`` clamped to the epoch):
    each window's gathers and updates run as one program (on the card a
    CUDA graph: the first window of each width runs eagerly, the later ones
    replay it), one dispatch per window. In a world of several workers
    (one per card) each worker's window holds the step's collectives (the
    gradient all-reduce, the batch axes' statistics) and every card
    replays its graph in lockstep; it runs the default ``style="auto"``
    step with no plan or under any plan (the fsdp gathers, the bucketed
    gradient sums over subgroups, the tensor-parallel all-reduces, the MoE
    layers' all-to-alls, the ring's point-to-point exchanges, Ulysses'
    all-to-alls and a pipeline's ticks with their exchanges inside the
    graph; a ``style="shard_map"`` step declines under a named reason)
    over device collectives (host staging, ``disable_device_collectives``,
    stages only the eager collectives, outside the graph), and the workers agree on
    one width before the first window (one host exchange), so a window any
    worker cannot fuse runs pipelined on every worker. ``"window"`` forces
    it (raises on every worker, naming the failing condition and, across
    workers, the worker); ``False``/``None`` keeps the pipelined path. Under the fused path every window boundary is a flush
    boundary (metrics, saves and preemption move to window granularity), a
    ``scan_steps`` step is subsumed (the window sequences single updates),
    and a ``steps`` budget rounds up to whole windows, so ``"auto"`` keeps
    the pipelined path when ``steps`` is not a multiple of the window, or
    when a ``scan_steps`` step meets an epoch or budget its scan would
    have rounded. A resume whose cursor lands inside a window runs one
    shorter first window, and the windows are aligned from then on. The
    summary then has ``fused_window`` (the width), ``dispatches`` (one per
    window) and ``window_cache`` (the window program cache's hits and
    misses in this run). On the card a replay reruns the captured device
    work and no Python: the step's host-side state (in ``loss_fn``: a
    Python counter or schedule, numpy or Python randomness, a CPU
    generator, a CUDA generator other than the default one) changes only
    in the eager first window and at the capture, and its capture-time
    values are fixed in the graph; reading a device value on the host
    raises at the capture. Such a step needs ``fuse=False``, which keeps
    eager semantics (on the CPU a window runs eagerly either way).

    ``metrics``: the spec of :func:`~fluxmpi_tpu_torch.parallel.
    make_train_step` (``True``, a registry, a monitor or a callable; by
    default the one the step was built with). The loop drives the step's
    uninstrumented core and records at each flush, from the interval's
    wall time (no per-update wait): ``train.step_seconds`` (per update),
    ``train.loss`` and ``train.grad_norm`` (the newest update's),
    ``train.examples_per_sec``, ``train.steps`` and ``train.examples``;
    on the fused path also ``train.window.size`` and
    ``train.window.dispatches``; ``train.resumes`` after a resume. A
    monitor observes the interval's time per update; a hook gets the
    record (with ``loss_window_mean`` / ``loss_window_max`` when fused).
    With the goodput plane on, the run's wall time lands in its buckets:
    ``compile`` (the first dispatch; on the fused path each window
    program's CUDA-graph capture and instantiation, while every window's
    updates, the eager first one's included, are steps), ``step``,
    ``data_stall``, ``resume``, ``checkpoint_*`` and
    ``preemption_drain``; its ``goodput.*`` gauges are recorded at every
    flush.

    The run-health and live-export planes (each resolved once per run,
    off by default): the anomaly detector (``init(anomaly=)``) judges each
    flush's loss, gradient norm, time per update, loader wait, retraces and
    per-layer stats; an event whose policy is ``"halt"`` stops the run at
    that flush, after the drain, without banking the suspect state, and
    ``summary["anomaly"]`` names its rule. The compile monitor
    (``init(compileplane=)``) attributes the window programs' captures to
    ``train_loop.window``; on the fused path its warmup boundary is the
    first flush whose window ran a built program (on the card a program's
    first window runs eagerly and its second captures), so a capture after
    it is a ``steady_state_retrace``. The model-stats plane
    (``init(model_stats=)``, built into the step by ``make_train_step``)
    emits the ``model.*`` gauges from the stats the flush copies to the
    host. The exporter (``init(export=)``) gets the run's ``/status``
    boards at the start, at every flush and at the end; with the fleet
    plane armed (``init(fleet=)``) also this process's attribution
    ingredients.
    """
    if in_flight < 0:
        raise ValueError(f"in_flight must be >= 0, got {in_flight}")
    if flush_every < 1:
        raise ValueError(f"flush_every must be >= 1, got {flush_every}")
    if steps is not None and steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if save_every is not None and save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    if save_every is not None and checkpoint is None:
        raise ValueError("save_every requires a checkpoint= manager")
    if resume and checkpoint is None:
        raise ValueError("resume=True requires a checkpoint= manager")
    layout = getattr(step, "__fluxmpi_layout__", None)
    if checkpoint is not None and layout is not None and layout.shards:
        untagged = _untagged_block(state, layout)
        if untagged is not None:
            raise ValueError(
                f"train_loop(checkpoint=) under a layout that shards "
                f"{untagged!r}: a tensor of the state for that parameter (the "
                f"parameter or an optimizer moment) carries no layout tag, so "
                f"a sharded save would record its block as the whole leaf — "
                f"place the state with plan.shard_state/shard_tree, or build "
                f"the moments from the placed parameters")
    if fuse not in ("auto", "window", False, None):
        raise ValueError(f'fuse must be "auto", "window", False, or None; '
                         f"got {fuse!r}")
    if steps is None and epochs is None:
        epochs = 1
    k = scan_steps if scan_steps is not None else getattr(step, "scan_steps", 1)
    if k < 1:
        raise ValueError(f"scan_steps must be >= 1, got {k}")

    # An instrumented step waits per call: the loop drives its core and
    # honours its spec at flush boundaries instead.
    hot = getattr(step, "__fluxmpi_compiled__", step)
    if metrics is None:
        metrics = getattr(step, "__fluxmpi_metrics__", None)
    record_metrics = metrics is not None and metrics is not False
    reg = monitor = hook = None
    if record_metrics:
        reg, monitor, hook = _resolve_metrics(metrics)
    # The goodput plane, resolved once per run: off, the hot loop below
    # branches on one local bool.
    gp = _goodput.get_goodput_tracker()
    gp_on = gp.enabled
    if gp_on:
        # One tracker window per run, anchored before the resume.
        gp.reset_run()
        gp.start_run()
    # The run-health, device and live-export planes, resolved once per run
    # (off, each is one module attribute read here and a local bool below).
    detector = _anomaly.get_anomaly_detector()
    det_on = detector is not None and detector.enabled
    cp = _compileplane.get_compile_monitor()
    cp_on = cp is not None and cp.enabled
    exporter = _export.get_exporter()
    exp_on = exporter is not None and exporter.enabled
    # The model stats are built into the step (make_train_step(
    # model_stats=)); the loop consumes them at flushes when the plane is
    # installed and the step carries them.
    ms = _modelstats.get_model_stats()
    ms_meta = getattr(hot, "__fluxmpi_model_stats_meta__", None)
    ms_on = ms is not None and ms.enabled and ms_meta is not None
    # The fleet plane rides the exporter: no exporter, nothing to scrape.
    fl_on = exp_on and _fleet.enabled()
    # The live-resize plane: polled at flush boundaries while armed and a
    # checkpoint manager is attached (nothing to hand off otherwise).
    rz = _resize.get_resize_coordinator()
    rz_on = rz.enabled and checkpoint is not None
    resize_to: int | None = None
    if det_on:
        # The anomaly-triggered auto-profiler budgets captures per run.
        from ..utils.profiling import get_auto_profiler

        auto_profiler = get_auto_profiler()
        if auto_profiler is not None:
            auto_profiler.reset()
    halt_rule: str | None = None

    fused_w = 0
    workers = runtime.process_count() if runtime.is_initialized() else 1
    if fuse not in (False, None):
        forced = fuse == "window"
        fused_w = _agreed_window_width(
            *_fused_window_width(step, batches, flush_every, steps, k, forced, workers),
            forced, workers)
    orig_k = k
    if fused_w:
        # The window sequences single updates itself: the step's scan tag
        # is bypassed, and budgets and cursors count batches.
        k = 1
    if cp_on:
        # Retrace attribution: the pipelined step is an eager callable (no
        # jit cache, untracked), the fused windows' captures are noted as
        # train_loop.window's builds. One run window per train_loop: a
        # second loop's first builds are its own warmup.
        cp.track("train_loop.step", hot)
        if fused_w:
            cp.track_aot("train_loop.window")
        cp.reset_run()
    is_loader = isinstance(batches, DistributedDataLoader)
    per_epoch = _epoch_len(batches, k)
    window: deque = deque()
    flushes: list[dict[str, Any]] = []
    updates = examples = dispatches = epochs_done = 0
    interval_updates = interval_examples = interval_windows = 0
    last_out = None
    t_start = t_flush = time.perf_counter()
    # Several workers agree on a preemption at flush boundaries, and only
    # when it can matter (a checkpoint to bank, or a handler on any worker).
    multi = workers > 1
    coordinate = multi and (checkpoint is not None or bool(int(allreduce(
        torch.tensor(int(runtime.preemption_handlers_installed())), op="max",
        mesh=WORLD))))

    def payload(st: Any, pass_counted: bool = False,
                legacy_loader: bool = False) -> dict[str, Any]:
        # The JAX package's payload: the state, the cumulative counters and
        # the loader's (epoch, cursor) with its geometry, ints as int64.
        # The epoch count is canonical: it includes the current pass when
        # the cursor sits at its end. In-loop saves come before the loop's
        # own pass increment (pass_counted=False); the post-drain emergency
        # save after it.
        epochs_banked = epochs_done
        loader_state = batches.state_dict() if is_loader else None
        if (loader_state is not None and not pass_counted and len(batches) > 0
                and loader_state["cursor"] >= len(batches)):
            epochs_banked += 1
        if (loader_state is not None and pass_counted and k > 1 and per_epoch
                and loader_state["cursor"] < len(batches)
                and loader_state["cursor"] // k >= per_epoch):
            # Ragged-scan boundary at a post-drain save: every dispatchable
            # scan group of this pass ran and the pass is counted; bank the
            # next epoch's start so a resume neither replays the empty
            # remainder nor counts the pass twice.
            loader_state = {**loader_state, "epoch": loader_state["epoch"] + 1,
                            "cursor": 0}
        out: dict[str, Any] = {
            "state": st,
            "loop": {name: torch.tensor(val, dtype=torch.int64) for name, val in
                     (("updates", updates), ("examples", examples),
                      ("epochs", epochs_banked))},
        }
        if loader_state is not None:
            if not legacy_loader:
                # The batch geometry the cursor's meaning depends on, so a
                # resume under another geometry can remap it (legacy: the
                # template of a checkpoint saved before manifests, whose
                # loader section has no geometry).
                loader_state = {**loader_state, **batches.geometry()}
            out["loader"] = {key: torch.tensor(val, dtype=torch.int64)
                             for key, val in loader_state.items()}
        return out

    resumed_from = None
    resume_offset = 0  # dispatches already done in a resumed partial epoch
    if resume:
      # Resume bring-up is restart badput: the whole block lands in the
      # goodput "resume" bucket (the nested checkpoint_restore segment
      # counts once: the outermost wins).
      with gp.segment("resume") if gp_on else contextlib.nullcontext():
        # The manifest, read once and passed through (None: looked, and
        # absent): whether the checkpoint comes from another world, and
        # whether it predates manifests (the legacy payload template).
        manifest = None
        restore_kwargs: dict[str, Any] = {}
        read_manifest = getattr(checkpoint, "read_manifest", None)
        if read_manifest is not None:
            manifest = read_manifest()
            restore_kwargs["manifest"] = manifest
        # A pending handoff stamp makes this resume the reshard phase of a
        # live resize: its fault site fires, the restore is timed.
        ckpt_dir = getattr(checkpoint, "directory", None)
        resize_stamp = (rz.maybe_begin_reshard(ckpt_dir)
                        if rz_on and ckpt_dir is not None else None)
        t_reshard0 = time.perf_counter()
        try:
            ckpt_step, restored = checkpoint.restore(payload(state), **restore_kwargs)
        except FileNotFoundError:
            restored = None  # nothing committed yet: a fresh start
        except _ckpt.MissingLeafError:
            # The reader ignores leaves the template does not ask for, so
            # the full template goes first: a checkpoint whose sidecar was
            # lost still banks the loader's geometry, and the legacy
            # template would drop it and resume a changed geometry at the
            # wrong sample. Only a checkpoint from before manifests lacks
            # those leaves.
            if manifest is not None:
                raise
            ckpt_step, restored = checkpoint.restore(
                payload(state, legacy_loader=True), **restore_kwargs)
        if restored is not None:
            # Tensors are copied in place (the model's parameters are the
            # state's tensors); numbers are taken from the checkpoint.
            saved = dict(named_leaves(restored["state"]))

            def put(path, leaf):
                if not torch.is_tensor(leaf):
                    return saved[path]
                with torch.no_grad():
                    return leaf.copy_(saved[path])

            state = map_with_path(put, state)
            updates = int(restored["loop"]["updates"])
            examples = int(restored["loop"]["examples"])
            epochs_done = int(restored["loop"]["epochs"])
            topology_changed = False
            if manifest is not None:
                topology_changed = _manifest_util.topology_changed(
                    manifest, mesh=getattr(batches, "mesh", None))
                saved_geom = manifest.get("loader") or {}
                if is_loader and saved_geom:
                    geom = batches.geometry()
                    topology_changed = topology_changed or any(
                        key in saved_geom and int(saved_geom[key]) != geom[key]
                        for key in ("process_count", "global_batch_size"))
            if is_loader and "loader" in restored:
                # load_state_dict turns a cursor at the end of an epoch
                # into the next epoch's start (the banked epoch count has
                # that pass); what remains is the dispatches already done.
                batches.load_state_dict({key: int(val) for key, val
                                         in restored["loader"].items()})
                if fused_w and fuse == "auto" and steps is not None:
                    # The windows after a short realignment window must
                    # land on the steps budget, or "auto" keeps the
                    # pipelined path (the step's own scan quantum again).
                    pos0 = batches.resume_cursor
                    short_first = (fused_w - pos0 % fused_w) % fused_w
                    if (steps - updates - short_first) % fused_w:
                        fused_w = 0
                        k = orig_k
                        per_epoch = _epoch_len(batches, k)
                if k > 1 and batches.resume_cursor % k:
                    # A fused run's save can sit inside a scan group:
                    # re-seat at the group boundary so the groups keep the
                    # uninterrupted run's phase.
                    seat = batches.state_dict()
                    seat["cursor"] = (batches.resume_cursor // k) * k
                    batches.load_state_dict(seat)
                resume_offset = batches.resume_cursor // k
            resumed_from = ckpt_step
            if resize_stamp is not None:
                rz.complete(ckpt_dir, resize_stamp,
                            reshard_seconds=time.perf_counter() - t_reshard0,
                            to_processes=workers)
            if record_metrics:
                registry = _live_registry(reg)
                if registry is not None:
                    # Every resume, and the subset that changed topology.
                    registry.counter("train.resumes").inc()
                    if topology_changed:
                        registry.counter("train.resumes",
                                         topology_changed="true").inc()
    last_saved = updates
    preempted = False
    if exp_on:
        # Run config and resume position, once the resume has settled them.
        exporter.note_status(
            phase="running", updates=updates, examples=examples,
            epochs=epochs_done, steps_budget=steps, epochs_budget=epochs,
            flush_every=flush_every, scan_steps=k, fused_window=fused_w or None,
            resumed_from=resumed_from, preempted=False, anomaly=None)

    step_ms: list[float] = []
    prev: list[_Marker] = []

    def retire(marker: _Marker) -> None:
        marker.wait()
        if prev:
            step_ms.append(marker.ms_since(prev[0]))
            prev[0] = marker
        else:
            prev.append(marker)

    def drain_to_newest() -> None:
        while window:
            retire(window.popleft())

    interval_losses: list[torch.Tensor] = []
    stall_base = gp.bucket_seconds("data_stall") if gp_on else 0.0
    # Whether the newest window ran a built program (the compile plane's
    # fused warmup boundary; the pipelined path's first flush is its).
    window_built = True

    def flush() -> None:
        nonlocal interval_updates, interval_examples, interval_windows, t_flush
        nonlocal stall_base, halt_rule
        if interval_updates == 0:
            return
        if gp_on:
            # The drain is honest device compute: productive goodput.
            with gp.segment("step"):
                drain_to_newest()
        else:
            drain_to_newest()
        grad_norm = None
        stats_host = None
        if fused_w:
            # The window program's f32 metric carry: one read per flush.
            carry = last_out["loss"], last_out["loss_sum"], last_out["loss_max"]
            if "grad_norm" in last_out:
                carry += (last_out["grad_norm"],)
            vals = torch.stack(carry).tolist()
            loss, total, peak = vals[:3]
            if len(vals) > 3:
                grad_norm = vals[3]
            if ms_on and "model_stats" in last_out:
                stats_host = (last_out["model_stats"], last_out.get("noise"))
        else:
            leaves = pytree.tree_leaves(last_out)
            loss = float(torch.as_tensor(leaves[0]).detach().float().mean())
            if len(leaves) > 1:
                grad_norm = float(leaves[1].detach().float().mean())
            if ms_on:
                # The aux is (loss, grad_norm, (table, noise)): the newest
                # update's stats.
                stats_host = last_out[2]
            # The interval's losses, read once and summed in update order
            # in f32, as the window program sums them.
            vals = torch.cat(interval_losses).cpu().numpy()
            total = np.float32(0.0)
            for v in vals:
                total = np.float32(total + v)
            total, peak = float(total), float(vals.max())
        interval_losses.clear()
        now = time.perf_counter()
        elapsed = now - t_flush
        per_update = elapsed / interval_updates
        flushes.append({"updates": updates, "loss": loss,
                        "loss_mean": total / interval_updates, "loss_max": peak,
                        "seconds_per_update": per_update})
        notify_progress(interval_updates)
        if record_metrics:
            record: dict[str, Any] = {
                "step_seconds": per_update,
                "steps": interval_updates,
                "examples": interval_examples,
                "examples_per_sec": (interval_examples / elapsed
                                     if elapsed > 0 else 0.0),
                "loss": loss,
            }
            if grad_norm is not None:
                record["grad_norm"] = grad_norm
            if fused_w:
                record["loss_window_mean"] = total / interval_updates
                record["loss_window_max"] = peak
            registry = _live_registry(reg)
            if registry is not None:
                registry.histogram("train.step_seconds").observe(per_update)
                registry.gauge("train.loss").set(loss)
                if grad_norm is not None:
                    registry.gauge("train.grad_norm").set(grad_norm)
                registry.gauge("train.examples_per_sec").set(
                    record["examples_per_sec"])
                registry.counter("train.steps").inc(interval_updates)
                registry.counter("train.examples").inc(interval_examples)
                if fused_w:
                    # The fused path's host-cost contract: windows
                    # dispatched and the width each one fused.
                    registry.gauge("train.window.size").set(float(fused_w))
                    registry.counter("train.window.dispatches").inc(
                        interval_windows)
            if monitor is not None:
                monitor.observe_step(per_update)
            if hook is not None:
                hook(record)
        fetch_per_update = None
        if gp_on:
            stall = gp.bucket_seconds("data_stall")
            fetch_per_update = (stall - stall_base) / interval_updates
            stall_base = stall
            # goodput.* gauges ride the same flush line as train.*.
            gp.record(_live_registry(reg) if record_metrics else None)
        plane_reg = _live_registry(reg) if record_metrics else None
        retraces = retraced = None
        if cp_on and (cp.steady or window_built):
            # The first observation is the warmup boundary; compile events
            # after it are steady-state retraces, named.
            info = cp.observe_flush(plane_reg, goodput_tracker=gp if gp_on else None)
            if info["steady"] and info["events"]:
                retraces = info["events"]
                retraced = ",".join(info["functions"])
        msum = None
        if ms_on and stats_host is not None:
            msum = ms.observe_flush(
                _modelstats.stats_tree(ms_meta["plans"][0].names, *stats_host),
                step=updates, registry=plane_reg,
                batch_examples=interval_examples / interval_updates,
                workers=ms_meta["workers"])
        if det_on:
            events = detector.observe(
                loss=loss, grad_norm=grad_norm, step_seconds=per_update,
                fetch_seconds=fetch_per_update, retraces=retraces,
                retraced=retraced,
                layer_grad_norms=msum["layers"] if msum else None,
                nonfinite_layer=msum["nonfinite_layer"] if msum else None,
                step=updates)
            for ev in events:
                if ev["action"] == "halt" and halt_rule is None:
                    halt_rule = ev["rule"]
        if exp_on:
            _post_flush(loss, grad_norm, per_update,
                        interval_examples / elapsed if elapsed > 0 else 0.0, msum)
        interval_updates = interval_examples = interval_windows = 0
        t_flush = time.perf_counter()

    def _post_flush(loss, grad_norm, per_update, examples_per_sec, msum) -> None:
        """The flush's numbers on the exporter's ``/status`` boards."""
        exporter.note_status(updates=updates, examples=examples, epochs=epochs_done,
                             loss=loss, grad_norm=grad_norm, step_seconds=per_update,
                             examples_per_sec=examples_per_sec, dispatches=dispatches)
        if fl_on:
            # The FLEET board: cumulative attribution ingredients the
            # collector differences per scrape interval.
            from ..telemetry import get_registry
            from ..telemetry.flight_recorder import get_flight_recorder

            fr = get_flight_recorder()
            comm_total = sum(float(m.get("sum", 0.0)) for m in get_registry().snapshot()
                             if m.get("name") == "comm.block_seconds")
            fields: dict[str, Any] = {
                "updates": updates, "flight_seq": float(fr.sequence),
                "flight_completed": float(fr.completed_count),
                "comm_block_seconds": comm_total}
            if gp_on:
                rep = gp.report()
                fields["wall_seconds"] = rep["wall_seconds"]
                for bucket in ("step", "data_stall", "host_idle"):
                    fields[f"{bucket}_seconds"] = rep["buckets"].get(bucket, 0.0)
            exporter.note_fleet(**fields)
        if msum is not None:
            # The MODEL board: noise scale, top-k layers, NaN provenance.
            exporter.note_model(
                step=updates, noise_scale=msum["noise_scale"],
                nonfinite_layer=msum["nonfinite_layer"],
                top=[{"layer": layer, "grad_norm": g} for layer, g in msum["top"]])

    def save(pass_counted: bool = False) -> None:
        nonlocal last_saved
        checkpoint.save(updates, payload(state, pass_counted))
        last_saved = updates

    def after_dispatch(at_flush: bool = False) -> bool:
        """Flush, check the budget, bank the boundary, then poll the
        preemption flag (its emergency save then has nothing left to
        write). Returns whether the loop stops here."""
        nonlocal preempted, resize_to
        at_flush = at_flush or interval_updates >= flush_every
        # A "halt" anomaly stops the run at the flush that judged it,
        # without banking the suspect state: the last periodic save holds
        # the last known-good boundary.
        if at_flush:
            flush()
        stop = halt_rule is not None or (steps is not None and updates >= steps)
        if (save_every is not None and halt_rule is None
                and updates - last_saved >= save_every):
            save()
        if multi:
            if coordinate and at_flush and bool(int(allreduce(
                    torch.tensor(int(runtime.preemption_requested())), op="max",
                    mesh=WORLD))):
                preempted = stop = True
        elif runtime.preemption_requested():
            preempted = stop = True
        if rz_on and at_flush and resize_to is None:
            # As the preemption poll: every worker reaches this flush at
            # the same update, and a max-reduce of the requested target (0:
            # none) agrees one resize for the world.
            target = rz.requested_target()
            if multi:
                target = int(allreduce(torch.tensor(target), op="max", mesh=WORLD))
            if target:
                resize_to = target
                rz.begin(target, from_processes=workers)
                stop = True
        return stop

    window_cache = {"hits": 0, "misses": 0}
    window_compile_seconds = 0.0
    lbs_fused = batches.local_batch_size if fused_w else 0

    def window_program(width: int, avals: tuple) -> Any:
        """The window program for ``width`` updates, cached on the step
        across train_loop runs, keyed by width, batch size and the state's
        and dataset's shapes and dtypes."""
        cache = getattr(step, "__fluxmpi_window_cache__", None)
        if cache is None:
            cache = step.__fluxmpi_window_cache__ = {}
        key = (width, lbs_fused) + avals
        prog = cache.get(key)
        if prog is None:
            prog = cache[key] = make_window_program(step, width=width, lbs=lbs_fused)
            window_cache["misses"] += 1
        else:
            window_cache["hits"] += 1
        return prog

    done = False
    first_dispatch = True
    try:
      while not done:
        if epochs is not None and epochs_done >= epochs:
            break
        if steps is not None and updates >= steps:
            break  # a resumed run may have met its budget already
        offset, resume_offset = resume_offset, 0
        dispatched_this_epoch = offset
        yielded_this_pass = 0
        exhausted = False
        if fused_w:
            # One-program flush windows: the loader hands over the staged
            # dataset, this epoch's permutation and the resume start; the
            # host then dispatches one program per window.
            if gp_on:
                t0 = gp._clock()
                staged, perm, pos = batches.device_epoch()
                gp.add("data_stall", gp._clock() - t0)
            else:
                staged, perm, pos = batches.device_epoch()
            nb = per_epoch
            avals = (_aval_key(_state_tensors(state)),
                     _aval_key(pytree.tree_leaves(staged)), _aval_key([perm]))
            while pos < nb:
                # A resume cursor inside a window realigns with ONE shorter
                # first window; the flush grid then matches the
                # uninterrupted run's.
                width = fused_w - pos % fused_w if pos % fused_w else fused_w
                program = window_program(width, avals)
                recaptured = program.recaptures
                if gp_on:
                    # Host-side, around the whole call: nothing of this
                    # runs inside a capture. A program's capture and
                    # instantiation are its compile work; every window's
                    # updates, the eager first one's included, are steps
                    # (as the JAX loop books its AOT compile and its
                    # dispatches). Its FLOPs are counted once, on
                    # an eager call (a replay runs no operator the
                    # counter could see), and kept on the program for
                    # later runs.
                    count = gp._flops_per_update is None and program.flops is None
                    t0 = gp._clock()
                    if count:
                        from ..utils.flops import count_flops

                        with count_flops() as counted:
                            state, out = program(state, staged, perm, pos * lbs_fused)
                        program.flops = counted.total or None
                    else:
                        state, out = program(state, staged, perm, pos * lbs_fused)
                    dt = gp._clock() - t0
                    built = min(program.last_compile_seconds, dt)
                    if built > 0:
                        gp.add("compile", built)
                    gp.add("step", dt - built)
                    if gp._flops_per_update is None and program.flops:
                        gp.set_flops_per_update(program.flops / width)
                    gp.note_updates(width)
                else:
                    state, out = program(state, staged, perm, pos * lbs_fused)
                # A cached program that had to capture again (its state's
                # tensors moved) built anew: a miss, not a hit.
                window_cache["misses"] += program.recaptures - recaptured
                if program.last_compile_seconds > 0:
                    # This window captured its program: the run's build
                    # seconds, attributed to train_loop.window.
                    window_compile_seconds += program.last_compile_seconds
                    if cp_on:
                        cp.note_aot_compile("train_loop.window",
                                            program.last_compile_seconds)
                window_built = program.built
                window.append(_Marker(perm.device))
                if len(window) > in_flight:
                    retire(window.popleft())
                last_out = out
                dispatches += 1
                # Watchdog liveness: the fused path never iterates the
                # loader, so it ticks per window instead.
                notify_progress()
                batches.note_consumed(width)
                pos += width
                updates += width
                examples += width * lbs_fused
                interval_updates += width
                interval_examples += width * lbs_fused
                interval_windows += 1
                # Every window boundary is a flush boundary: metrics, the
                # budget, saves and preemption quantize to windows.
                if after_dispatch(at_flush=True):
                    done = True
                    break
            if pos >= nb:
                epochs_done += 1
            continue
        source = _epoch_iter(batches, k)
        if gp_on:
            source = _stall_timed(iter(source), gp)
        for batch in source:
            if gp_on:
                def run():
                    return hot(state, batch)
                if first_dispatch:
                    state, out = _first_dispatch(run, gp, k)
                    window.append(_Marker(_loss_device(out)))
                    if len(window) > in_flight:
                        retire(window.popleft())
                else:
                    with gp.segment("step"):
                        state, out = run()
                        window.append(_Marker(_loss_device(out)))
                        if len(window) > in_flight:
                            retire(window.popleft())
                gp.note_updates(k)
            else:
                state, out = hot(state, batch)
                window.append(_Marker(_loss_device(out)))
                if len(window) > in_flight:
                    retire(window.popleft())
            first_dispatch = False
            last_out = out
            interval_losses.append(
                torch.as_tensor(pytree.tree_leaves(out)[0]).detach().float().reshape(-1))
            n = _batch_examples(batch, k)
            dispatches += 1
            updates += k
            examples += n
            interval_updates += k
            interval_examples += n
            dispatched_this_epoch += 1
            yielded_this_pass += 1
            if after_dispatch():
                done = True
                break
        else:
            exhausted = True
        if exhausted or dispatched_this_epoch == per_epoch:
            epochs_done += 1
        if not done and yielded_this_pass == 0 and offset == 0:
            # (A resumed pass whose remainder was already consumed yields
            # nothing and is not a dry source.)
            if epochs is not None and epochs_done >= epochs:
                break
            raise ValueError(
                "batch source ran dry before the requested budget "
                f"(updates={updates}, steps={steps}, epochs={epochs}); "
                "pass a re-iterable loader for multi-epoch runs"
            )
      if gp_on and window:
        with gp.segment("preemption_drain" if preempted else "step"):
            drain_to_newest()
      else:
        drain_to_newest()
      flush()
    except Exception as exc:
        _maybe_oom_forensics(exc, _live_registry(reg) if record_metrics else None)
        raise
    if resize_to is not None:
        # The drain ended with the flush above.
        rz.note_drained()
    if preempted:
        _tracing.instant("train.preemption", step=int(updates))
    if (preempted and checkpoint is not None and updates > last_saved
            and halt_rule is None and resize_to is None):
        save(pass_counted=True)
    if resize_to is not None:
        # The resize's final save, timed to its commit (the wait for an
        # in-flight async save included), then this world's half of the
        # record beside the checkpoint.
        t_save = time.perf_counter()
        if updates > last_saved and halt_rule is None:
            save(pass_counted=True)
        checkpoint.wait_until_finished()
        rz.note_phase("save", time.perf_counter() - t_save)
        rz.write_handoff(getattr(checkpoint, "directory", "."), step=last_saved,
                         from_processes=workers, to_processes=resize_to)
    if checkpoint is not None:
        checkpoint.wait_until_finished()
    seconds = time.perf_counter() - t_start
    loss = flushes[-1]["loss"] if flushes else None
    summary = {
        "updates": updates,
        "epochs": epochs_done,
        "examples": examples,
        "seconds": seconds,
        "updates_per_sec": updates / seconds if seconds > 0 else 0.0,
        "examples_per_sec": examples / seconds if seconds > 0 else 0.0,
        "loss": loss,
        "preempted": preempted,
        "resized_to": resize_to,
        "resumed_from": resumed_from,
        "anomaly": halt_rule,
        "dispatches": dispatches,
        "fused_window": fused_w or None,
        "flushes": flushes,
        "step_ms": step_ms,
    }
    if fused_w:
        summary["window_compile_seconds"] = window_compile_seconds
        summary["window_cache"] = window_cache
    if gp_on:
        gp.record(_live_registry(reg) if record_metrics else None)
        summary["goodput"] = gp.report()
    if exp_on:
        # Terminal status: /status keeps answering after the loop exits.
        exporter.note_status(
            phase=("resizing" if resize_to is not None
                   else "preempted" if preempted
                   else ("halted" if halt_rule else "finished")),
            updates=updates, examples=examples, epochs=epochs_done, loss=loss,
            preempted=preempted, anomaly=halt_rule, dispatches=dispatches)
    return state, summary
