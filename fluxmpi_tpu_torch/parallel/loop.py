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

Fault tolerance: with a :class:`~fluxmpi_tpu_torch.utils.CheckpointManager`
as ``checkpoint=``, the loop banks its state, counters and loader position
every ``save_every`` updates, resumes from the newest committed step with
``resume=True``, and on preemption (:func:`~fluxmpi_tpu_torch.runtime.
request_preemption`, or SIGTERM with the handler installed) drains, banks
an emergency checkpoint and returns.

Not ported yet (each raises ``NotImplementedError`` when asked for):
``fuse="window"`` (one-program flush windows; ``"auto"`` takes the
pipelined path) and ``metrics=``; the anomaly, goodput, resize and export
planes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterable

import torch
from torch.utils import _pytree as pytree

from .. import runtime
from ..comm import allreduce
from ..data import DistributedDataLoader, scan_batches
from ..utils.manifest import map_with_path, named_leaves

__all__ = ["train_loop"]


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
    with ``steps=100`` runs 40 more.

    Preemption: the flag of :func:`~fluxmpi_tpu_torch.runtime.
    request_preemption` (set by SIGTERM once
    :func:`~fluxmpi_tpu_torch.runtime.install_preemption_handlers` ran) is
    polled at dispatch boundaries; in a world of several workers it is
    agreed at flush boundaries (one all-reduce), so every worker stops at
    the same update. The loop then drains, flushes, banks an emergency
    checkpoint (with ``checkpoint``) and returns with
    ``summary["preempted"]`` True.

    The summary has ``updates``, ``epochs``, ``examples``, ``seconds``,
    ``updates_per_sec``, ``examples_per_sec``, the final ``loss``,
    ``preempted``, ``resized_to``, ``resumed_from``, ``anomaly``,
    ``dispatches`` and ``fused_window`` (the JAX package's keys; the
    planes behind ``resized_to``, ``anomaly`` and ``fused_window`` are not
    ported and report None), and ``flushes``: for each flush its
    ``updates``, ``loss`` (the newest update's), ``loss_mean`` (the mean
    over the interval's updates, the JAX package's window mean) and
    ``seconds_per_update`` over the interval; and ``step_ms``: for each
    dispatch after the first, the time from the previous dispatch's
    completion to its own, read from CUDA events on the device's timeline
    (host clock on the CPU) without a per-step synchronization.
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
    if fuse not in ("auto", "window", False, None):
        raise ValueError(f'fuse must be "auto", "window", False, or None; '
                         f"got {fuse!r}")
    if fuse == "window":
        raise NotImplementedError(
            'fuse="window" (one-program flush windows) is not ported yet; '
            '"auto" takes the pipelined path')
    if metrics is not None and metrics is not False:
        raise NotImplementedError("train_loop(metrics=...) is not ported yet")
    if steps is None and epochs is None:
        epochs = 1
    k = scan_steps if scan_steps is not None else getattr(step, "scan_steps", 1)
    if k < 1:
        raise ValueError(f"scan_steps must be >= 1, got {k}")

    is_loader = isinstance(batches, DistributedDataLoader)
    per_epoch = _epoch_len(batches, k)
    window: deque = deque()
    flushes: list[dict[str, Any]] = []
    updates = examples = dispatches = epochs_done = 0
    interval_updates = 0
    last_out = None
    t_start = t_flush = time.perf_counter()
    # Several workers agree on a preemption at flush boundaries, and only
    # when it can matter (a checkpoint to bank, or a handler on any worker).
    multi = runtime.is_initialized() and runtime.process_count() > 1
    coordinate = multi and (checkpoint is not None or bool(int(allreduce(
        torch.tensor(int(runtime.preemption_handlers_installed())), op="max"))))

    def payload(st: Any, pass_counted: bool = False) -> dict[str, Any]:
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
            out["loader"] = {key: torch.tensor(val, dtype=torch.int64) for key, val
                             in {**loader_state, **batches.geometry()}.items()}
        return out

    resumed_from = None
    resume_offset = 0  # dispatches already done in a resumed partial epoch
    if resume:
        try:
            ckpt_step, restored = checkpoint.restore(payload(state))
        except FileNotFoundError:
            restored = None  # nothing committed yet: a fresh start
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
            if is_loader and "loader" in restored:
                # load_state_dict turns a cursor at the end of an epoch
                # into the next epoch's start (the banked epoch count has
                # that pass); what remains is the dispatches already done.
                batches.load_state_dict({key: int(val) for key, val
                                         in restored["loader"].items()})
                resume_offset = batches.resume_cursor // k
            resumed_from = ckpt_step
    last_saved = updates
    preempted = False

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

    def flush() -> None:
        nonlocal interval_updates, t_flush
        if interval_updates == 0:
            return
        drain_to_newest()
        loss = float(torch.as_tensor(pytree.tree_leaves(last_out)[0])
                     .detach().float().mean())
        # The interval's mean loss, summed on the device: one read per flush.
        mean = float(torch.cat(interval_losses).mean())
        interval_losses.clear()
        now = time.perf_counter()
        flushes.append({"updates": updates, "loss": loss, "loss_mean": mean,
                        "seconds_per_update": (now - t_flush) / interval_updates})
        interval_updates = 0
        t_flush = now

    def save(pass_counted: bool = False) -> None:
        nonlocal last_saved
        checkpoint.save(updates, payload(state, pass_counted))
        last_saved = updates

    def after_dispatch() -> bool:
        """Flush, check the budget, bank the boundary, then poll the
        preemption flag (its emergency save then has nothing left to
        write). Returns whether the loop stops here."""
        nonlocal preempted
        at_flush = interval_updates >= flush_every
        if at_flush:
            flush()
        stop = steps is not None and updates >= steps
        if save_every is not None and updates - last_saved >= save_every:
            save()
        if multi:
            if coordinate and at_flush and bool(int(allreduce(
                    torch.tensor(int(runtime.preemption_requested())), op="max"))):
                preempted = stop = True
        elif runtime.preemption_requested():
            preempted = stop = True
        return stop

    done = False
    while not done:
        if epochs is not None and epochs_done >= epochs:
            break
        if steps is not None and updates >= steps:
            break  # a resumed run may have met its budget already
        offset, resume_offset = resume_offset, 0
        dispatched_this_epoch = offset
        yielded_this_pass = 0
        exhausted = False
        for batch in _epoch_iter(batches, k):
            state, out = step(state, batch)
            window.append(_Marker(_loss_device(out)))
            if len(window) > in_flight:
                retire(window.popleft())
            last_out = out
            interval_losses.append(
                torch.as_tensor(pytree.tree_leaves(out)[0]).detach().float().reshape(-1))
            dispatches += 1
            updates += k
            examples += _batch_examples(batch, k)
            interval_updates += k
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
    drain_to_newest()
    flush()
    if preempted and checkpoint is not None and updates > last_saved:
        save(pass_counted=True)
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
        "resized_to": None,
        "resumed_from": resumed_from,
        "anomaly": None,
        "dispatches": dispatches,
        "fused_window": None,
        "flushes": flushes,
        "step_ms": step_ms,
    }
    return state, summary
