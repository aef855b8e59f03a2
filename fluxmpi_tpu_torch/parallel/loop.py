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

Not ported yet (each raises ``NotImplementedError`` when asked for):
``fuse="window"`` (one-program flush windows; ``"auto"`` takes the
pipelined path), ``metrics=``, ``checkpoint=``, ``save_every=`` and
``resume=``; preemption, anomaly, goodput and export planes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterable

import torch
from torch.utils import _pytree as pytree

from ..data import DistributedDataLoader, scan_batches

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

    The summary has ``updates``, ``epochs``, ``examples``, ``seconds``,
    ``updates_per_sec``, ``examples_per_sec``, the final ``loss``,
    ``preempted``, ``resized_to``, ``resumed_from``, ``anomaly``,
    ``dispatches`` and ``fused_window`` (the JAX package's keys; the
    planes behind the last few are not ported and report False/None), and
    ``flushes``: for each flush its ``updates``, ``loss`` (the newest
    update's), ``loss_mean`` (the mean over the interval's updates, the JAX
    package's window mean) and ``seconds_per_update`` over the interval;
    and ``step_ms``: for each
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
    if fuse not in ("auto", "window", False, None):
        raise ValueError(f'fuse must be "auto", "window", False, or None; '
                         f"got {fuse!r}")
    if fuse == "window":
        raise NotImplementedError(
            'fuse="window" (one-program flush windows) is not ported yet; '
            '"auto" takes the pipelined path')
    for name, val in (("metrics", metrics), ("checkpoint", checkpoint),
                      ("save_every", save_every), ("resume", resume)):
        if val is not None and val is not False:
            raise NotImplementedError(f"train_loop({name}=...) is not ported yet")
    if steps is None and epochs is None:
        epochs = 1
    k = scan_steps if scan_steps is not None else getattr(step, "scan_steps", 1)
    if k < 1:
        raise ValueError(f"scan_steps must be >= 1, got {k}")

    per_epoch = _epoch_len(batches, k)
    window: deque = deque()
    flushes: list[dict[str, Any]] = []
    updates = examples = dispatches = epochs_done = 0
    interval_updates = 0
    last_out = None
    t_start = t_flush = time.perf_counter()

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

    done = False
    while not done:
        if epochs is not None and epochs_done >= epochs:
            break
        if steps is not None and updates >= steps:
            break
        dispatched_this_epoch = 0
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
            if interval_updates >= flush_every:
                flush()
            if steps is not None and updates >= steps:
                done = True
                break
        else:
            exhausted = True
        if exhausted or dispatched_this_epoch == per_epoch:
            epochs_done += 1
        if not done and dispatched_this_epoch == 0:
            if epochs is not None and epochs_done >= epochs:
                break
            raise ValueError(
                "batch source ran dry before the requested budget "
                f"(updates={updates}, steps={steps}, epochs={epochs}); "
                "pass a re-iterable loader for multi-epoch runs"
            )
    drain_to_newest()
    flush()
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
        "preempted": False,
        "resized_to": None,
        "resumed_from": None,
        "anomaly": None,
        "dispatches": dispatches,
        "fused_window": None,
        "flushes": flushes,
        "step_ms": step_ms,
    }
    return state, summary
