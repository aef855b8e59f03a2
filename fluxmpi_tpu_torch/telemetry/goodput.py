"""Goodput / badput accounting: where a run's wall-clock actually goes
(counterpart of :mod:`fluxmpi_tpu.telemetry.goodput`, the same buckets,
gauges and report).

Goodput is the fraction of wall-clock spent making training progress.
Every robustness feature *adds* non-productive wall time — checkpoint
saves, preemption drains, resumes — and this plane accounts for it.

:class:`GoodputTracker` attributes wall-clock into named buckets via a
``with tracker.segment("checkpoint_save"): ...`` context API:

==================== =====================================================
bucket               attributed to
==================== =====================================================
``step``             productive dispatch + draining the step's results
``compile``          the first dispatch of the step (cuBLAS, allocator and
                     kernel warm-up; on the fused path the eager first
                     window and the CUDA-graph capture)
``data_stall``       host blocked waiting on the loader for the next batch
``checkpoint_save``  :func:`~fluxmpi_tpu_torch.utils.save_checkpoint` (sync path)
``checkpoint_restore`` :func:`~fluxmpi_tpu_torch.utils.restore_checkpoint`
``resume``           ``train_loop(resume=True)`` bring-up — manifest read,
                     restore, cursor re-seat (restart badput)
``preemption_drain`` draining the in-flight window after a preemption
``host_idle``        COMPUTED remainder (wall − Σ measured): host dispatch
                     overhead between segments — never measured directly
==================== =====================================================

Goodput fraction = ``step / wall``. **Live MFU** comes from
:mod:`fluxmpi_tpu_torch.utils.flops`: the tracker is told FLOPs per
optimizer update once (``set_flops_per_update``, counted at the first
dispatch by :func:`~fluxmpi_tpu_torch.utils.flops.count_flops`) and
counts updates; ``report()`` derives

- ``mfu`` — over TOTAL wall (the production number badput drags down);
- ``mfu_productive`` — over productive ``step`` seconds only.

The peak is the card's, looked up by ``torch.cuda.get_device_name`` in
:data:`~fluxmpi_tpu_torch.utils.flops.PEAK_FLOPS`.

Cost discipline (the zero-cost-when-off contract): while
``enabled`` is False — the default — :meth:`segment` returns a shared
no-op and performs **no clock reads and no registry lookups**;
``train_loop`` reads ``enabled`` once per run and skips even the no-op
on its hot path. Segments are recorded by ONE driver thread (the first
to record); other threads' segments are ignored — a background async
checkpoint save overlaps training and is exactly the badput the async
path exists to avoid, so counting it would double-book the wall clock.
Off-driver work that still wants visibility reports through
:meth:`GoodputTracker.note_background` instead: a separate thread-safe
ledger (``report()['background']``, ``goodput.background_seconds``
gauges) outside the wall-clock buckets — the async checkpoint writer
books its real write cost there, so *driver* ``checkpoint_save`` ≈
snapshot cost is an assertable contract.
Nested segments count once (outermost wins), so wrapping a restore in a
``resume`` segment never double-counts the inner ``checkpoint_restore``.

Recording to the metrics plane (``goodput.*`` gauges, a closed schema
namespace) happens at :meth:`record` — ``train_loop`` calls it at flush
boundaries — and ``scripts/goodput_report.py`` turns the per-host
JSONL streams into a per-run breakdown.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from .registry import MetricsRegistry, get_registry

__all__ = [
    "GoodputTracker",
    "get_goodput_tracker",
    "set_goodput_tracker",
    "segment",
    "configure",
    "shutdown",
    "PRODUCTIVE_BUCKET",
    "MEASURED_BUCKETS",
    "IDLE_BUCKET",
]

_ENV_VAR = "FLUXMPI_TPU_GOODPUT"

PRODUCTIVE_BUCKET = "step"
IDLE_BUCKET = "host_idle"
MEASURED_BUCKETS = (
    "step",
    "compile",
    "data_stall",
    "checkpoint_save",
    "checkpoint_restore",
    "resume",
    "preemption_drain",
)


class _NoopSegment:
    """Shared, stateless no-op — the disabled (and off-thread) path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSegment":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP_SEGMENT = _NoopSegment()


class _Segment:
    """One live segment: accumulates its wall time into the tracker's
    bucket on exit. Only the OUTERMOST segment on the driver thread
    records (depth-guarded) so nested attributions never double-count."""

    __slots__ = ("_tracker", "name", "_t0", "_outer")

    def __init__(self, tracker: "GoodputTracker", name: str):
        self._tracker = tracker
        self.name = name

    def __enter__(self) -> "_Segment":
        tr = self._tracker
        self._outer = tr._depth == 0
        tr._depth += 1
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        tr = self._tracker
        t1 = tr._clock()
        tr._depth -= 1
        if self._outer:
            tr._add(self.name, t1 - self._t0)


class GoodputTracker:
    """Wall-clock bucket accounting + live MFU for one training run.

    Args:
      registry: default registry :meth:`record` writes ``goodput.*``
        gauges into (default: the process-global one).
      clock: monotonic seconds source (injectable — tests assert bucket
        math with a fake clock and zero real sleeps, the watchdog
        discipline).
      peak_flops_per_chip: override the
        :func:`~fluxmpi_tpu_torch.utils.flops.chip_peak_flops` device-name
        lookup (tests; cards not in the table). None = look up the
        card's name (``torch.cuda.get_device_name``) lazily at
        :meth:`report` time.
      n_chips: override the device count used in the MFU denominator
        (default: the world size at report time).
      enabled: start recording immediately. The module default tracker
        starts DISABLED — enable via ``init(goodput=True)`` /
        ``FLUXMPI_TPU_GOODPUT=1`` / :func:`configure`.
    """

    def __init__(
        self,
        *,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
        peak_flops_per_chip: float | None = None,
        n_chips: int | None = None,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self._registry = registry
        self._clock = clock
        self.peak_flops_per_chip = peak_flops_per_chip
        self.n_chips = n_chips
        self.reset_run()

    # -- run lifecycle -------------------------------------------------

    def reset_run(self) -> None:
        """Drop all buckets/counters and forget the run start — the next
        segment (or :meth:`start_run`) begins a fresh wall-clock window."""
        self._t0: float | None = None
        self._buckets: dict[str, float] = {}
        self._background: dict[str, float] = {}
        self._background_lock = threading.Lock()
        self._updates = 0
        self._flops_per_update: float | None = None
        self._depth = 0
        self._thread: int | None = None

    def start_run(self) -> None:
        """Anchor the wall-clock window now (idempotent). Segments do
        this implicitly; call it first so time before the first segment
        (e.g. a resume restore) is inside the window."""
        if self._t0 is None:
            self._t0 = self._clock()
            self._thread = threading.get_ident()

    # -- recording -----------------------------------------------------

    def segment(self, name: str) -> Any:
        """Context manager attributing the enclosed wall time to bucket
        ``name``. No-op (shared singleton, no clock read) while disabled
        or on any thread other than the run's driver thread."""
        if not self.enabled:
            return _NOOP_SEGMENT
        if self._t0 is None:
            self.start_run()
        elif self._thread != threading.get_ident():
            # A second thread (async checkpoint writer, prefetcher)
            # overlaps the driver's wall clock; booking its time would
            # make buckets sum past the wall. Overlapped work is not
            # host badput — ignore it.
            return _NOOP_SEGMENT
        return _Segment(self, name)

    def _add(self, name: str, seconds: float) -> None:
        self._buckets[name] = self._buckets.get(name, 0.0) + seconds

    def add(self, name: str, seconds: float) -> None:
        """Directly attribute ``seconds`` to bucket ``name`` (the
        pre-timed spelling ``train_loop`` uses for the data-stall wait).
        Same thread/enabled discipline as :meth:`segment`."""
        if not self.enabled:
            return
        if self._t0 is None:
            self.start_run()
        elif self._thread != threading.get_ident():
            return
        self._add(name, seconds)

    def note_background(self, name: str, seconds: float) -> None:
        """Attribute ``seconds`` of OFF-driver work to the background
        ledger ``name`` (async checkpoint writer, prefetcher). Background
        time overlaps the driver's wall clock, so it is kept out of the
        badput buckets — ``report()['buckets']`` still sums to the wall —
        but it is the number that proves the async path moved the cost
        off the driver: driver-thread ``checkpoint_save`` ≈ snapshot,
        ``background['checkpoint_async_write']`` ≈ the real write.
        Thread-safe (it exists for non-driver threads)."""
        if not self.enabled:
            return
        with self._background_lock:
            self._background[name] = (
                self._background.get(name, 0.0) + seconds
            )

    def note_updates(self, n: int) -> None:
        """Count ``n`` completed optimizer updates (the MFU numerator's
        step count). One int add."""
        self._updates += n

    def set_flops_per_update(self, flops: float | None) -> None:
        """FLOPs per optimizer update (from
        :func:`~fluxmpi_tpu_torch.utils.flops.count_flops` over a dispatch,
        divided by the updates it ran). None/0 leaves MFU unreported."""
        self._flops_per_update = float(flops) if flops else None

    # -- derived numbers -----------------------------------------------

    @property
    def updates(self) -> int:
        return self._updates

    def bucket_seconds(self, name: str) -> float:
        """Cumulative measured seconds in one bucket (0.0 if untouched)."""
        return self._buckets.get(name, 0.0)

    def wall_seconds(self) -> float:
        """Wall-clock seconds since the run anchor (0.0 before it)."""
        if self._t0 is None:
            return 0.0
        return max(0.0, self._clock() - self._t0)

    def _mfu_pair(self, wall: float) -> tuple[float | None, float | None]:
        from ..utils.flops import chip_peak_flops, mfu

        if not self._flops_per_update or not self._updates:
            return None, None
        peak = self.peak_flops_per_chip
        n_dev = self.n_chips
        kind = None
        if peak is None or n_dev is None:
            try:
                import torch

                from .. import runtime

                if n_dev is None:
                    n_dev = (
                        runtime.device_count()
                        if runtime.is_initialized()
                        else 1
                    )
                if peak is None:
                    if not torch.cuda.is_available():
                        return None, None
                    dev = (
                        runtime.worker_device()
                        if runtime.is_initialized()
                        else torch.device("cuda", 0)
                    )
                    if dev.type != "cuda":
                        return None, None
                    kind = torch.cuda.get_device_name(dev)
            except Exception:
                return None, None
        total = (
            mfu(
                self._flops_per_update,
                self._updates / wall,
                n_dev,
                kind,
                peak=peak,
            )
            if wall > 0
            else None
        )
        step_s = self.bucket_seconds(PRODUCTIVE_BUCKET)
        productive = (
            mfu(
                self._flops_per_update,
                self._updates / step_s,
                n_dev,
                kind,
                peak=peak,
            )
            if step_s > 0
            else None
        )
        return total, productive

    def report(self) -> dict[str, Any]:
        """Plain-python run summary: ``wall_seconds``, ``buckets``
        (measured + the computed ``host_idle`` remainder — the buckets
        sum to the wall by construction), ``goodput_fraction``
        (productive ``step`` seconds / wall), ``updates``, ``mfu``
        (over wall) and ``mfu_productive`` (over step seconds) — None
        when FLOPs or peak are unknown."""
        wall = self.wall_seconds()
        buckets = dict(self._buckets)
        measured = sum(buckets.values())
        buckets[IDLE_BUCKET] = max(0.0, wall - measured)
        fraction = (
            buckets.get(PRODUCTIVE_BUCKET, 0.0) / wall if wall > 0 else 0.0
        )
        total_mfu, productive_mfu = self._mfu_pair(wall)
        with self._background_lock:
            background = dict(self._background)
        return {
            "wall_seconds": wall,
            "buckets": buckets,
            "background": background,
            "goodput_fraction": fraction,
            "updates": self._updates,
            "flops_per_update": self._flops_per_update,
            "mfu": total_mfu,
            "mfu_productive": productive_mfu,
        }

    def record(self, registry: MetricsRegistry | None = None) -> None:
        """Write the current :meth:`report` into the metrics plane as
        ``goodput.*`` gauges (cumulative-seconds gauges per bucket;
        fraction/MFU/updates as point-in-time values). ``train_loop``
        calls this at flush boundaries so the JSONL stream carries the
        run-health numbers alongside ``train.*``."""
        reg = registry
        if reg is None:
            reg = self._registry if self._registry is not None else get_registry()
        if not getattr(reg, "enabled", True):
            return
        rep = self.report()
        for name, seconds in rep["buckets"].items():
            reg.gauge("goodput.bucket_seconds", bucket=name).set(seconds)
        for name, seconds in rep["background"].items():
            reg.gauge("goodput.background_seconds", bucket=name).set(seconds)
        reg.gauge("goodput.wall_seconds").set(rep["wall_seconds"])
        reg.gauge("goodput.fraction").set(rep["goodput_fraction"])
        reg.gauge("goodput.updates").set(float(rep["updates"]))
        if rep["mfu"] is not None:
            reg.gauge("goodput.mfu").set(rep["mfu"])
        if rep["mfu_productive"] is not None:
            reg.gauge("goodput.mfu_productive").set(rep["mfu_productive"])


# ---------------------------------------------------------------------------
# Default tracker + module-level wiring (init kwarg / env var) — the same
# shape as tracing/watchdog: a process-global instance, configure() from a
# one-value spec, shutdown() so state never leaks across init cycles.
# ---------------------------------------------------------------------------

_default = GoodputTracker(enabled=False)
_default_lock = threading.Lock()


def get_goodput_tracker() -> GoodputTracker:
    """The process-global goodput tracker (disabled until configured)."""
    return _default


def set_goodput_tracker(tracker: GoodputTracker) -> GoodputTracker:
    """Swap the default tracker (returns the previous one)."""
    global _default
    with _default_lock:
        prev, _default = _default, tracker
    return prev


def segment(name: str) -> Any:
    """``with goodput.segment("checkpoint_save"): ...`` on the default
    tracker — what the checkpoint layer calls; one attribute read and a
    shared no-op when the plane is off."""
    return _default.segment(name)


def configure(spec: Any = None) -> GoodputTracker:
    """Wire the goodput plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_GOODPUT`` (same forms; no-op when
      unset/empty);
    - ``False`` / ``"0"`` — disable the default tracker;
    - ``True`` / ``"1"`` — enable it;
    - a :class:`GoodputTracker` — install it as the default (enabled).

    Called by ``fluxmpi_tpu_torch.init(goodput=...)``; idempotent.
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _default
    if isinstance(spec, GoodputTracker):
        spec.enabled = True
        set_goodput_tracker(spec)
        return spec
    if spec is False or spec == "0":
        _default.enabled = False
        return _default
    if spec is True or spec == "1":
        _default.enabled = True
        return _default
    raise ValueError(
        f"goodput spec must be a bool, '0'/'1', or a GoodputTracker; "
        f"got {spec!r}"
    )


def shutdown() -> None:
    """Disable the default tracker and drop its run state — a goodput
    window left armed across an init/shutdown cycle would book the gap
    between runs as badput nobody asked about (the fault-plane leak
    rule)."""
    _default.enabled = False
    _default.reset_run()
