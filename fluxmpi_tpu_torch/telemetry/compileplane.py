"""Compile/rebuild telemetry: the device plane's silent perf killer
(counterpart of :mod:`fluxmpi_tpu.telemetry.compileplane`: the same
monitor, ``compile.*`` metrics, warmup boundary and retrace attribution).

A step that quietly rebuilds itself — a window program recaptured for a
new width or batch shape, a kernel library recompiled — burns wall clock
while every host-side metric still says "training". PyTorch has no
``jax.monitoring`` and no jit cache, so the port's compile events are its
own builds:

- **a kernel build** — :mod:`fluxmpi_tpu_torch.ops._build` times each
  ``nvcc`` of a ``csrc/*.cu`` source and reports it as a ``compile``
  event (:data:`BUILD_EVENT`);
- **a CUDA-graph capture** — a
  :class:`~fluxmpi_tpu_torch.parallel.train.WindowProgram` reports the
  seconds of each capture and instantiation (:data:`CAPTURE_EVENT`), and
  ``train_loop`` attributes them to ``train_loop.window`` with
  :meth:`CompileMonitor.note_aot_compile` (the path the JAX monitor keeps
  for its AOT-compiled windows, which never grow a jit cache either).

:meth:`CompileMonitor.track` keeps the JAX API: a callable with a
``_cache_size()`` is polled as a jit cache would be, and an eager
callable without one (the serving engine's decode and prefill steps) stays
untracked (``-1``), exactly as the JAX monitor treats a non-jit callable.

The **steady-state retrace** signal combines both: the first
``observe_flush`` marks the warmup boundary (first-dispatch builds are
legitimate); ANY compile event after it is a retrace, reported with the
rebuilt function's name — ``train_loop`` feeds it to the
:class:`~fluxmpi_tpu_torch.telemetry.anomaly.AnomalyDetector`'s
``steady_state_retrace`` rule, which fires an ``anomaly.*`` instant and
(when armed) an automatic profiler capture
(:mod:`fluxmpi_tpu_torch.utils.profiling`). On the card a window
program's first dispatch spans two windows (an eager window, then the
capture), so the fused loop takes its warmup boundary at the first flush
whose window ran a built program.

The monitor also **cross-checks the goodput plane**: compile seconds the
monitor saw beyond the tracker's ``compile`` bucket (a kernel built inside
an eager window, which the tracker books as step) land in the
``compile.unattributed_seconds`` gauge.

Zero-cost-when-off: no monitor installed (the default) means a build or a
capture reads one module attribute, and ``train_loop`` reads one module
attribute per run.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from .registry import MetricsRegistry, get_registry

__all__ = [
    "CompileMonitor",
    "get_compile_monitor",
    "set_compile_monitor",
    "configure",
    "shutdown",
    "COMPILE_PHASES",
    "UNTRACKED",
    "BUILD_EVENT",
    "CAPTURE_EVENT",
    "note_duration",
]

_ENV_VAR = "FLUXMPI_TPU_COMPILEPLANE"

# The port's build events -> the JAX package's phase labels. Both are
# "an executable was built" (the JAX backend_compile phase); the port has
# no trace or lower phase of its own, so those stay at 0.
BUILD_EVENT = "/fluxmpi_tpu_torch/ops/nvcc_build_duration"
CAPTURE_EVENT = "/fluxmpi_tpu_torch/cuda_graph/capture_duration"
COMPILE_PHASES: dict[str, str] = {
    BUILD_EVENT: "compile",
    CAPTURE_EVENT: "compile",
}

# The function label when compile events happened but no tracked
# function's cache grew (an untagged jit, or growth not yet visible).
UNTRACKED = "<untracked>"


class CompileMonitor:
    """Compile-event accounting + per-tagged-function retrace detection.

    Args:
      registry: registry the ``compile.*`` metrics land in at
        :meth:`observe_flush` (default: the process-global one, resolved
        at flush time so a swapped registry is honored).

    Thread discipline: build events fire on whatever thread builds, so
    the event totals live behind a lock; everything else
    (track/observe_flush) is loop-thread only, like the goodput
    tracker.
    """

    def __init__(self, *, registry: MetricsRegistry | None = None):
        self.enabled = True
        self._registry = registry
        self._lock = threading.Lock()
        self._events = 0  # builds and captures completed
        self._seconds: dict[str, float] = {p: 0.0 for p in ("trace", "lower", "compile")}
        self._tracked: dict[str, Any] = {}
        self._cache_sizes: dict[str, int] = {}
        # Programs built ahead of their dispatches have no growing jit
        # cache to poll: attribution comes from explicit
        # note_aot_compile() calls (name -> [compile count, compile
        # seconds, count at last poll, seconds at last flush]). Loop-thread
        # only, like _tracked.
        self._aot: dict[str, list[float]] = {}
        self._steady = False
        # observe_flush delta baselines.
        self._flushed_events = 0
        self._flushed_seconds: dict[str, float] = dict(self._seconds)
        # Compile seconds accumulated before the current run window —
        # the goodput cross-check compares per-run against the
        # tracker's per-run compile bucket.
        self._run_base_seconds = 0.0
        self.retraces: list[dict[str, Any]] = []

    def reset_run(self) -> None:
        """Open a new run window (``train_loop`` calls this at start,
        next to the goodput tracker's ``reset_run``): warmup re-opens —
        a NEW loop's first-dispatch compiles are legitimate, not
        steady-state retraces of the previous run — the per-run retrace
        log clears, and the goodput cross-check re-bases on the current
        totals (the tracker's compile bucket is per-run too). The
        cumulative event/seconds totals and flush baselines survive:
        the ``compile.*`` counters stay monotonic across runs."""
        self._steady = False
        self.retraces = []
        with self._lock:
            self._run_base_seconds = sum(self._seconds.values())

    # -- listener side (any thread) ------------------------------------

    def _note_duration(self, event: str, seconds: float) -> None:
        phase = COMPILE_PHASES.get(event)
        if phase is None or not self.enabled:
            return
        with self._lock:
            self._seconds[phase] += float(seconds)
            if phase == "compile":
                self._events += 1

    # -- loop side -----------------------------------------------------

    @staticmethod
    def _cache_size(fn: Any) -> int:
        """A jit function's cache entry count; -1 when the callable does
        not expose one (attribution degrades to ``<untracked>``)."""
        size = getattr(fn, "_cache_size", None)
        if callable(size):
            try:
                return int(size())
            except Exception:
                return -1
        return -1

    def track(self, name: str, fn: Any) -> None:
        """Register a compiled callable for retrace attribution under
        ``name`` (its current cache size becomes the baseline)."""
        self._tracked[name] = fn
        self._cache_sizes[name] = self._cache_size(fn)

    def track_aot(self, name: str) -> None:
        """Register a program built ahead of its dispatches under
        ``name`` (the port's CUDA-graph window programs). Such programs
        never grow a jit cache, so attribution counts explicit
        :meth:`note_aot_compile` calls instead of cache polls — the path
        that lets ``compile.function_seconds{<name>}`` appear and
        steady-state retrace detection cover fused-window programs."""
        self._aot.setdefault(name, [0, 0.0, 0, 0.0])

    def note_aot_compile(self, name: str, seconds: float = 0.0) -> None:
        """Record one build of the tracked program ``name`` (``seconds`` =
        caller-measured wall time of the build: a window program's
        CUDA-graph capture and instantiation). After the warmup boundary this
        counts as a retrace of ``name`` at the next flush, exactly like
        jit-cache growth does for live-jit functions."""
        entry = self._aot.setdefault(name, [0, 0.0, 0, 0.0])
        entry[0] += 1
        entry[1] += float(seconds)

    def mark_steady(self) -> None:
        """Declare warmup over: any compile event from here on is a
        steady-state retrace. ``observe_flush`` does this implicitly
        after its first call (the train_loop warmup boundary)."""
        self._steady = True

    @property
    def steady(self) -> bool:
        return self._steady

    @property
    def events(self) -> int:
        """Total builds and captures observed."""
        with self._lock:
            return self._events

    def compile_seconds(self, phase: str | None = None) -> float:
        """Cumulative observed compile seconds — one phase (``trace`` /
        ``lower`` / ``compile``) or, with None, all phases summed."""
        with self._lock:
            if phase is not None:
                return self._seconds.get(phase, 0.0)
            return sum(self._seconds.values())

    def _growers(self) -> dict[str, int]:
        """Tracked functions whose jit caches grew since the last poll,
        mapped to HOW MANY entries they grew by (the per-function
        retrace count for the interval). AOT-tracked programs count
        their explicit :meth:`note_aot_compile` calls the same way."""
        grown: dict[str, int] = {}
        for name, fn in self._tracked.items():
            size = self._cache_size(fn)
            base = self._cache_sizes.get(name, -1)
            if size > base >= 0:
                grown[name] = size - base
            self._cache_sizes[name] = size
        for name, entry in self._aot.items():
            if entry[0] > entry[2]:
                grown[name] = int(entry[0] - entry[2])
            entry[2] = entry[0]
        return grown

    def observe_flush(
        self,
        registry: MetricsRegistry | None = None,
        *,
        goodput_tracker: Any = None,
    ) -> dict[str, Any]:
        """One flush boundary's compile accounting. Computes the deltas
        since the previous call, attributes them to the tracked
        functions whose jit caches grew, writes the ``compile.*``
        metrics, and returns::

            {"steady": <was steady-state BEFORE this call>,
             "events": <backend compiles this interval>,
             "seconds": <total compile-phase seconds this interval>,
             "functions": [<grown tracked fn names, or "<untracked>">]}

        The FIRST call marks the warmup boundary (``steady`` False in
        its return, True from then on) — first-dispatch compiles are
        legitimate; everything later is a retrace ``train_loop`` hands
        to the anomaly detector. With ``goodput_tracker`` given (and
        carrying a ``compile`` bucket), the gauge
        ``compile.unattributed_seconds`` records cumulative compile
        seconds the monitor saw beyond what the tracker booked as compile —
        compile time hiding inside productive step wall time.
        """
        with self._lock:
            events = self._events
            seconds = dict(self._seconds)
        delta_events = events - self._flushed_events
        delta_seconds = {
            p: seconds[p] - self._flushed_seconds.get(p, 0.0) for p in seconds
        }
        self._flushed_events = events
        self._flushed_seconds = seconds
        delta_total = sum(delta_seconds.values())
        growers = self._growers()
        # AOT compile-seconds deltas advance with the flush baselines
        # above (registry-enabled or not), so a disabled interval never
        # re-reports its seconds later.
        aot_seconds: dict[str, float] = {}
        for name, entry in self._aot.items():
            d = entry[1] - entry[3]
            entry[3] = entry[1]
            if d > 0:
                aot_seconds[name] = d
        functions = list(growers)
        if delta_events and not functions:
            functions = [UNTRACKED]
        was_steady = self._steady
        self._steady = True
        reg = registry
        if reg is None:
            reg = self._registry if self._registry is not None else get_registry()
        if getattr(reg, "enabled", True):
            if delta_events:
                reg.counter("compile.events").inc(delta_events)
            for phase, dur in delta_seconds.items():
                if dur > 0:
                    reg.counter("compile.seconds", phase=phase).inc(dur)
            if delta_events:
                share = delta_total / len(functions)
                for name in functions:
                    reg.counter(
                        "compile.function_seconds", function=name
                    ).inc(share)
                    if was_steady:
                        # Count every retrace, not one per flush: a
                        # storm of 50 recompiles in one interval must
                        # read as 50 (per-function count = the jit-cache
                        # growth; untracked growth = the event delta).
                        reg.counter("compile.retraces", function=name).inc(
                            growers.get(name, delta_events)
                        )
            for name, entry in self._aot.items():
                aot_delta = growers.get(name, 0)
                if aot_delta:
                    reg.counter(
                        "compile.aot_programs", function=name
                    ).inc(aot_delta)
                if aot_seconds.get(name, 0.0) > 0:
                    reg.counter(
                        "compile.aot_seconds", function=name
                    ).inc(aot_seconds[name])
            if goodput_tracker is not None and getattr(
                goodput_tracker, "enabled", False
            ):
                # Per-run comparison: the tracker's compile bucket was
                # reset at run start, so subtract only the compile
                # seconds observed SINCE then — pre-run compiles (model
                # init, a previous loop) are not hidden step time.
                booked = goodput_tracker.bucket_seconds("compile")
                run_seconds = sum(seconds.values()) - self._run_base_seconds
                reg.gauge("compile.unattributed_seconds").set(
                    max(0.0, run_seconds - booked)
                )
        info = {
            "steady": was_steady,
            "events": delta_events,
            "seconds": delta_total,
            "functions": functions if delta_events else [],
        }
        if was_steady and delta_events:
            self.retraces.append(info)
        return info


# ---------------------------------------------------------------------------
# Module singleton. Build sites report through note_duration, which reads
# the singleton once: with no monitor installed that is the whole cost.
# ---------------------------------------------------------------------------

_active: CompileMonitor | None = None
_active_lock = threading.Lock()


def note_duration(event: str, seconds: float) -> None:
    """Report one build event (:data:`BUILD_EVENT`, :data:`CAPTURE_EVENT`)
    of ``seconds`` to the installed monitor; a no-op when none is."""
    mon = _active
    if mon is not None:
        mon._note_duration(event, seconds)


def get_compile_monitor() -> CompileMonitor | None:
    """The installed compile monitor, if any (None = plane off)."""
    return _active


def set_compile_monitor(
    monitor: CompileMonitor | None,
) -> CompileMonitor | None:
    """Install (or, with None, remove) the process compile monitor;
    returns the previous one."""
    global _active
    with _active_lock:
        prev, _active = _active, monitor
    return prev


def configure(spec: Any = None) -> CompileMonitor | None:
    """Wire the compile plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_COMPILEPLANE`` (same forms; no-op
      when unset/empty);
    - ``False`` / ``"0"`` — uninstall;
    - ``True`` / ``"1"`` — install a default :class:`CompileMonitor`;
    - a :class:`CompileMonitor` — install it.

    Called by ``fluxmpi_tpu_torch.init(compileplane=...)``; idempotent — an
    installed monitor keeps its totals/baselines on a replay.
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _active
    if isinstance(spec, CompileMonitor):
        spec.enabled = True
        set_compile_monitor(spec)
        return spec
    if spec is False or spec == "0":
        set_compile_monitor(None)
        return None
    if spec is True or spec == "1":
        if _active is not None:
            _active.enabled = True
            return _active
        mon = CompileMonitor()
        set_compile_monitor(mon)
        return mon
    raise ValueError(
        f"compileplane spec must be a bool, '0'/'1', or a CompileMonitor; "
        f"got {spec!r}"
    )


def shutdown() -> None:
    """Uninstall the monitor — compile totals and the steady-state mark
    must never leak into the next init cycle (the fault-plane leak
    rule)."""
    set_compile_monitor(None)
