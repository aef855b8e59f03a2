"""Profiling and timing helpers (counterpart of
:mod:`fluxmpi_tpu.utils.profiling`).

:func:`profile_trace` captures a ``torch.profiler`` trace of a block
(host and CUDA activity) as a Chrome trace, viewable in Perfetto or
``chrome://tracing``; :func:`step_timer` gives honest step timings around
asynchronous launches: PyTorch launches a step's kernels and returns, so a
host clock read right after the call measures the launch, not the work,
and the timer stops its clock only after the outputs are complete on the
card (the ``MPI.Waitall!`` of timing); :func:`block_on` waits for a tree
of tensors.

:class:`AutoProfiler` turns the capture into a *triggered* instrument:
armed via ``FLUXMPI_TPU_PROFILE_DIR`` (or ``init(profile=...)``), it
captures one bounded-duration profiler window when the anomaly detector
fires a ``step_time_regression`` or ``steady_state_retrace`` (see
:mod:`fluxmpi_tpu_torch.telemetry.anomaly`) or on ``SIGUSR2``, so the
evidence for a live perf regression is on disk before a human opens a
terminal. Captures are rate-limited (default: once per run), and a
capture never starts or stops while a CUDA graph is being captured: the
window programs' captures and the profiler's start and stop take
:data:`capture_lock` in turn.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import warnings
from typing import Any, Iterator

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "profile_trace",
    "step_timer",
    "block_on",
    "AutoProfiler",
    "get_auto_profiler",
    "set_auto_profiler",
    "maybe_auto_capture",
    "configure_auto_profiler",
    "shutdown_auto_profiler",
]

_ENV_PROFILE_DIR = "FLUXMPI_TPU_PROFILE_DIR"
_ENV_PROFILE_SECONDS = "FLUXMPI_TPU_PROFILE_SECONDS"
_ENV_PROFILE_LIMIT = "FLUXMPI_TPU_PROFILE_LIMIT"

# Held across a CUDA-graph capture (parallel.train.WindowProgram) and
# across a profiler's start and stop: a profiler session never starts or
# stops inside a capture, whose stream must see no foreign work.
capture_lock = threading.Lock()


def _process() -> tuple[int, int]:
    """(index, count) of this process in the runtime's world (0, 1 before
    ``init``)."""
    from .. import runtime

    if runtime.is_initialized():
        return runtime.process_index(), runtime.process_count()
    return 0, 1


def _per_process_dir(logdir: str) -> str:
    """Each process's private capture directory under a shared logdir:
    ``<logdir>/proc<k>`` in a world of several processes (their trace
    files would otherwise collide on the shared path), the plain logdir
    when single-process."""
    index, count = _process()
    if count > 1:
        return os.path.join(logdir, f"proc{index}")
    return logdir


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _new_profiler() -> Any:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _export(prof: Any, logdir: str) -> str:
    """Write ``prof``'s Chrome trace into ``logdir`` under a timestamped
    name (repeated captures coexist); returns the file's path."""
    os.makedirs(logdir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{time.time_ns() % 1_000_000_000:09d}"
    path = os.path.join(logdir, f"fluxmpi_profile.{stamp}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile_trace(
    logdir: str, *, all_hosts: bool = False, host_only: bool | None = None
) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and CUDA activity) of the
    enclosed block into ``logdir``, as a Chrome trace
    (``fluxmpi_profile.<time>.pt.trace.json``).

    By default only the lead process traces — device activity is
    mirrored across data-parallel replicas, so one process's trace is
    usually the whole picture. Pass ``all_hosts=True`` to trace on every
    process (straggler hunts); each process then writes into its own
    ``<logdir>/proc<k>`` subdirectory, so one shared logdir works.
    ``host_only`` is the JAX package's deprecated spelling of this switch
    (``all_hosts = host_only``, with a ``DeprecationWarning``).

    Refuses (``RuntimeError``) to start inside a CUDA-graph capture. The
    profiler is stopped and its trace written when the block raises too,
    so no profiler is left running. For the always-on, in-process span
    timeline, see :mod:`fluxmpi_tpu_torch.telemetry.tracing`.
    """
    if host_only is not None:
        warnings.warn(
            "profile_trace(host_only=...) is deprecated: the flag's old "
            "behavior contradicted its documentation (host_only=True "
            "traced on EVERY process). Behavior is preserved; spell it "
            "all_hosts=True to trace on every process, or omit the flag "
            "to trace on the lead process only.",
            DeprecationWarning,
            stacklevel=3,
        )
        all_hosts = bool(host_only)
    if not all_hosts and _process()[0] != 0:
        yield
        return
    if _capturing():
        raise RuntimeError("profile_trace cannot start inside a CUDA-graph capture")
    prof = _new_profiler()
    with capture_lock:
        prof.start()
    try:
        yield
    finally:
        with capture_lock:
            prof.stop()
        _export(prof, _per_process_dir(logdir) if all_hosts else logdir)


class AutoProfiler:
    """Anomaly/signal-triggered ``torch.profiler`` capture with a per-run
    budget.

    Args:
      logdir: capture destination; every process writes into its own
        ``<logdir>/proc<k>`` subdirectory in a world of several processes
        (the :func:`profile_trace` collision contract). Each capture is
        its own timestamped Chrome trace file, so repeated captures
        coexist.
      seconds: bounded capture window. The capture runs on a daemon
        thread — the profiler starts now and stops after the window — so
        the training loop keeps running *inside* the captured window
        (that running work IS the evidence).
      limit: automatic captures allowed per run (default 1 — a
        regressing run re-triggers at every flush; the first capture is
        the evidence, the rest would be overhead). ``SIGUSR2`` /
        ``force=True`` captures bypass the budget (a human asked), but
        never overlap a live capture.

    The profiler's start and stop each wait for a CUDA-graph capture in
    progress to end (:data:`capture_lock`), and a window program's
    capture waits for them, so a capture never sees the profiler
    switching on or off.
    """

    def __init__(
        self,
        logdir: str,
        *,
        seconds: float = 3.0,
        limit: int = 1,
    ):
        if seconds <= 0:
            raise ValueError(f"seconds must be > 0, got {seconds}")
        if limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        self.logdir = logdir
        self.seconds = float(seconds)
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._captures = 0
        self._auto_captures = 0
        self._capturing = False
        self._thread: threading.Thread | None = None
        self._prev_sigusr2: Any = None
        self.last_capture_path: str | None = None
        self.last_trace_file: str | None = None
        self.last_reason: str | None = None

    @property
    def captures(self) -> int:
        """Captures started so far (auto + forced)."""
        return self._captures

    def reset(self) -> None:
        """Restore the automatic-capture budget (``train_loop`` calls
        this per run). Only the budget re-opens — :attr:`captures`
        stays a monotonic total of every window started."""
        with self._lock:
            self._auto_captures = 0

    def maybe_capture(self, reason: str, *, force: bool = False) -> str | None:
        """Start one bounded capture if the budget allows (``force``
        bypasses the budget, not the no-overlap rule). Returns the
        capture directory, or None when skipped. Non-blocking: the
        window closes on a daemon thread; :meth:`wait` joins it."""
        with self._lock:
            if self._capturing:
                return None
            if not force:
                # Only automatic triggers spend the budget — an early
                # SIGUSR2 must not eat the one capture a later anomaly
                # exists to write.
                if self._auto_captures >= self.limit:
                    return None
                self._auto_captures += 1
            self._captures += 1
            self._capturing = True
        logdir = _per_process_dir(self.logdir)
        thread = threading.Thread(
            target=self._capture,
            args=(logdir, not force),
            name="fluxmpi-autoprofile",
            daemon=True,
        )
        self.last_capture_path = logdir
        self.last_reason = reason
        self._thread = thread
        thread.start()
        return logdir

    def _capture(self, logdir: str, auto: bool) -> None:
        started = False
        prof = None
        try:
            prof = _new_profiler()
            with capture_lock:
                prof.start()
            started = True
            # Announce only an OPEN window — a premature success line
            # would send an operator to an empty directory when the
            # session failed to start.
            print(
                f"fluxmpi_tpu_torch auto-profiler: capturing {self.seconds:g}s "
                f"profiler window into {logdir} "
                f"(reason: {self.last_reason})",
                file=sys.stderr,
            )
            time.sleep(self.seconds)
        except Exception:  # the profiler must never kill the run
            pass
        finally:
            # Stop ONLY a session this thread started: if the start
            # failed because another profiler session is live (a user's
            # profile_trace), stopping would end THEIR capture.
            if started:
                try:
                    with capture_lock:
                        prof.stop()
                    self.last_trace_file = _export(prof, logdir)
                except Exception:
                    pass
            with self._lock:
                self._capturing = False
                if not started:
                    # Refund: a capture that never opened wrote nothing
                    # — the budget must stay available for the next
                    # trigger instead of ending the run evidence-less.
                    self._captures = max(0, self._captures - 1)
                    if auto:
                        self._auto_captures = max(
                            0, self._auto_captures - 1
                        )
            if not started:
                print(
                    f"fluxmpi_tpu_torch auto-profiler: capture into {logdir} "
                    f"failed to start (another profiler session live?); "
                    f"budget refunded",
                    file=sys.stderr,
                )

    def wait(self, timeout: float | None = None) -> None:
        """Join the in-flight capture window, if any (tests; shutdown)."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout)

    # -- SIGUSR2 dump-on-demand (the watchdog's SIGUSR1 discipline) ----

    def _on_sigusr2(self, signum: int, frame: Any) -> None:
        # Signal handlers run between bytecodes on the main thread; the
        # handler only spawns the capture thread and returns.
        threading.Thread(
            target=self.maybe_capture,
            args=("signal",),
            kwargs={"force": True},
            daemon=True,
        ).start()

    def install_signal(self) -> None:
        """Install the SIGUSR2 capture-on-demand handler (main thread
        only; degrades silently elsewhere — the triggered path still
        works, only dump-on-demand is lost)."""
        import signal

        try:
            self._prev_sigusr2 = signal.signal(
                signal.SIGUSR2, self._on_sigusr2
            )
        except (ValueError, OSError, AttributeError):
            self._prev_sigusr2 = None

    def uninstall_signal(self) -> None:
        import signal

        if self._prev_sigusr2 is not None:
            try:
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
            except (ValueError, OSError):
                pass
            self._prev_sigusr2 = None


_auto: AutoProfiler | None = None


def get_auto_profiler() -> AutoProfiler | None:
    """The armed auto-profiler, if any (None = triggered capture off)."""
    return _auto


def set_auto_profiler(profiler: AutoProfiler | None) -> AutoProfiler | None:
    """Install (or, with None, remove) the process auto-profiler;
    returns the previous one. Signal handlers are the caller's business
    (``configure_auto_profiler`` installs them)."""
    global _auto
    prev, _auto = _auto, profiler
    return prev


def maybe_auto_capture(reason: str) -> str | None:
    """Trigger the armed auto-profiler (no-op returning None when none
    is armed) — what the anomaly detector calls on
    ``step_time_regression`` / ``steady_state_retrace``."""
    ap = _auto
    if ap is None:
        return None
    return ap.maybe_capture(reason)


def configure_auto_profiler(spec: Any = None) -> AutoProfiler | None:
    """Wire triggered profiling from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_PROFILE_DIR`` (no-op when
      unset/empty); window seconds and the per-run capture limit come
      from ``FLUXMPI_TPU_PROFILE_SECONDS`` (default 3) and
      ``FLUXMPI_TPU_PROFILE_LIMIT`` (default 1);
    - ``False`` / ``"0"`` — disarm (restores SIGUSR2);
    - a path string — arm an :class:`AutoProfiler` at that logdir;
    - an :class:`AutoProfiler` — arm it.

    Arming installs the ``SIGUSR2`` capture-on-demand handler. Called by
    ``fluxmpi_tpu_torch.init(profile=...)``; idempotent — a replay with the
    same logdir/window keeps the armed instance AND its spent capture
    budget (``init()`` replays must not grant a fresh budget)."""
    if spec is None:
        spec = os.environ.get(_ENV_PROFILE_DIR)
        if spec is None or spec == "":
            return _auto
    if spec is False or spec == "0":
        shutdown_auto_profiler()
        return None
    if isinstance(spec, AutoProfiler):
        if spec is _auto:
            return spec
        shutdown_auto_profiler()
        set_auto_profiler(spec)
        spec.install_signal()
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"profile spec must be a logdir path, False/'0', or an "
            f"AutoProfiler; got {spec!r}"
        )
    seconds = float(os.environ.get(_ENV_PROFILE_SECONDS) or 3.0)
    limit = int(os.environ.get(_ENV_PROFILE_LIMIT) or 1)
    if (
        _auto is not None
        and _auto.logdir == spec
        and _auto.seconds == seconds
        and _auto.limit == limit
    ):
        return _auto  # idempotent init() replay
    shutdown_auto_profiler()
    ap = AutoProfiler(spec, seconds=seconds, limit=limit)
    set_auto_profiler(ap)
    ap.install_signal()
    return ap


def shutdown_auto_profiler() -> None:
    """Disarm the auto-profiler: wait out any live capture window,
    restore SIGUSR2, and forget the instance (capture budgets must not
    leak across init cycles — the fault-plane leak rule)."""
    global _auto
    ap = _auto
    if ap is None:
        return
    ap.wait(timeout=ap.seconds + 60.0)
    ap.uninstall_signal()
    _auto = None


# The JAX package's step_timer enqueues a cached jitted sentinel
# (``_bump_fn``) per device and blocks on it when nothing is watched. The
# port has no counterpart: ``torch.cuda.synchronize`` drains the device
# directly.


def _cuda_devices(tree: Any) -> set[torch.device]:
    return {leaf.device for leaf in pytree.tree_leaves(tree)
            if torch.is_tensor(leaf) and leaf.is_cuda}


class _TimerHandle:
    def __init__(self) -> None:
        self._watched: list[Any] = []

    def watch(self, tree: Any) -> Any:
        """Register outputs to wait for before the clock stops (returns the
        tree for inline use: ``out = t.watch(step(...))``)."""
        self._watched.append(tree)
        return tree


@contextlib.contextmanager
def step_timer(
    result_holder: dict,
    key: str = "seconds",
    *,
    metric: str | None = None,
    registry: Any | None = None,
) -> Iterator[_TimerHandle]:
    """Time the enclosed block including the device work it launched.

    Register the block's outputs with ``handle.watch(out)``: the timer
    waits until the devices they live on have finished every kernel
    launched so far (which includes the outputs) before it stops the
    clock. With nothing watched it waits for the current CUDA device,
    if CUDA is in use. The elapsed seconds land in
    ``result_holder[key]``.

    ``metric="train.step_seconds"`` additionally observes the elapsed
    time into a telemetry histogram of that name (on ``registry``, or the
    default :func:`fluxmpi_tpu_torch.telemetry.get_registry` when
    omitted)."""
    handle = _TimerHandle()
    t0 = time.perf_counter()
    yield handle
    if handle._watched:
        devices = _cuda_devices(handle._watched)
    elif torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    else:
        devices = set()
    for dev in devices:
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    result_holder[key] = elapsed
    if metric is not None:
        if registry is None:
            from ..telemetry import get_registry

            registry = get_registry()
        registry.histogram(metric).observe(elapsed)


def block_on(tree: Any) -> Any:
    """Wait until every CUDA tensor in ``tree`` is computed (the timing
    analogue of ``MPI.Waitall!``). Returns the tree."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree
