"""Near-zero-cost span tracing into a bounded per-process ring buffer
(counterpart of :mod:`fluxmpi_tpu.telemetry.tracing`: the same timeline
and the same Chrome-trace export, so ``scripts/merge_traces.py`` merges
the port's per-rank files unchanged).

The second observability plane: where the metrics registry answers "how
much / how fast on average", spans answer "what was this process doing,
when" — per-host timelines of train steps, data-loader fetches, and
eager collective launches, exportable as Chrome-trace/Perfetto JSON
(:meth:`Tracer.export`, merged across hosts by
``scripts/merge_traces.py``). The shape is PyTorch's Kineto/NCCL-trace
split rendered in-process: a deque ring holds the last ``capacity``
events, so a dump after a hang shows the recent past without unbounded
memory.

Cost discipline (the <2% budget from PR 1 applies to this plane too):

- **disabled** (default): :func:`span` returns a reusable no-op context
  manager — one attribute read and one function call per call site;
  :func:`add_complete_event` / :func:`instant` return after one ``if``.
- **enabled**: one ``deque.append`` of a tuple per event (lock-free under
  the GIL, same contract as the metrics instruments) plus two
  ``perf_counter_ns`` reads per span. No locks on the hot path; export
  snapshots the deque with ``list()``.

Timestamps: durations come from ``perf_counter_ns`` (monotonic);
export rebases them onto the wall clock through a (unix, perf) anchor
pair taken at tracer creation, so per-host traces merge onto one
cross-host timeline keyed by NTP-disciplined wall time.

The open-span stack is tracked per thread (plain list append/pop) so the
watchdog can report *where inside the step* each thread was when a hang
dump fires — the Python-level analogue of the thread stacks it also
captures.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Iterator

from .registry import process_index_or_zero as _process_index
from .schema import TRACE_SCHEMA

__all__ = [
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "add_complete_event",
    "name_track",
    "trace_enabled",
    "configure",
    "shutdown",
    "reset",
]

_ENV_VAR = "FLUXMPI_TPU_TRACE"
_DEFAULT_CAPACITY = 65536


class _NoopSpan:
    """Reusable, reentrant no-op context manager — the disabled-tracing
    fast path. Stateless, so one shared instance serves every call site
    and nesting depth."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: records a Chrome-trace "X" (complete) event on exit
    and sits on its thread's open-span stack while active."""

    __slots__ = ("_tracer", "name", "args", "_start_ns", "_stack")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._stack = self._tracer._open_stack()
        self._start_ns = time.perf_counter_ns()
        self._stack.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        end_ns = time.perf_counter_ns()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits (generators)
            stack.remove(self)
        self._tracer._events.append(
            ("X", self.name, self._start_ns, end_ns - self._start_ns,
             threading.get_ident(), self.args)
        )


class Tracer:
    """Bounded ring of trace events with Chrome-trace export.

    Events live as tuples ``(ph, name, start_ns, dur_ns, tid, args)`` in
    a ``deque(maxlen=capacity)`` — appending is the entire hot-path cost,
    and the oldest events fall off the back, flight-recorder style.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._events: deque = deque(maxlen=capacity)
        # thread id -> list of live _Span objects (the open-span stack).
        self._open: dict[int, list] = {}
        # Virtual-track labels (``track=`` events): export renders a
        # named lane instead of looking the id up as a thread — how the
        # serving plane gives every request its own Perfetto track.
        self._track_names: dict[int, str] = {}
        # Wall-clock anchor: export rebases monotonic perf_counter stamps
        # onto unix time so per-host traces align on one timeline.
        self._anchor_unix = time.time()
        self._anchor_perf_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------

    def _open_stack(self) -> list:
        stack = self._open.get(threading.get_ident())
        if stack is None:
            stack = self._open.setdefault(threading.get_ident(), [])
        return stack

    def span(self, name: str, **args: Any) -> Any:
        """Context manager timing the enclosed block as one "X" event.
        No-op (shared singleton, nothing recorded) while disabled."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args or None)

    def instant(
        self, name: str, *, track: int | None = None, **args: Any
    ) -> None:
        """Record a zero-duration marker ("i" event). ``track`` puts the
        event on a virtual lane (see :meth:`name_track`) instead of the
        calling thread's."""
        if not self.enabled:
            return
        self._events.append(
            ("i", name, time.perf_counter_ns(), 0,
             int(track) if track is not None else threading.get_ident(),
             args or None)
        )

    def add_complete_event(
        self, name: str, t0: float, t1: float,
        *, track: int | None = None, **args: Any
    ) -> None:
        """Record an already-timed interval (``time.perf_counter()``
        seconds, the clock the comm/data instrumentation already reads)
        as an "X" event — one deque append, no context-manager overhead.
        ``track`` puts the span on a virtual lane (see
        :meth:`name_track`) instead of the calling thread's."""
        if not self.enabled:
            return
        start_ns = int(t0 * 1e9)
        self._events.append(
            ("X", name, start_ns, max(0, int((t1 - t0) * 1e9)),
             int(track) if track is not None else threading.get_ident(),
             args or None)
        )

    def name_track(self, track: int, name: str) -> None:
        """Label a virtual track (a ``track=`` id that is not a real
        thread): export emits ``thread_name`` metadata so Perfetto shows
        the label — e.g. ``request 7`` — instead of a raw id."""
        if not self.enabled:
            return
        self._track_names[int(track)] = str(name)

    # -- inspection / export -------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def open_spans(self) -> list[dict[str, Any]]:
        """Snapshot of every thread's open-span stack, outermost first —
        what the watchdog folds into a hang dump."""
        out = []
        for tid, stack in list(self._open.items()):
            names = [s.name for s in list(stack)]
            if names:
                out.append({"thread_id": tid, "spans": names})
        return out

    def _ts_us(self, perf_ns: int) -> float:
        return (
            self._anchor_unix * 1e6
            + (perf_ns - self._anchor_perf_ns) / 1e3
        )

    def export(self, path: str | None = None) -> dict[str, Any]:
        """Build (and optionally write) the Chrome-trace export: the
        standard ``traceEvents`` list plus our schema header. The file
        loads directly in Perfetto / ``chrome://tracing``; merge
        per-host files with ``scripts/merge_traces.py``.

        ``path`` may contain ``{process}``, formatted with the process
        index — the multi-host spelling (every host exports its own).
        """
        process = _process_index()
        pid = os.getpid()
        events: list[dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"host {process} (pid {pid})"},
            }
        ]
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        seen_tids: set[int] = set()
        for ph, name, start_ns, dur_ns, tid, args in list(self._events):
            if tid not in seen_tids:
                seen_tids.add(tid)
                label = self._track_names.get(tid) or thread_names.get(
                    tid, f"tid {tid}"
                )
                events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": label},
                    }
                )
            ev: dict[str, Any] = {
                "name": name,
                "ph": ph,
                "ts": self._ts_us(start_ns),
                "pid": pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            if args:
                ev["args"] = args
            events.append(ev)
        record = {
            "schema": TRACE_SCHEMA,
            "kind": "trace",
            "time_unix": time.time(),
            "process": process,
            "displayTimeUnit": "ms",
            "traceEvents": events,
        }
        if path is not None:
            import json

            path = path.format(process=process)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(record, f)
        return record


# ---------------------------------------------------------------------------
# Default tracer + module-level conveniences (what the built-in
# instrumentation in comm/data/train records through).
# ---------------------------------------------------------------------------

_default = Tracer()
_default_lock = threading.Lock()
_export_path: str | None = None


def get_tracer() -> Tracer:
    """The process-global default tracer."""
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the default tracer (returns the previous one)."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
    return prev


def trace_enabled() -> bool:
    return _default.enabled


def span(name: str, **args: Any) -> Any:
    """``with span("train.step"): ...`` on the default tracer."""
    return _default.span(name, **args)


def instant(name: str, **args: Any) -> None:
    _default.instant(name, **args)


def add_complete_event(name: str, t0: float, t1: float, **args: Any) -> None:
    _default.add_complete_event(name, t0, t1, **args)


def name_track(track: int, name: str) -> None:
    _default.name_track(track, name)


def configure(spec: Any = None) -> Tracer:
    """Wire tracing from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_TRACE`` (same forms; no-op when
      unset);
    - ``False`` / ``"0"`` — disable recording;
    - ``True`` / ``"1"`` — enable recording (export on demand);
    - any other string — enable AND export to that path at
      :func:`shutdown` (``{process}`` in the path is formatted with the
      process index — use it in multi-host runs);
    - a :class:`Tracer` — install it as the default (enabled).

    Called by ``fluxmpi_tpu_torch.init(trace=...)``; idempotent.
    """
    global _export_path
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _default
    if isinstance(spec, Tracer):
        spec.enabled = True
        set_tracer(spec)
        return spec
    if spec is False or spec == "0":
        # Disabling revokes the pending export too: a run the user
        # explicitly de-instrumented must not still emit (and clobber)
        # a trace file at shutdown with stale pre-disable events.
        _default.enabled = False
        _export_path = None
        return _default
    if spec is True or spec == "1":
        _default.enabled = True
        return _default
    if isinstance(spec, str):
        try:
            # Fail HERE, not at shutdown: a bad placeholder discovered
            # at export time (inside shutdown's failure-safe swallow)
            # would silently lose the whole trace after the run paid
            # for recording it.
            spec.format(process=0)
        except (KeyError, IndexError, ValueError) as exc:
            raise ValueError(
                f"trace export path {spec!r} is not formattable: {exc!r} "
                f"(only a {{process}} placeholder is supported)"
            ) from None
        _default.enabled = True
        _export_path = spec
        return _default
    raise ValueError(
        f"trace spec must be a bool, '0'/'1', a path, or a Tracer; "
        f"got {spec!r}"
    )


def shutdown() -> str | None:
    """Export the default tracer to the configured path (if any) and
    return the written path. Recording state is left as-is — shutdown
    is about not losing the ring, not about disabling; the full
    teardown (``telemetry.shutdown()``) calls :func:`reset` after."""
    if _export_path is None or not len(_default):
        return None
    # export() owns the one-and-only {process} formatting — formatting
    # here too would re-format the result and break escaped braces.
    _default.export(_export_path)
    return _export_path.format(process=_process_index())


def reset() -> None:
    """Disable recording and drop the default tracer's ring, open-span
    stacks, and pending export path — called by ``telemetry.shutdown()``
    AFTER :func:`shutdown` exported the ring (the fault-plane leak rule:
    a tracer left recording, or run 1's events still in the ring, would
    leak into the next init cycle's exports and hang dumps)."""
    global _export_path
    _default.enabled = False
    _default.clear()
    _default._open.clear()
    _default._track_names.clear()
    _export_path = None
