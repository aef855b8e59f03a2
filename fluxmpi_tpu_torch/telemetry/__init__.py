"""Telemetry: metrics, tracing, flight recorder, watchdog, goodput and
the memory plane (the core of :mod:`fluxmpi_tpu.telemetry`, under its
names, metric names, span names, environment variables and record
schemas, so ``scripts/check_metrics_schema.py``, ``goodput_report.py``,
``merge_traces.py`` and ``telemetry_jsonl.py`` read the port's files
unchanged).

- **Metrics**: :class:`MetricsRegistry` — labeled counter/gauge/histogram
  instruments flushed as one ``fluxmpi_tpu.telemetry/v1`` record per
  flush to :class:`JSONLSink` / :class:`MemorySink` /
  :class:`ConsoleSink`. The eager collectives (``comm.*``), the loader
  (``data.*``), the fault sites (``fault.injected``), the checkpoints
  (``checkpoint.*``) and ``make_train_step(metrics=)`` /
  ``train_loop(metrics=)`` (``train.*``) record into the default
  registry; :class:`TrainingMonitor` adds device memory, the cross-rank
  step-time gather (straggler flag) and a heartbeat.
- **Trace**: :mod:`~fluxmpi_tpu_torch.telemetry.tracing` — host spans
  and instants in a bounded ring, exported as Chrome-trace JSON
  (``fluxmpi_tpu.trace/v1``); :mod:`~fluxmpi_tpu_torch.telemetry.
  flight_recorder` — the last N eager collectives, diffable across
  ranks (:func:`diff_flight_dumps`); :mod:`~fluxmpi_tpu_torch.telemetry.
  watchdog` — a stall detector that dumps every thread's stack and the
  flight ring.
- **Run health**: :mod:`~fluxmpi_tpu_torch.telemetry.goodput` — wall
  time by bucket and live MFU.
- **Memory**: :mod:`~fluxmpi_tpu_torch.telemetry.memory` — the CUDA
  allocator's ``memory.*`` gauges, a live-tensor census and the OOM
  bundle.

Recording is on by default for metrics and the flight recorder (an
update is a few dict/deque operations); spans, the watchdog, goodput and
the memory plane are opt-in. Emission is opt-in through
:func:`configure`, ``fluxmpi_tpu_torch.init(telemetry=...)`` or
``FLUXMPI_TPU_TELEMETRY``. Importing this package initializes neither
CUDA nor a process group.

Not ported yet: the anomaly, model-stats, compile, export and fleet
planes.
"""

from __future__ import annotations

import os
from typing import Any

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from .schema import (  # noqa: F401
    SCHEMA,
    TRACE_SCHEMA,
    validate_bench_record,
    validate_flight_dump,
    validate_metric,
    validate_record,
    validate_trace_export,
    validate_watchdog_dump,
)
from .sinks import (  # noqa: F401
    ConsoleSink,
    JSONLSink,
    MemorySink,
    NullSink,
    Sink,
)
from .monitor import TrainingMonitor  # noqa: F401
from . import tracing  # noqa: F401
from .tracing import (  # noqa: F401
    Tracer,
    get_tracer,
    instant,
    set_tracer,
    span,
    trace_enabled,
)
from . import flight_recorder  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    diff_dumps as diff_flight_dumps,
    get_flight_recorder,
    set_flight_recorder,
)
from . import watchdog  # noqa: F401
from .watchdog import (  # noqa: F401
    Watchdog,
    arm_watchdog,
    disarm_watchdog,
    get_watchdog,
    notify_progress,
)
from . import goodput  # noqa: F401
from .goodput import (  # noqa: F401
    GoodputTracker,
    get_goodput_tracker,
    set_goodput_tracker,
)
from . import memory  # noqa: F401

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "SCHEMA",
    "TRACE_SCHEMA",
    "validate_record",
    "validate_metric",
    "validate_bench_record",
    "validate_trace_export",
    "validate_flight_dump",
    "validate_watchdog_dump",
    "Sink",
    "JSONLSink",
    "MemorySink",
    "ConsoleSink",
    "NullSink",
    "TrainingMonitor",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "trace_enabled",
    "FlightRecorder",
    "get_flight_recorder",
    "set_flight_recorder",
    "diff_flight_dumps",
    "Watchdog",
    "arm_watchdog",
    "disarm_watchdog",
    "get_watchdog",
    "notify_progress",
    "GoodputTracker",
    "get_goodput_tracker",
    "set_goodput_tracker",
    "configure",
    "shutdown",
]

_ENV_VAR = "FLUXMPI_TPU_TELEMETRY"


def configure(spec: Any = None) -> MetricsRegistry:
    """Wire emission for the default registry from a one-value spec.

    ``spec`` may be:

    - ``None`` — read the ``FLUXMPI_TPU_TELEMETRY`` env var (same forms
      below; no-op when unset);
    - ``"console"`` / ``True`` — attach a rank-0 :class:`ConsoleSink`;
    - any other string — treat as a path, attach a :class:`JSONLSink`
      (give each process its own path in a world of several);
    - a :class:`Sink` instance — attach it;
    - a :class:`MetricsRegistry` — install it as the default registry.

    Returns the (possibly new) default registry. Called by
    ``fluxmpi_tpu_torch.init(telemetry=...)``; safe to call directly.
    Idempotent for equivalent specs, so a repeated ``init()`` never
    attaches the same sink twice.
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR) or None
        if spec is None:
            return get_registry()
    if isinstance(spec, MetricsRegistry):
        set_registry(spec)
        return spec
    reg = get_registry()
    if spec is True or spec == "console":
        if any(isinstance(s, ConsoleSink) for s in reg.sinks):
            return reg
        sink: Sink = ConsoleSink()
    elif isinstance(spec, Sink):
        if spec in reg.sinks:
            return reg
        sink = spec
    elif isinstance(spec, str):
        if any(
            isinstance(s, JSONLSink) and s.path == spec for s in reg.sinks
        ):
            return reg
        sink = JSONLSink(spec)
    else:
        raise ValueError(
            f"telemetry spec must be a path, 'console', a Sink, or a "
            f"MetricsRegistry; got {spec!r}"
        )
    reg.add_sink(sink)
    return reg


def shutdown() -> None:
    """Tear down the planes in failure-safe order: reset the serving plane
    first (engine stopped, pending requests rejected, KV pools dropped: it
    posts into every surface below), then the request-observability plane
    (request log closed, burn windows cleared), disarm the watchdog,
    export the trace ring (when a path was configured), then reset the
    tracer and the flight recorder's ring, reset the goodput window and
    the memory plane (state left armed would leak into the next init
    cycle), then flush and detach every sink on the default registry
    (instruments survive — a re-configured registry keeps its cumulative
    counters)."""
    try:
        from ..serving import shutdown as _serving_shutdown

        _serving_shutdown()
    except Exception:
        pass
    try:
        from ..serving import observe as _serving_observe

        _serving_observe.shutdown()
    except Exception:
        pass
    try:
        disarm_watchdog()
    except Exception:
        pass
    try:
        tracing.shutdown()
    except Exception:
        pass
    try:
        # AFTER the export above: reset drops the ring the export just
        # saved. The flight recorder keeps its cumulative counters but
        # drops the entries — run 1's launches must not appear in run
        # 2's hang dumps.
        tracing.reset()
        get_flight_recorder().clear()
    except Exception:
        pass
    try:
        goodput.shutdown()
    except Exception:
        pass
    try:
        memory.shutdown()
    except Exception:
        pass
    get_registry().close()
