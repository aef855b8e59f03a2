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
  time by bucket and live MFU; :mod:`~fluxmpi_tpu_torch.telemetry.anomaly`
  — :class:`AnomalyDetector`, NaN / loss-spike / step-time / data-stall /
  retrace / per-layer / SLO-burn / straggler rules with warn/halt
  policies, ``anomaly.*`` instants and a diagnostics bundle.
- **Model internals**: :mod:`~fluxmpi_tpu_torch.telemetry.modelstats` —
  per-layer gradient/parameter/update norms, NaN provenance and the
  gradient noise scale, computed in the step.
- **Device**: :mod:`~fluxmpi_tpu_torch.telemetry.compileplane` — kernel
  builds and CUDA-graph captures as compile events, attributed to the
  tracked programs (``steady_state_retrace``); anomaly-triggered
  ``torch.profiler`` captures (:mod:`fluxmpi_tpu_torch.utils.profiling`).
- **Memory**: :mod:`~fluxmpi_tpu_torch.telemetry.memory` — the CUDA
  allocator's ``memory.*`` gauges, a live-tensor census and the OOM
  bundle.
- **Live export**: :mod:`~fluxmpi_tpu_torch.telemetry.export` —
  :class:`Exporter`, Prometheus ``/metrics``, ``/status`` and
  ``/healthz``; :mod:`~fluxmpi_tpu_torch.telemetry.fleet` —
  :class:`FleetCollector`, the cross-host collector and its straggler
  attribution.

Recording is on by default for metrics and the flight recorder (an
update is a few dict/deque operations); spans, the watchdog, goodput and
the other planes are opt-in. Emission is opt-in through
:func:`configure`, ``fluxmpi_tpu_torch.init(telemetry=...)`` or
``FLUXMPI_TPU_TELEMETRY``. Importing this package initializes neither
CUDA nor a process group.
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
from . import anomaly  # noqa: F401
from .anomaly import (  # noqa: F401
    AnomalyDetector,
    get_anomaly_detector,
    set_anomaly_detector,
)
from . import modelstats  # noqa: F401
from .modelstats import (  # noqa: F401
    ModelStats,
    get_model_stats,
    set_model_stats,
)
from . import compileplane  # noqa: F401
from .compileplane import (  # noqa: F401
    CompileMonitor,
    get_compile_monitor,
    set_compile_monitor,
)
from . import memory  # noqa: F401
from . import export  # noqa: F401
from .export import (  # noqa: F401
    Exporter,
    get_exporter,
    set_exporter,
)
from . import fleet  # noqa: F401
from .fleet import (  # noqa: F401
    FleetCollector,
    get_fleet_collector,
    set_fleet_collector,
)

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
    "AnomalyDetector",
    "get_anomaly_detector",
    "set_anomaly_detector",
    "ModelStats",
    "get_model_stats",
    "set_model_stats",
    "CompileMonitor",
    "get_compile_monitor",
    "set_compile_monitor",
    "Exporter",
    "get_exporter",
    "set_exporter",
    "FleetCollector",
    "get_fleet_collector",
    "set_fleet_collector",
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
    (request log closed, burn windows cleared), stop the fleet collector
    (its thread scrapes the exporters), stop the live exporter (socket
    closed, serving thread joined: the port is free at once), disarm the
    watchdog, export the trace ring (when a path was configured), then
    reset the tracer and the flight recorder's ring, reset the run-health
    planes (goodput window, anomaly detector), the model-internals plane
    and the device planes (compile monitor, memory plane, auto-profiler:
    state left armed would leak into the next init cycle), then flush and
    detach every sink on the default registry (instruments survive — a
    re-configured registry keeps its cumulative counters)."""
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
        fleet.shutdown()
    except Exception:
        pass
    try:
        export.shutdown()
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
        anomaly.shutdown()
    except Exception:
        pass
    try:
        modelstats.shutdown()
    except Exception:
        pass
    try:
        compileplane.shutdown()
    except Exception:
        pass
    try:
        memory.shutdown()
    except Exception:
        pass
    try:
        from ..utils.profiling import shutdown_auto_profiler

        shutdown_auto_profiler()
    except Exception:
        pass
    get_registry().close()
