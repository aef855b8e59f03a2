"""Live export plane: Prometheus ``/metrics``, ``/status``, ``/healthz``
(counterpart of :mod:`fluxmpi_tpu.telemetry.export`: the same endpoints,
name mangling, status schema and health clock, so
``scripts/fluxmpi_top.py`` and ``scripts/fleet_report.py`` read the port's
surfaces unchanged).

Every other plane in this package is **post-mortem**: JSONL banks,
crash bundles, and offline report scripts. A fleet operator (or an
orchestrator's health checker) needs the opposite shape — live,
scrapeable, always-on visibility into a run *while it is running*.
:class:`Exporter` is that surface: a stdlib-only ``http.server`` on a
daemon thread serving three endpoints per process:

``/metrics``
    Prometheus text exposition rendered live from the default
    :class:`~fluxmpi_tpu_torch.telemetry.MetricsRegistry` snapshot —
    counters/gauges/histograms with labels — plus live ``goodput.*``
    values straight from the enabled tracker (no flush required) and
    the exporter's own ``export.*`` self-telemetry. Metric names pass
    through a **lossless mangling layer** (:func:`mangle_name` /
    :func:`demangle_name`): the closed ``fluxmpi_tpu.telemetry/v1``
    namespace round-trips exactly, so a scrape can be validated against
    ``schema.KNOWN_METRIC_NAMES`` — the exporter cannot become a side
    channel around the closed namespace.

``/status``
    One JSON snapshot (schema ``fluxmpi_tpu.status/v1``): run id,
    process/rank, the ``train`` fields :func:`train_loop
    <fluxmpi_tpu_torch.parallel.train_loop>` notes at flush boundaries
    (updates, loss, fused-window config, ...), a live goodput
    breakdown + MFU, the last anomaly, the monitor's heartbeat ages,
    and the health verdict. ``scripts/fluxmpi_top.py`` polls this
    across a host list and renders the fleet view.

``/healthz``
    Liveness keyed to the **watchdog's progress clock** (the same
    monotonic sources an armed :class:`~fluxmpi_tpu_torch.telemetry.Watchdog`
    polls: the :func:`~fluxmpi_tpu_torch.telemetry.notify_progress` counter
    and the flight recorder's completed count). 200 while progress
    advances (or before training ever started); **503 once progress has
    been seen and then stalls past the deadline** — so an orchestrator
    (k8s liveness probe, GCE MIG health check) can restart a wedged
    host without parsing logs. Back to 200 the moment progress resumes.
    The deadline is the armed watchdog's when one exists (one source of
    truth for "stalled"), else ``deadline=``/300 s.

Wiring follows the package convention: ``init(export=...)`` /
``FLUXMPI_TPU_EXPORT_PORT`` (+ ``FLUXMPI_TPU_EXPORT_ADDR``) /
:func:`configure`. Two standing contracts hold:

- **zero-cost-when-off**: no exporter configured
  (the default) means no thread, no socket, no handler registration —
  ``train_loop`` reads one module attribute per run and never calls
  :meth:`Exporter.note_status` (monkeypatch-explode tested);
- **full reset in ``telemetry.shutdown()``** (the fault-plane leak
  rule): the socket is closed and the serving thread joined, so the
  port is immediately free for a re-init.

Stdlib only: the process index comes through
:func:`~fluxmpi_tpu_torch.telemetry.registry.process_index_or_zero` and
the process count from the runtime, which ask ``torch.distributed`` only
once a process group is up.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from .registry import MetricsRegistry, get_registry
from .registry import process_index_or_zero as _process_index
from .schema import STATUS_SCHEMA

__all__ = [
    "Exporter",
    "get_exporter",
    "set_exporter",
    "configure",
    "shutdown",
    "mangle_name",
    "demangle_name",
    "exposed_base_name",
    "render_prometheus",
    "DEFAULT_PORT",
    "HISTOGRAM_SUFFIXES",
]

_ENV_PORT = "FLUXMPI_TPU_EXPORT_PORT"
_ENV_ADDR = "FLUXMPI_TPU_EXPORT_ADDR"
_ENV_RUN_ID = "FLUXMPI_TPU_RUN_ID"

DEFAULT_PORT = 9307
_DEFAULT_ADDR = "0.0.0.0"
_DEFAULT_HEALTH_DEADLINE_S = 300.0

_PREFIX = "fluxmpi_"

# The flat series a histogram instrument exposes (count/sum exactly as a
# Prometheus histogram would; min/max/mean/last are this registry's
# exact-tail story; _bucket carries the schema-declared cumulative
# buckets — `le` labeled, +Inf included — for names with edges in
# ``schema.HISTOGRAM_BUCKET_EDGES``, so PromQL histogram_quantile works
# on TTFT/step-time). Suffixes are appended AFTER mangling, so
# demangling strips them first (exposed_base_name).
HISTOGRAM_SUFFIXES = (
    "_count", "_sum", "_min", "_max", "_mean", "_last", "_bucket",
)


# ---------------------------------------------------------------------------
# Name mangling: dotted registry names <-> Prometheus-legal names,
# losslessly. Prometheus names match [a-zA-Z_:][a-zA-Z0-9_:]* — dots are
# illegal, but the registry's names use BOTH dots and underscores
# ("train.step_seconds"), so the naive dot->underscore map is ambiguous.
# The classic escape-the-escape scheme keeps it bijective:
#
#     "_" -> "__"      then      "." -> "_"
#
# e.g. "train.step_seconds" -> "fluxmpi_train_step__seconds". Demangling
# scans left to right: "__" -> "_", remaining single "_" -> ".". Internal
# double underscores are legal exposition names (only the *leading* "__"
# is reserved by Prometheus, and the "fluxmpi_" prefix precludes it).
# ---------------------------------------------------------------------------


def mangle_name(name: str) -> str:
    """Registry metric name -> Prometheus series name (lossless)."""
    return _PREFIX + name.replace("_", "__").replace(".", "_")


def demangle_name(series: str) -> str:
    """Inverse of :func:`mangle_name`. Raises ``ValueError`` on a series
    name that did not come from it (wrong prefix)."""
    if not series.startswith(_PREFIX):
        raise ValueError(
            f"not a fluxmpi_tpu exported series (no {_PREFIX!r} prefix): "
            f"{series!r}"
        )
    body = series[len(_PREFIX):]
    out: list[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "_":
            if i + 1 < len(body) and body[i + 1] == "_":
                out.append("_")
                i += 2
            else:
                out.append(".")
                i += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def exposed_base_name(series: str) -> str:
    """Registry name behind one exposed series, histogram suffixes
    stripped: ``fluxmpi_train_step__seconds_count`` ->
    ``train.step_seconds``. The smoke test validates every scraped
    series through this against ``schema.KNOWN_METRIC_NAMES``."""
    direct = demangle_name(series)
    for suffix in HISTOGRAM_SUFFIXES:
        if series.endswith(suffix):
            stem = demangle_name(series[: -len(suffix)])
            # Ambiguity break: a plain counter/gauge demangles directly;
            # prefer the suffix-stripped reading only when the direct
            # one ends in the suffix's dotted ghost (".count" etc.).
            if direct.endswith(suffix.replace("_", ".", 1)):
                return stem
    return direct


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _format_value(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return format(v, ".17g")


def _series_line(series: str, labels: dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
        )
        return f"{series}{{{inner}}} {_format_value(value)}"
    return f"{series} {_format_value(value)}"


def _goodput_live_metrics() -> list[dict[str, Any]]:
    """Live ``goodput.*`` gauge objects computed from the enabled
    tracker's report — the scrape-time counterpart of
    ``GoodputTracker.record()``, so ``/metrics`` is current between
    flush boundaries (the gauges in the registry only advance when
    ``train_loop`` flushes). Empty when the plane is off."""
    from . import goodput as _goodput

    gp = _goodput.get_goodput_tracker()
    if not gp.enabled:
        return []
    rep = gp.report()
    out: list[dict[str, Any]] = []

    def gauge(name: str, value: float, **labels: str) -> None:
        out.append(
            {"name": name, "type": "gauge", "labels": labels, "value": value}
        )

    for bucket, seconds in rep["buckets"].items():
        gauge("goodput.bucket_seconds", seconds, bucket=bucket)
    gauge("goodput.wall_seconds", rep["wall_seconds"])
    gauge("goodput.fraction", rep["goodput_fraction"])
    gauge("goodput.updates", float(rep["updates"]))
    if rep["mfu"] is not None:
        gauge("goodput.mfu", rep["mfu"])
    if rep["mfu_productive"] is not None:
        gauge("goodput.mfu_productive", rep["mfu_productive"])
    return out


def render_prometheus(metrics: list[dict[str, Any]]) -> str:
    """Render schema-shaped metric objects (``MetricsRegistry.snapshot``
    entries) as Prometheus text exposition (format 0.0.4). Counters and
    gauges map directly; a histogram becomes its flat
    :data:`HISTOGRAM_SUFFIXES` series (count/sum as counters, the
    min/max/mean/last tail as gauges). One ``# TYPE`` line per family.
    Later duplicates of one (name, labels) pair win — the live-goodput
    overlay relies on that."""
    # (series, labels-key) -> (labels, value); insertion order kept so
    # families group, later writers override earlier ones.
    families: dict[str, str] = {}  # series -> TYPE
    values: dict[tuple[str, tuple], tuple[dict[str, str], float]] = {}

    def put(series: str, kind: str, labels: dict[str, str], value: float) -> None:
        families.setdefault(series, kind)
        key = (series, tuple(sorted(labels.items())))
        values[key] = (labels, value)

    for m in metrics:
        name = m.get("name")
        kind = m.get("type")
        labels = {
            str(k): str(v) for k, v in (m.get("labels") or {}).items()
        }
        if not isinstance(name, str) or not name:
            continue
        base = mangle_name(name)
        if kind == "counter":
            put(base, "counter", labels, m.get("value", 0.0))
        elif kind == "gauge":
            put(base, "gauge", labels, m.get("value", 0.0))
        elif kind == "histogram":
            count = int(m.get("count", 0))
            put(base + "_count", "counter", labels, float(count))
            if count > 0:
                put(base + "_sum", "counter", labels, m.get("sum", 0.0))
                for stat in ("min", "max", "mean", "last"):
                    put(base + f"_{stat}", "gauge", labels, m.get(stat, 0.0))
            buckets = m.get("buckets")
            if isinstance(buckets, dict):
                # Cumulative _bucket{le=...} series with the schema-
                # declared edges (registry snapshots carry them already
                # cumulative) plus the +Inf bucket == count — the shape
                # PromQL histogram_quantile consumes.
                edges = buckets.get("edges") or ()
                counts = buckets.get("counts") or ()
                for edge, c in zip(edges, counts):
                    put(
                        base + "_bucket",
                        "counter",
                        {**labels, "le": format(float(edge), "g")},
                        float(c),
                    )
                put(
                    base + "_bucket",
                    "counter",
                    {**labels, "le": "+Inf"},
                    float(count),
                )
    lines: list[str] = []
    emitted_type: set[str] = set()
    for (series, _), (labels, value) in values.items():
        if series not in emitted_type:
            emitted_type.add(series)
            lines.append(f"# TYPE {series} {families[series]}")
        lines.append(_series_line(series, labels, value))
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Health: the watchdog's progress clock, evaluated per request.
# ---------------------------------------------------------------------------


def _default_health_sources() -> list[Callable[[], float]]:
    from .flight_recorder import get_flight_recorder
    from .watchdog import progress_value

    return [
        progress_value,
        lambda: get_flight_recorder().completed_count,
    ]


class Exporter:
    """In-process live exporter (one per training process).

    Args:
      port: TCP port to bind (0 = ephemeral; the bound port is readable
        as :attr:`port` after :meth:`start` — the test/smoke spelling).
        Fleet runs use the same fixed port on every host so one
        Prometheus scrape config covers the fleet.
      addr: bind address (default ``0.0.0.0`` — the scraper is remote).
      registry: registry ``/metrics`` snapshots (default: the
        process-global one, resolved at scrape time).
      deadline: seconds without progress before ``/healthz`` flips 503.
        ``None`` (default) follows the armed watchdog's deadline when
        one exists, else 300 s — one definition of "stalled".
      clock: monotonic time source (injectable — the watchdog's
        fake-clock test discipline).
      sources: zero-arg monotonic progress callables (default: the
        watchdog's own — the :func:`notify_progress` counter and the
        flight recorder's completed count).

    The server thread is a daemon and every handler is read-only against
    GIL-atomic state, so a scrape never blocks training. ``/healthz``
    semantics: 200 before any progress was ever observed (a process that
    has not started training is alive, merely idle), 503 only once
    progress was seen and then stalled past the deadline, 200 again as
    soon as it resumes.
    """

    def __init__(
        self,
        port: int = DEFAULT_PORT,
        addr: str = _DEFAULT_ADDR,
        *,
        registry: MetricsRegistry | None = None,
        deadline: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        sources: list[Callable[[], float]] | None = None,
    ):
        if port < 0:
            raise ValueError(f"port must be >= 0, got {port}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        self.requested_port = int(port)
        self.addr = addr
        self.enabled = True
        self._registry = registry
        self.deadline = deadline
        self._clock = clock
        self._sources = (
            list(sources) if sources is not None else _default_health_sources()
        )
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._status: dict[str, Any] = {}
        self._serving: dict[str, Any] = {}
        self._model: dict[str, Any] = {}
        self._parallel: dict[str, Any] = {}
        self._fleet: dict[str, Any] = {}
        self._autotune: dict[str, Any] = {}
        self._checkpoint: dict[str, Any] = {}
        self._resize: dict[str, Any] = {}
        self._status_lock = threading.Lock()
        # Progress plateau tracking (the watchdog's check() shape,
        # evaluated lazily per health request instead of on a poll
        # thread — the exporter adds no thread beyond the server's).
        self._last_values: tuple | None = None
        self._last_change: float | None = None
        self._progress_seen = False
        # Run identity must come from the RUN, not this process: pids
        # and start seconds differ across the hosts of one job (and
        # across a preemption resume), so a locally-minted id would make
        # every host of a healthy fleet read as a different run. The
        # launcher owns the job name — FLUXMPI_TPU_RUN_ID (a k8s job
        # name, an XManager id) is shared by every host; the local
        # stamp is the single-host fallback.
        self.run_id = (
            os.environ.get(_ENV_RUN_ID)
            or f"{int(time.time()):x}-{os.getpid()}"
        )

    # -- lifecycle -----------------------------------------------------

    @property
    def port(self) -> int:
        """The actually-bound port (resolves ``port=0``); the requested
        port before :meth:`start`."""
        if self._server is not None:
            return int(self._server.server_address[1])
        return self.requested_port

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Exporter":
        """Bind the socket and start serving on a daemon thread
        (idempotent)."""
        if self.running:
            return self
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            # Scrapes are periodic; default per-request stderr logging
            # would drown the training logs.
            def log_message(self, *args: Any) -> None:  # noqa: D102
                pass

            def do_GET(self) -> None:  # noqa: N802
                exporter._handle(self)

        server = ThreadingHTTPServer((self.addr, self.requested_port), _Handler)
        server.daemon_threads = True
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="fluxmpi-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close the socket and join the serving thread (idempotent) —
        the port is immediately rebindable (``telemetry.shutdown()``'s
        full-reset contract)."""
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- status board (loop-thread writers, scrape-thread readers) -----

    def note_status(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``train`` section of ``/status``.
        ``train_loop`` calls this at flush boundaries (run config at
        start, counters/loss per flush, outcome at exit) — a dict update
        under a lock, nothing device-side, nothing per step."""
        with self._status_lock:
            self._status.update(fields)
            self._status["noted_unix"] = time.time()

    def note_serving(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``serving`` section of ``/status``
        — the inference engine's board (active/queued requests, decode
        step counter, KV block occupancy, SLO violations), posted at
        its admission/flush boundaries the way ``train_loop`` posts the
        ``train`` board. ``scripts/fluxmpi_top.py`` renders it as the
        serving view."""
        with self._status_lock:
            self._serving.update(fields)
            self._serving["noted_unix"] = time.time()

    def note_model(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``model`` section of ``/status`` —
        the model-internals board (gradient noise scale / B_simple,
        top-k layers by gradient norm, the first nonfinite layer when
        one exists), posted by ``train_loop`` at flush boundaries when
        the :mod:`~fluxmpi_tpu_torch.telemetry.modelstats` plane is on.
        ``scripts/fluxmpi_top.py`` renders it as the MODEL view."""
        with self._status_lock:
            self._model.update(fields)
            self._model["noted_unix"] = time.time()

    def note_parallel(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``parallel`` section of ``/status``
        — the PARALLEL board (resolved mesh/axis sizes, the plan→mesh
        axis-name map, per-source partition-rule hit counts), posted by
        ``init(parallel=)`` when the plan is installed and refreshed by
        ``ResolvedPlan.shard_state``. ``scripts/fluxmpi_top.py`` renders
        it as the PARALLEL view."""
        with self._status_lock:
            self._parallel.update(fields)
            self._parallel["noted_unix"] = time.time()

    def note_fleet(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``fleet`` section of ``/status`` —
        this host's cross-host attribution ingredients (cumulative
        goodput bucket seconds, collective block time, the
        flight-recorder launch/complete sequence, the update counter),
        posted by ``train_loop`` at flush boundaries when the
        :mod:`~fluxmpi_tpu_torch.telemetry.fleet` plane is on. The
        :class:`~fluxmpi_tpu_torch.telemetry.fleet.FleetCollector` scrapes
        this section from every host and joins the rows into the
        straggler attribution; the collector posts its own verdict back
        here too, so ``scripts/fluxmpi_top.py`` renders the FLEET board
        from the same endpoint."""
        with self._status_lock:
            self._fleet.update(fields)
            self._fleet["noted_unix"] = time.time()

    def note_autotune(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``autotune`` section of ``/status``
        — the AUTOTUNE board (winning axes, candidate/prune/trial
        census, best trial throughput, bank hit vs fresh tune, the
        model fingerprint keying the bank), posted by
        ``parallel/autotune.autotune`` when a search completes or a
        banked winner is reused. ``scripts/fluxmpi_top.py`` renders it
        as the AUTOTUNE view."""
        with self._status_lock:
            self._autotune.update(fields)
            self._autotune["noted_unix"] = time.time()

    def note_checkpoint(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``checkpoint`` section of
        ``/status`` — the CHECKPOINT board (last committed step and its
        tier, whether async saves are on, the in-flight background
        save's step and start stamp, the superseded-request count),
        posted by :class:`~fluxmpi_tpu_torch.utils.checkpoint.CheckpointManager`
        after every save request and writer completion.
        ``scripts/fluxmpi_top.py`` renders it as the CHECKPOINT view."""
        with self._status_lock:
            self._checkpoint.update(fields)
            self._checkpoint["noted_unix"] = time.time()

    def note_resize(self, **fields: Any) -> None:
        """Merge ``fields`` into the ``resize`` section of ``/status``
        — the RESIZE board (requested world size, current phase of the
        drain→save→reshard→restart pipeline, per-phase badput seconds
        so far), posted by :mod:`fluxmpi_tpu_torch.fleet.resize` as a live
        resize progresses. ``scripts/fluxmpi_top.py`` renders it as the
        RESIZE view."""
        with self._status_lock:
            self._resize.update(fields)
            self._resize["noted_unix"] = time.time()

    def clear_status(self) -> None:
        with self._status_lock:
            self._status.clear()
            self._serving.clear()
            self._model.clear()
            self._parallel.clear()
            self._fleet.clear()
            self._autotune.clear()
            self._checkpoint.clear()
            self._resize.clear()

    # -- health --------------------------------------------------------

    def _read_sources(self) -> tuple:
        values = []
        for fn in self._sources:
            try:
                values.append(fn())
            except Exception:
                values.append(None)
        return tuple(values)

    def _resolve_deadline(self) -> float:
        if self.deadline is not None:
            return self.deadline
        from .watchdog import get_watchdog

        wd = get_watchdog()
        if wd is not None:
            return float(wd.deadline)
        return _DEFAULT_HEALTH_DEADLINE_S

    def health(self) -> dict[str, Any]:
        """Evaluate liveness now: read the progress sources, note any
        advance, and judge the current plateau against the deadline.
        Returns ``{"healthy", "progress_seen", "seconds_since_progress",
        "deadline_seconds", "progress"}``."""
        now = self._clock()
        values = self._read_sources()
        if self._last_values is None:
            # Baseline read. A monotonic source already past zero means
            # progress HAS happened — a probe attached after the host
            # wedged (k8s initialDelaySeconds, an operator arriving
            # late) must still flip 503 once the plateau outlives the
            # deadline, not report "never trained" forever.
            self._last_values = values
            self._last_change = now
            self._progress_seen = any(
                isinstance(v, (int, float)) and v > 0 for v in values
            )
        elif values != self._last_values:
            if any(v is not None for v in values):
                self._progress_seen = True
            self._last_values = values
            self._last_change = now
        deadline = self._resolve_deadline()
        since = now - (self._last_change if self._last_change is not None else now)
        healthy = (not self._progress_seen) or since < deadline
        return {
            "healthy": healthy,
            "progress_seen": self._progress_seen,
            "seconds_since_progress": since,
            "deadline_seconds": deadline,
            "progress": [v for v in values],
        }

    # -- endpoint bodies -----------------------------------------------

    def _live_registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def _note_request(self, endpoint: str) -> None:
        reg = self._live_registry()
        if getattr(reg, "enabled", True):
            reg.counter("export.requests", endpoint=endpoint).inc()

    def render_metrics(self) -> str:
        """The ``/metrics`` body: the registry snapshot overlaid with
        live goodput values, rendered as Prometheus text."""
        t0 = time.perf_counter()
        reg = self._live_registry()
        metrics = reg.snapshot()
        try:
            metrics.extend(_goodput_live_metrics())
        except Exception:
            pass  # a broken tracker must not kill the scrape
        body = render_prometheus(metrics)
        if getattr(reg, "enabled", True):
            # Lands in the NEXT scrape (and the JSONL stream): measuring
            # a render from inside itself would be the timing lie the
            # step_timer discipline exists to avoid.
            reg.gauge("export.render_seconds").set(time.perf_counter() - t0)
        return body

    def build_status(self) -> dict[str, Any]:
        """The ``/status`` body (schema ``fluxmpi_tpu.status/v1``)."""
        from . import anomaly as _anomaly
        from . import goodput as _goodput
        from .watchdog import get_watchdog

        with self._status_lock:
            train = dict(self._status)
            serving = dict(self._serving) or None
            model = dict(self._model) or None
            parallel = dict(self._parallel) or None
            fleet = dict(self._fleet) or None
            autotune = dict(self._autotune) or None
            checkpoint = dict(self._checkpoint) or None
            resize = dict(self._resize) or None
        gp = _goodput.get_goodput_tracker()
        goodput_rep = gp.report() if gp.enabled else None
        det = _anomaly.get_anomaly_detector()
        last_anomaly = (
            det.triggered[-1] if det is not None and det.triggered else None
        )
        monitor: dict[str, float] = {}
        for m in self._live_registry().snapshot():
            name = m.get("name", "")
            if name.startswith("monitor.") and "value" in m:
                monitor[name[len("monitor."):]] = m["value"]
        wd = get_watchdog()
        process_count = 1
        try:
            from .. import runtime

            if runtime.is_initialized():
                process_count = runtime.process_count()
        except Exception:
            pass
        return {
            "schema": STATUS_SCHEMA,
            "time_unix": time.time(),
            "run_id": self.run_id,
            "process": _process_index(),
            "process_count": process_count,
            "train": train,
            "serving": serving,
            "model": model,
            "parallel": parallel,
            "fleet": fleet,
            "autotune": autotune,
            "checkpoint": checkpoint,
            "resize": resize,
            "goodput": goodput_rep,
            "anomaly": last_anomaly,
            "monitor": monitor,
            "watchdog": {
                "armed": wd is not None and wd.armed,
                "deadline_seconds": wd.deadline if wd is not None else None,
            },
            "health": self.health(),
        }

    # -- request dispatch ----------------------------------------------

    def _handle(self, handler: BaseHTTPRequestHandler) -> None:
        path = handler.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._note_request("metrics")
                body = self.render_metrics().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif path == "/status":
                self._note_request("status")
                body = json.dumps(self.build_status()).encode("utf-8")
                ctype = "application/json"
                code = 200
            elif path == "/healthz":
                self._note_request("healthz")
                health = self.health()
                body = json.dumps(health).encode("utf-8")
                ctype = "application/json"
                code = 200 if health["healthy"] else 503
            else:
                body = b'{"error": "not found"}'
                ctype = "application/json"
                code = 404
        except Exception as exc:  # a scrape must never kill the server
            body = json.dumps({"error": repr(exc)}).encode("utf-8")
            ctype = "application/json"
            code = 500
        try:
            handler.send_response(code)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response


# ---------------------------------------------------------------------------
# Module wiring (init kwarg / env var) — the telemetry.configure shape.
# ---------------------------------------------------------------------------

_active: Exporter | None = None
_active_lock = threading.Lock()


def get_exporter() -> Exporter | None:
    """The running exporter, if any (None = plane off). ``train_loop``
    reads this once per run — the zero-cost-when-off gate."""
    return _active


def set_exporter(exporter: Exporter | None) -> Exporter | None:
    """Install (or, with None, remove) the process exporter; returns the
    previous one. Starting/stopping is the caller's business
    (:func:`configure` starts, :func:`shutdown` stops)."""
    global _active
    with _active_lock:
        prev, _active = _active, exporter
    return prev


def configure(spec: Any = None) -> Exporter | None:
    """Wire the live export plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_EXPORT_PORT`` (no-op when
      unset/empty); the bind address comes from
      ``FLUXMPI_TPU_EXPORT_ADDR`` (default ``0.0.0.0``);
    - ``False`` / ``"0"`` — stop and remove any running exporter;
    - ``True`` / ``"1"`` — serve on the default port (9307; ``"1"`` is
      the repo-wide "on" spelling, never TCP port 1);
    - any other int or digit string — serve on that port;
    - an :class:`Exporter` — install and start it (the ephemeral-port
      spelling: ``configure(Exporter(port=0))``, bound port readable
      from :attr:`Exporter.port`).

    Called by ``fluxmpi_tpu_torch.init(export=...)``; idempotent — a replay
    naming the running exporter's port/addr keeps it (and its status
    board) rather than bouncing the socket. Degrade-not-crash on the
    operational failure modes: a malformed ``FLUXMPI_TPU_EXPORT_PORT``
    warns and leaves the plane off (the ``faults.configure`` env-typo
    convention — an env typo must not crash a training job), and a bind
    failure (port already in use) warns and leaves the plane off — a
    monitoring socket must never kill training.
    """
    from_env = spec is None
    if spec is None:
        spec = os.environ.get(_ENV_PORT)
        if spec is None or spec == "":
            return _active
    if spec is False or spec == "0" or spec == 0:
        shutdown()
        return None
    if isinstance(spec, Exporter):
        if spec is _active and spec.running:
            return spec
        shutdown()
        set_exporter(spec)
        return _start_or_degrade(spec)
    if spec is True or spec == "1" or spec == 1:
        # "1" is the repo-wide "on" spelling, not TCP port 1 (which is
        # privileged and nonsensical here) — it means the default port.
        port = DEFAULT_PORT
    elif isinstance(spec, int) and spec > 0:
        port = spec
    elif isinstance(spec, str) and spec.isdigit():
        port = int(spec)
    else:
        message = (
            f"export spec must be a bool, a port number, or an Exporter; "
            f"got {spec!r}"
        )
        if from_env:
            warnings.warn(
                f"ignoring {_ENV_PORT}={spec!r}: {message} — the live "
                f"export plane stays off",
                stacklevel=2,
            )
            return _active
        raise ValueError(message)
    addr = os.environ.get(_ENV_ADDR) or _DEFAULT_ADDR
    if (
        _active is not None
        and _active.running
        and _active.addr == addr
        and (_active.requested_port == port or _active.port == port)
    ):
        return _active  # idempotent init() replay
    shutdown()
    exp = Exporter(port, addr)
    set_exporter(exp)
    return _start_or_degrade(exp)


def _start_or_degrade(exp: Exporter) -> Exporter | None:
    """Start a configured exporter; on a bind failure (port taken by a
    neighbour process, a crashed job's socket still in TIME_WAIT) warn
    and leave the plane off instead of propagating — every other plane
    degrades when it cannot come up, and a monitoring socket must never
    kill the training job it observes."""
    try:
        exp.start()
    except OSError as exc:
        set_exporter(None)
        warnings.warn(
            f"live export plane disabled: cannot bind "
            f"{exp.addr}:{exp.requested_port} ({exc}) — another process "
            f"on this port? training continues without the exporter",
            stacklevel=3,
        )
        return None
    return exp


def shutdown() -> None:
    """Stop and remove the exporter: socket closed, serving thread
    joined — the port is immediately free for a re-init (the fault-plane
    leak rule; ``telemetry.shutdown()`` calls this first, so a scrape
    never observes a half-torn-down process)."""
    exp = set_exporter(None)
    if exp is not None:
        exp.stop()
