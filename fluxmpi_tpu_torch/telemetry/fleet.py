"""Fleet observability plane: cross-host collector + straggler attribution
(counterpart of :mod:`fluxmpi_tpu.telemetry.fleet`: the same collector,
causes, snapshot schema and wiring; ``scripts/fleet_report.py`` reads its
snapshot bank unchanged).

Every other plane is per-process — each host knows its own goodput,
compile events, and flight-recorder tail, but nobody can answer "which
host is slowing the fleet down, and why". :class:`FleetCollector` is
that cross-host layer: it pulls every host's live-export endpoints
(``/status`` + ``/metrics``, :mod:`~fluxmpi_tpu_torch.telemetry.export`),
joins the per-host signals the other planes already produce, and names
the straggling host per collection interval WITH a cause:

==============  =============================================================
cause           evidence
==============  =============================================================
``desync``      the host's flight-recorder launch sequence froze while the
                fleet's advanced — it is wedged in (or before) a collective
                the others have moved past
                (:func:`~fluxmpi_tpu_torch.telemetry.flight_recorder.diff_dumps`)
``data_stall``  the host's interval badput is dominated by its
                ``data_stall`` goodput bucket — input starvation
``comm_wait``   dominated by eager-collective block time
                (``comm.block_seconds``) — it is waiting on the others
``compute``     neither dominates — the step itself is slow (thermal
                throttle, a sick accelerator, a noisy neighbor)
==============  =============================================================

The attribution ingredients ride surfaces that already exist: the
``fleet`` section of ``/status`` (``train_loop`` posts cumulative
goodput bucket seconds, collective block time, the flight-recorder
sequence, and the update counter at flush boundaries via
``Exporter.note_fleet`` — a dict merge, no new collectives) with the
``goodput`` / ``monitor`` / ``train`` sections and a ``/metrics`` parse
as fallback for hosts that only run the exporter. The collector is
**pull-based and tolerant**: a dead or slow host misses an interval and
shows up as a stale row (per-host last-seen tracking), never an
exception.

Each interval's verdict feeds the anomaly plane's
``persistent_straggler`` rule (same host blamed N consecutive
intervals, :meth:`AnomalyDetector.observe_straggler`) and the closed
``fleet.*`` metric namespace; :meth:`FleetCollector.snapshot` returns
the schema'd fleet model (``fluxmpi_tpu.fleet/v1``) that a
router or coordinator consumes instead of re-scraping, and a JSONL
bank of snapshots replays post-mortem through
``scripts/fleet_report.py``.

Wiring (the standard plane shape): ``init(fleet=...)`` /
``FLUXMPI_TPU_FLEET`` arm the plane (``1`` = collector over
``FLUXMPI_TPU_FLEET_HOSTS``, a path also banks one snapshot line per
interval), ``FLUXMPI_TPU_FLEET_INTERVAL`` sets the poll cadence, and
``telemetry.shutdown()`` resets everything. Zero-cost-when-off:
``train_loop`` resolves :func:`enabled` once per run; fully off, the
per-flush path never touches this module again.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request
import warnings
from typing import Any, Callable

from .registry import MetricsRegistry, get_registry
from .schema import FLEET_SCHEMA, STRAGGLER_CAUSES, validate_status_record

__all__ = [
    "FleetCollector",
    "get_fleet_collector",
    "set_fleet_collector",
    "enabled",
    "configure",
    "shutdown",
]

_ENV_VAR = "FLUXMPI_TPU_FLEET"
_ENV_HOSTS = "FLUXMPI_TPU_FLEET_HOSTS"
_ENV_INTERVAL = "FLUXMPI_TPU_FLEET_INTERVAL"

_DEFAULT_INTERVAL_S = 5.0
_DEFAULT_TIMEOUT_S = 2.0

# The cumulative signals an attribution interval differences. Every one
# is monotone non-decreasing within a run, so interval deltas are
# ``cur - prev`` (a counter reset — restarted host — falls back to
# ``cur``, the cumulative-as-interval reading).
_CUMULATIVE_KEYS = (
    "wall_seconds",
    "step_seconds",
    "data_stall_seconds",
    "host_idle_seconds",
    "comm_block_seconds",
    "updates",
    "flight_seq",
)

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _resolve_target(spec: str) -> str:
    """``host`` or ``host:port`` -> ``host:port`` (default export port)."""
    from .export import DEFAULT_PORT

    spec = spec.strip()
    if not spec:
        raise ValueError("empty fleet host spec")
    if ":" in spec:
        host, port = spec.rsplit(":", 1)
        if not port.isdigit():
            raise ValueError(f"bad port in fleet host spec {spec!r}")
        return f"{host}:{int(port)}"
    return f"{spec}:{DEFAULT_PORT}"


def _parse_metrics_text(text: str) -> list[dict[str, Any]]:
    """Prometheus exposition text -> ``[{name, labels, value}]`` rows,
    series names demangled back to registry names
    (:func:`~fluxmpi_tpu_torch.telemetry.export.exposed_base_name`); foreign
    and malformed lines are skipped — a half-written scrape must not
    kill a collect."""
    from .export import exposed_base_name

    rows: list[dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series_part, _, value_part = line.rpartition(" ")
        if not series_part:
            continue
        try:
            value = float(value_part)
        except ValueError:
            continue
        labels: dict[str, str] = {}
        if "{" in series_part:
            series, _, rest = series_part.partition("{")
            labels = dict(_LABEL_RE.findall(rest.rsplit("}", 1)[0]))
        else:
            series = series_part
        try:
            name = exposed_base_name(series)
        except ValueError:
            continue
        rows.append(
            {"series": series, "name": name, "labels": labels, "value": value}
        )
    return rows


def _num(v: Any) -> float | None:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


class FleetCollector:
    """Pull-based cross-host aggregator + straggler attribution engine.

    Args:
      hosts: scrape targets, each ``host`` or ``host:port`` (default
        port: the exporter's). Order is identity — a target string IS
        the host's name in snapshots, metrics, and anomaly events.
      interval: seconds between automatic collects on :meth:`start`'s
        daemon thread (post-mortem / test callers drive
        :meth:`collect_once` directly instead).
      timeout: per-request HTTP timeout — a slow host costs at most
        this much per endpoint per interval and then reads as stale.
      registry: registry the ``fleet.*`` collector metrics record into
        (default: the process-global one).
      straggler_threshold: flag the slowest host when its per-update
        wall time exceeds this multiple of the other hosts' mean (the
        monitor's straggler factor, applied fleet-side).
      cause_significance: minimum fraction of the straggler's interval
        wall a badput bucket must occupy to be named the cause —
        below it the verdict falls through to ``compute``.
      log: JSONL path; one ``fluxmpi_tpu.fleet/v1`` snapshot line is
        appended per collect (``scripts/fleet_report.py`` replays it).
      detector: anomaly detector fed one
        :meth:`~AnomalyDetector.observe_straggler` verdict per collect
        (default: the process-global one, resolved per collect so a
        later ``init(anomaly=...)`` is picked up).
      clock: wall-clock source for staleness bookkeeping (injectable —
        the watchdog's fake-clock test discipline).
    """

    def __init__(
        self,
        hosts: list[str] | tuple[str, ...] | str,
        *,
        interval: float = _DEFAULT_INTERVAL_S,
        timeout: float = _DEFAULT_TIMEOUT_S,
        registry: MetricsRegistry | None = None,
        straggler_threshold: float = 1.5,
        cause_significance: float = 0.15,
        log: str | None = None,
        detector: Any = None,
        clock: Callable[[], float] = time.time,
    ):
        if isinstance(hosts, str):
            hosts = [h for h in hosts.split(",") if h.strip()]
        self.targets = tuple(_resolve_target(h) for h in hosts)
        if not self.targets:
            raise ValueError("FleetCollector needs at least one host")
        if len(set(self.targets)) != len(self.targets):
            raise ValueError(f"duplicate fleet hosts in {self.targets}")
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        if straggler_threshold <= 1.0:
            raise ValueError(
                f"straggler_threshold must be > 1, got {straggler_threshold}"
            )
        if not 0.0 < cause_significance < 1.0:
            raise ValueError(
                f"cause_significance must be in (0, 1), "
                f"got {cause_significance}"
            )
        self.interval = float(interval)
        self.timeout = float(timeout)
        self._registry = registry
        self.straggler_threshold = float(straggler_threshold)
        self.cause_significance = float(cause_significance)
        self.log = log
        self._detector = detector
        self._clock = clock
        self.collects = 0
        # Per-target scrape memory: last GOOD signals (the delta base),
        # last-seen stamp, and the last scrape's failure reason.
        self._prev: dict[str, dict[str, float]] = {}
        self._last_seen: dict[str, float] = {}
        self._last_error: dict[str, str | None] = {t: None for t in self.targets}
        self._last_row: dict[str, dict[str, Any]] = {}
        self._totals: dict[str, int] = {}
        self._streak_host: str | None = None
        self._streak = 0
        self._snapshot: dict[str, Any] | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "FleetCollector":
        """Start the polling daemon thread (idempotent)."""
        if self.running:
            return self
        self._stop.clear()

        def _poll() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.collect_once()
                except Exception as exc:  # a collect must never die
                    warnings.warn(
                        f"fleet collect failed: {exc!r}", stacklevel=2
                    )

        self._thread = threading.Thread(
            target=_poll, name="fluxmpi-fleet", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the polling thread (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- scraping ------------------------------------------------------

    def _get(self, target: str, path: str) -> bytes:
        with urllib.request.urlopen(
            f"http://{target}{path}", timeout=self.timeout
        ) as resp:
            return resp.read()

    def _scrape(self, target: str) -> tuple[dict[str, float] | None, str | None]:
        """One host's attribution signals, or ``(None, reason)``.
        ``/status`` is the primary source; ``/metrics`` fills whatever
        the status boards did not carry (a host running only the
        exporter still attributes)."""
        try:
            status = json.loads(self._get(target, "/status").decode("utf-8"))
        except Exception as exc:
            return None, f"status unreachable: {exc!r}".replace("\n", " ")
        if validate_status_record(status):
            # A reachable endpoint speaking the wrong schema (version
            # skew, a foreign service on the port) is a bad scrape, not
            # a crash — the host keeps its last good row and goes stale.
            return None, "invalid /status record"
        sig: dict[str, float] = {}
        board = status.get("fleet")
        if isinstance(board, dict):
            for key in _CUMULATIVE_KEYS:
                v = _num(board.get(key))
                if v is not None:
                    sig[key] = v
        gp = status.get("goodput")
        if isinstance(gp, dict):
            buckets = gp.get("buckets")
            if isinstance(buckets, dict):
                for bucket, key in (
                    ("step", "step_seconds"),
                    ("data_stall", "data_stall_seconds"),
                    ("host_idle", "host_idle_seconds"),
                ):
                    v = _num(buckets.get(bucket))
                    if v is not None:
                        sig.setdefault(key, v)
            for src, key in (
                ("wall_seconds", "wall_seconds"),
                ("updates", "updates"),
            ):
                v = _num(gp.get(src))
                if v is not None:
                    sig.setdefault(key, v)
        train = status.get("train")
        if isinstance(train, dict):
            v = _num(train.get("updates"))
            if v is not None:
                sig.setdefault("updates", v)
        monitor = status.get("monitor")
        if isinstance(monitor, dict):
            v = _num(monitor.get("step_seconds_local_mean"))
            if v is not None:
                sig["step_seconds_local_mean"] = v
        missing = [k for k in _CUMULATIVE_KEYS if k not in sig]
        if missing:
            try:
                rows = _parse_metrics_text(
                    self._get(target, "/metrics").decode("utf-8")
                )
            except Exception:
                rows = []  # status alone still makes a (thinner) row
            comm_sum = 0.0
            saw_comm = False
            for row in rows:
                name, labels, value = row["name"], row["labels"], row["value"]
                if (
                    name == "comm.block_seconds"
                    and row["series"].endswith("_sum")
                ):
                    comm_sum += value
                    saw_comm = True
                elif name == "goodput.bucket_seconds":
                    bucket = labels.get("bucket")
                    key = {
                        "step": "step_seconds",
                        "data_stall": "data_stall_seconds",
                        "host_idle": "host_idle_seconds",
                    }.get(bucket or "")
                    if key:
                        sig.setdefault(key, value)
                elif name == "goodput.wall_seconds":
                    sig.setdefault("wall_seconds", value)
                elif name == "goodput.updates":
                    sig.setdefault("updates", value)
                elif name == "monitor.step_seconds_local_mean":
                    sig.setdefault("step_seconds_local_mean", value)
            if saw_comm:
                sig.setdefault("comm_block_seconds", comm_sum)
        # Identity riders for the census row (not attribution inputs).
        sig["_process"] = float(status.get("process", 0))
        self._last_row[target] = {
            "process": status.get("process"),
            "run_id": status.get("run_id"),
            "updates": sig.get("updates"),
            "step_seconds_local_mean": sig.get("step_seconds_local_mean"),
            "flight_seq": sig.get("flight_seq"),
        }
        return sig, None

    # -- attribution ---------------------------------------------------

    def _deltas(
        self, target: str, sig: dict[str, float]
    ) -> dict[str, float]:
        """Interval deltas of the cumulative signals vs the previous
        good scrape; first scrape (or counter reset) reads the
        cumulative values as one interval from zero."""
        prev = self._prev.get(target)
        out: dict[str, float] = {}
        for key in _CUMULATIVE_KEYS:
            cur = sig.get(key)
            if cur is None:
                continue
            base = prev.get(key) if prev else None
            out[key] = cur - base if base is not None and base <= cur else cur
        out["_first"] = 0.0 if prev else 1.0
        return out

    def _attribute(
        self, fresh: dict[str, dict[str, float]]
    ) -> dict[str, Any]:
        """One interval's verdict from the fresh hosts' signals: the
        straggling target (or None), its cause, and the step-time skew
        that convicted it."""
        deltas = {t: self._deltas(t, sig) for t, sig in fresh.items()}
        seq_lag: float | None = None
        seqs = {
            t: fresh[t]["flight_seq"]
            for t in fresh
            if "flight_seq" in fresh[t]
        }
        if len(seqs) >= 2:
            from .flight_recorder import diff_dumps

            # Synthetic minimal dumps: targets are distinct hosts by
            # construction, but their /status process indices can
            # collide (every single-process virtual host reports 0), so
            # each target gets a synthetic index and diff_dumps does the
            # lag math on sequence numbers alone.
            order = sorted(seqs)
            diff = diff_dumps(
                [
                    {"process": i, "sequence": int(seqs[t]), "entries": []}
                    for i, t in enumerate(order)
                ]
            )
            seq_lag = float(diff["max_sequence"] - diff["min_sequence"])
            # Desync: a host whose launch sequence FROZE across the
            # interval while the fleet's advanced is wedged in (or
            # before) a collective the others moved past. Judged on
            # deltas only — differing absolute counts are normal
            # (restarts, late joiners), a frozen counter is not.
            frozen = [
                t
                for t in order
                if deltas[t].get("_first") == 0.0
                and deltas[t].get("flight_seq") == 0.0
            ]
            advanced = any(deltas[t].get("flight_seq", 0.0) > 0 for t in order)
            if frozen and advanced:
                wedged = min(frozen, key=lambda t: seqs[t])
                return {
                    "straggler": wedged,
                    "cause": "desync",
                    "skew": None,
                    "seq_lag": seq_lag,
                }
        # Per-update wall time per host, interval deltas preferred; when
        # the interval saw no progress anywhere (a post-mortem scrape of
        # finished runs, or everyone wedged), fall back to cumulative
        # rates so a one-shot collect still attributes.
        def rates(rows: dict[str, dict[str, float]]) -> dict[str, float]:
            out = {}
            for t, row in rows.items():
                wall, ups = row.get("wall_seconds"), row.get("updates")
                if wall is not None and ups is not None and ups > 0 and wall > 0:
                    out[t] = wall / ups
            return out

        per_update = rates(deltas)
        basis = deltas
        if len(per_update) < 2:
            basis = fresh
            per_update = rates(fresh)
        if len(per_update) < 2:
            return {
                "straggler": None, "cause": None, "skew": None,
                "seq_lag": seq_lag,
            }
        worst = max(per_update, key=lambda t: per_update[t])
        others = [v for t, v in per_update.items() if t != worst]
        mean_others = sum(others) / len(others)
        if mean_others <= 0:
            return {
                "straggler": None, "cause": None, "skew": None,
                "seq_lag": seq_lag,
            }
        skew = per_update[worst] / mean_others
        if skew < self.straggler_threshold:
            return {
                "straggler": None, "cause": None, "skew": skew,
                "seq_lag": seq_lag,
            }
        row = basis[worst]
        wall = row.get("wall_seconds") or 0.0
        stall_frac = (row.get("data_stall_seconds") or 0.0) / wall
        comm_frac = (row.get("comm_block_seconds") or 0.0) / wall
        if stall_frac >= self.cause_significance and stall_frac >= comm_frac:
            cause = "data_stall"
        elif comm_frac >= self.cause_significance:
            cause = "comm_wait"
        else:
            cause = "compute"
        return {
            "straggler": worst, "cause": cause, "skew": skew,
            "seq_lag": seq_lag,
        }

    # -- collection ----------------------------------------------------

    def collect_once(self) -> dict[str, Any]:
        """One collection interval: scrape every target, attribute,
        record ``fleet.*`` metrics, feed the anomaly rule, bank the
        snapshot line, and return the snapshot
        (schema ``fluxmpi_tpu.fleet/v1``)."""
        t0 = time.perf_counter()
        fresh: dict[str, dict[str, float]] = {}
        for target in self.targets:
            sig, err = self._scrape(target)
            self._last_error[target] = err
            if sig is not None:
                fresh[target] = sig
                self._last_seen[target] = self._clock()
        verdict = self._attribute(fresh) if fresh else {
            "straggler": None, "cause": None, "skew": None, "seq_lag": None,
        }
        # The delta base advances only AFTER attribution differenced
        # against the old base.
        for target, sig in fresh.items():
            self._prev[target] = {
                k: v for k, v in sig.items() if k in _CUMULATIVE_KEYS
            }
        now = self._clock()
        hosts: dict[str, Any] = {}
        for target in self.targets:
            seen = self._last_seen.get(target)
            row: dict[str, Any] = {
                "target": target,
                "alive": target in fresh,
                "stale_seconds": (now - seen) if seen is not None else None,
                "error": self._last_error[target],
            }
            row.update(self._last_row.get(target, {}))
            hosts[target] = row
        straggler, cause = verdict["straggler"], verdict["cause"]
        if straggler is not None:
            if straggler == self._streak_host:
                self._streak += 1
            else:
                self._streak_host, self._streak = straggler, 1
            self._totals[cause] = self._totals.get(cause, 0) + 1
        else:
            self._streak_host, self._streak = None, 0
        with self._lock:
            self.collects += 1
            snapshot = {
                "schema": FLEET_SCHEMA,
                "time_unix": now,
                "collects": self.collects,
                "interval_seconds": self.interval,
                "hosts": hosts,
                "attribution": {
                    "straggler": straggler,
                    "cause": cause,
                    "skew": verdict["skew"],
                    "flight_seq_lag": verdict["seq_lag"],
                    "streak": self._streak,
                },
                "stragglers": dict(self._totals),
            }
            self._snapshot = snapshot
        self._record(snapshot, time.perf_counter() - t0)
        self._observe(straggler)
        self._note_board(snapshot)
        if self.log:
            try:
                with open(self.log, "a", encoding="utf-8") as f:
                    f.write(json.dumps(snapshot) + "\n")
            except OSError as exc:
                warnings.warn(
                    f"fleet snapshot bank write failed: {exc!r}", stacklevel=2
                )
        return snapshot

    def snapshot(self) -> dict[str, Any] | None:
        """The last collected fleet model (``fluxmpi_tpu.fleet/v1``),
        or None before the first collect — the read API a router or
        coordinator consumes instead of re-scraping the fleet."""
        with self._lock:
            return dict(self._snapshot) if self._snapshot else None

    def _record(self, snapshot: dict[str, Any], seconds: float) -> None:
        reg = self._registry if self._registry is not None else get_registry()
        if not getattr(reg, "enabled", True):
            return
        hosts = snapshot["hosts"]
        reg.gauge("fleet.hosts").set(float(len(hosts)))
        reg.gauge("fleet.hosts_stale").set(
            float(sum(1 for h in hosts.values() if not h["alive"]))
        )
        reg.histogram("fleet.collect_seconds").observe(seconds)
        attr = snapshot["attribution"]
        if attr["flight_seq_lag"] is not None:
            reg.gauge("fleet.flight_seq_lag").set(attr["flight_seq_lag"])
        if attr["cause"] is not None:
            reg.counter(
                "fleet.straggler_intervals", cause=attr["cause"]
            ).inc()

    def _observe(self, straggler: str | None) -> None:
        det = self._detector
        if det is None:
            from . import anomaly as _anomaly

            det = _anomaly.get_anomaly_detector()
        if det is None:
            return
        try:
            det.observe_straggler(straggler)
        except Exception as exc:  # the rule must never kill a collect
            warnings.warn(
                f"fleet straggler rule failed: {exc!r}", stacklevel=2
            )

    def _note_board(self, snapshot: dict[str, Any]) -> None:
        """Post the verdict to the local exporter's FLEET board (when
        one is running) so ``fluxmpi_top`` renders attribution from the
        same ``/status`` surface everything else uses."""
        from . import export as _export

        exp = _export.get_exporter()
        if exp is None:
            return
        attr = snapshot["attribution"]
        exp.note_fleet(
            hosts=len(snapshot["hosts"]),
            hosts_stale=sum(
                1 for h in snapshot["hosts"].values() if not h["alive"]
            ),
            straggler=attr["straggler"],
            cause=attr["cause"],
            skew=attr["skew"],
            streak=attr["streak"],
            collects=snapshot["collects"],
        )


# ---------------------------------------------------------------------------
# Module wiring (init kwarg / env var) — the standard plane shape: a
# process-global collector, configure() from a one-value spec, shutdown()
# so no thread or verdict leaks across init cycles.
# ---------------------------------------------------------------------------

_enabled = False
_collector: FleetCollector | None = None
_lock = threading.Lock()


def enabled() -> bool:
    """Is the fleet plane armed on this process? ``train_loop`` and the
    monitor resolve this once per run: True means post the per-flush
    attribution ingredients (``Exporter.note_fleet``) and compute the
    cross-host skew gauges on the existing monitor gather."""
    return _enabled


def get_fleet_collector() -> FleetCollector | None:
    """The installed collector, or None (armed hosts that only produce
    ingredients have no collector — one process runs it for the fleet)."""
    return _collector


def set_fleet_collector(
    collector: FleetCollector | None,
) -> FleetCollector | None:
    """Swap the installed collector (returns the previous one)."""
    global _collector
    with _lock:
        prev, _collector = _collector, collector
    return prev


def _env_interval() -> float:
    raw = os.environ.get(_ENV_INTERVAL)
    if raw is None or raw == "":
        return _DEFAULT_INTERVAL_S
    try:
        interval = float(raw)
        if interval <= 0:
            raise ValueError(raw)
    except ValueError:
        # Env typo: warn and run with the default — a misspelled knob
        # must not take down training (the configure() contract).
        warnings.warn(
            f"ignoring invalid {_ENV_INTERVAL}={raw!r} "
            f"(want seconds > 0); using {_DEFAULT_INTERVAL_S:g}",
            stacklevel=3,
        )
        return _DEFAULT_INTERVAL_S
    return interval


def _default_hosts() -> str:
    hosts = os.environ.get(_ENV_HOSTS)
    if hosts:
        return hosts
    # No fleet list: the local exporter is the whole "fleet" — the
    # single-host arming still yields staleness tracking and the bank.
    from .export import DEFAULT_PORT, get_exporter

    exp = get_exporter()
    port = exp.port if exp is not None and exp.running else DEFAULT_PORT
    return f"127.0.0.1:{port}"


def configure(spec: Any = None) -> FleetCollector | None:
    """Wire the fleet plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_FLEET`` (same forms; no-op when
      unset/empty);
    - ``False`` / ``"0"`` — disarm: stop and uninstall any collector;
    - ``True`` / ``"1"`` — arm the plane; process 0 also starts a
      :class:`FleetCollector` over ``FLUXMPI_TPU_FLEET_HOSTS`` (comma
      list; default: the local exporter) at
      ``FLUXMPI_TPU_FLEET_INTERVAL`` seconds;
    - a path string — like ``"1"``, and the collector banks one
      snapshot JSONL line per interval there;
    - a :class:`FleetCollector` — install it and start its thread.

    Called by ``fluxmpi_tpu_torch.init(fleet=...)``; idempotent — re-arming
    with a collector already installed keeps the running instance.
    """
    global _enabled
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _collector
    if spec is False or spec == "0":
        shutdown()
        return None
    if isinstance(spec, FleetCollector):
        prev = set_fleet_collector(spec)
        if prev is not None and prev is not spec:
            prev.stop()
        _enabled = True
        spec.start()
        return spec
    if spec is True or spec == "1" or isinstance(spec, str):
        _enabled = True
        if _collector is not None:
            return _collector  # idempotent replay keeps the instance
        from .registry import process_index_or_zero

        if process_index_or_zero() != 0:
            # Ingredient-only arming: every host posts its per-flush
            # signals, exactly one (process 0) runs the scrape loop.
            return None
        log = spec if isinstance(spec, str) and spec not in ("1",) else None
        collector = FleetCollector(
            _default_hosts(), interval=_env_interval(), log=log
        )
        set_fleet_collector(collector)
        collector.start()
        return collector
    raise ValueError(
        f"fleet spec must be a bool, '0'/'1', a snapshot-bank path, or a "
        f"FleetCollector; got {spec!r}"
    )


def shutdown() -> None:
    """Disarm the plane: stop the collector thread, uninstall it, and
    drop every verdict/streak (the fault-plane leak rule — a straggler
    streak must not survive into the next run's first interval)."""
    global _enabled
    _enabled = False
    prev = set_fleet_collector(None)
    if prev is not None:
        prev.stop()
