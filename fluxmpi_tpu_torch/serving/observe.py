"""Serving request-observability plane (counterpart of
:mod:`fluxmpi_tpu.serving.observe`): lifecycle traces, the request log,
KV-pool forensics, and SLO burn accounting.

The engine's aggregate histograms (TTFT, per-token, queue wait) say how
the service does on average; this plane says *which* request was slow,
*why* one was rejected, *who* holds the KV pool, and *how fast* the error
budget burns. One :class:`RequestObserver` carries three surfaces:

- **per-request lifecycle tracing**: every request that reaches a
  terminal state emits its span chain (``request.queue`` ->
  ``request.prefill`` -> ``request.decode`` -> ``request.done`` /
  ``request.rejected``) onto the :mod:`~fluxmpi_tpu_torch.telemetry.tracing`
  ring, each on its own virtual track (``request <id>``), and one
  ``fluxmpi_tpu.request/v1`` JSONL line (timings, token counts,
  reject/finish reason, KV blocks held, SLO verdict) in the
  :class:`RequestLog`. ``scripts/serving_report.py`` aggregates the log
  and ``scripts/check_metrics_schema.py`` validates every line;
- **KV-pool forensics**: :meth:`RequestObserver.kv_debug` snapshots the
  pool (occupancy, high watermark, free-list fragmentation) and a census
  of the top-N sequences by blocks held; on the first load-shed
  (``queue_full``) :meth:`RequestObserver.maybe_write_bundle` folds it
  into a watchdog-dump record (``fluxmpi_serving.<process>.json``);
- **SLO burn accounting**: :class:`SLOBurnTracker` keeps good/total over
  a short and a long rolling window (alert only when both burn). The
  engine sets the ``serving.slo_burn_rate{window=}`` gauges from it.
  (The JAX package also feeds :meth:`SLOBurnTracker.alert_rate` to its
  anomaly plane's ``slo_burn`` rule and :meth:`RequestObserver.board` to
  its exporter's status board; the port has neither plane yet.)

Wiring follows the package convention: ``init(request_log=...)`` /
``FLUXMPI_TPU_REQUEST_LOG`` (``1`` = on without a file; a path = on + JSONL
there, ``{process}`` formatted per process); ``FLUXMPI_TPU_SLO_WINDOW``
sets the long burn window in seconds; bundles land in
``FLUXMPI_TPU_ANOMALY_DIR``. The engine resolves
:func:`get_request_observer` once per run; with none installed the
per-request path reads one attribute. ``telemetry.shutdown()`` resets the
plane.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

from ..telemetry import tracing
from ..telemetry.registry import process_index_or_zero as _process_index
from ..telemetry.schema import REQUEST_SCHEMA

__all__ = [
    "RequestLog",
    "SLOBurnTracker",
    "RequestObserver",
    "get_request_observer",
    "set_request_observer",
    "configure",
    "shutdown",
]

_ENV_VAR = "FLUXMPI_TPU_REQUEST_LOG"
_ENV_WINDOW = "FLUXMPI_TPU_SLO_WINDOW"
_ENV_DIR = "FLUXMPI_TPU_ANOMALY_DIR"  # debug bundles share the anomaly dir

_DEFAULT_WINDOW = 300.0
# Long : short window ratio — the classic SRE pairing (1h/5m) scaled to
# a serving run's lifetime; both windows must burn for the alert.
_WINDOW_RATIO = 12.0
_DEFAULT_SLO_TARGET = 0.99

# Process-unique request ids: the track key every span/record carries.
_request_ids = itertools.count()


def next_request_id() -> int:
    """The next process-unique request id (monotonic, never reused —
    a request's Perfetto track and JSONL records key on it)."""
    return next(_request_ids)


def _env_window() -> float | None:
    """``FLUXMPI_TPU_SLO_WINDOW`` in seconds; garbage warns and falls
    back to the default (the env warn-and-degrade convention)."""
    raw = os.environ.get(_ENV_WINDOW)
    if raw is None or raw == "":
        return None
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if val <= 0.0:
        warnings.warn(
            f"ignoring {_ENV_WINDOW}={raw!r}: must be a positive number "
            f"of seconds — the default window ({_DEFAULT_WINDOW:g}s) "
            f"stays in effect",
            stacklevel=3,
        )
        return None
    return val


class RequestLog:
    """Append-only JSONL sink for per-request terminal records.

    ``path`` may contain ``{process}`` (formatted with the process
    index — the multi-host spelling, like the trace export path). The
    file opens lazily on the first write and every line is flushed —
    a post-mortem after a crash must not lose the tail. Write failures
    warn once and count (:attr:`errors`); observability must never
    kill serving.
    """

    def __init__(self, path: str):
        self.path_spec = str(path)
        try:
            self.path = self.path_spec.format(process=_process_index())
        except (KeyError, IndexError, ValueError) as exc:
            raise ValueError(
                f"request log path {path!r} is not formattable: {exc!r} "
                f"(only a {{process}} placeholder is supported)"
            ) from None
        self._file: Any = None
        self._lock = threading.Lock()
        self.written = 0
        self.errors = 0

    def write(self, record: dict[str, Any]) -> None:
        with self._lock:
            try:
                if self._file is None:
                    parent = os.path.dirname(self.path)
                    if parent:
                        os.makedirs(parent, exist_ok=True)
                    self._file = open(self.path, "a", encoding="utf-8")
                self._file.write(
                    json.dumps(record, separators=(",", ":")) + "\n"
                )
                self._file.flush()
                self.written += 1
            except Exception as exc:
                self.errors += 1
                if self.errors == 1:
                    warnings.warn(
                        f"request log write to {self.path!r} failed: "
                        f"{exc!r}; further failures are counted silently",
                        stacklevel=3,
                    )

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except Exception:
                    pass
                self._file = None


class SLOBurnTracker:
    """Multi-window rolling SLO burn rate (the SRE burn-alert shape).

    Every terminal request is one good/bad observation; ``bad`` means
    rejected or SLO-violating. The burn rate over a window is the bad
    fraction divided by the error budget (``1 - slo_target``): 1.0 =
    the budget is consumed exactly as fast as it accrues, >1 = the
    service will exhaust it. :meth:`alert_rate` is the MIN across the
    short and long windows — both must burn (multi-window AND), so a
    single slow request cannot page and a sustained regression cannot
    hide behind a long quiet average.

    Args:
      window: the long window in seconds (default
        ``FLUXMPI_TPU_SLO_WINDOW`` or 300); the short window is
        ``window / 12`` (the 1h/5m SRE ratio).
      slo_target: the good-fraction objective in (0, 1); the error
        budget is its complement.
      clock: monotonic time source (injectable for tests).
    """

    def __init__(
        self,
        *,
        window: float | None = None,
        slo_target: float = _DEFAULT_SLO_TARGET,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window is None:
            window = _env_window() or _DEFAULT_WINDOW
        window = float(window)
        if window <= 0.0:
            raise ValueError(f"window must be > 0 seconds, got {window}")
        if not 0.0 < slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {slo_target}"
            )
        self.windows: tuple[float, ...] = (window / _WINDOW_RATIO, window)
        self.slo_target = float(slo_target)
        self._clock = clock
        self._events: deque[tuple[float, bool]] = deque()
        self.good = 0
        self.total = 0

    @property
    def budget(self) -> float:
        return 1.0 - self.slo_target

    def observe(self, good: bool) -> None:
        now = self._clock()
        self._events.append((now, bool(good)))
        self.total += 1
        self.good += int(bool(good))
        horizon = now - self.windows[-1]
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def counts(self, window: float) -> tuple[int, int]:
        """``(good, total)`` inside the trailing ``window`` seconds."""
        cutoff = self._clock() - float(window)
        good = total = 0
        for t, g in reversed(self._events):
            if t < cutoff:
                break
            total += 1
            good += int(g)
        return good, total

    def burn_rate(self, window: float | None = None) -> float:
        """Bad fraction over the window divided by the error budget;
        0.0 with no data (an idle service burns nothing)."""
        good, total = self.counts(
            window if window is not None else self.windows[-1]
        )
        if total == 0:
            return 0.0
        return (1.0 - good / total) / self.budget

    def burn_rates(self) -> dict[float, float]:
        return {w: self.burn_rate(w) for w in self.windows}

    def alert_rate(self) -> float | None:
        """The multi-window alert value: the MIN burn rate across the
        windows, or None until every window has at least one
        observation (nothing to alert on)."""
        rates = []
        for w in self.windows:
            _, total = self.counts(w)
            if total == 0:
                return None
            rates.append(self.burn_rate(w))
        return min(rates)

    def reset(self) -> None:
        self._events.clear()
        self.good = 0
        self.total = 0


class RequestObserver:
    """The request-observability plane object the engine resolves once
    per run: terminal-record logging, span emission, burn tracking,
    offender accounting, and the KV debug bundle.

    Args:
      path: JSONL request-log path (``{process}`` formatted per host);
        None = no file log (spans/burn/forensics still on).
      log: a pre-built :class:`RequestLog` (overrides ``path``).
      slo_window / slo_target: burn-tracker knobs (see
        :class:`SLOBurnTracker`).
      top_offenders: how many worst-TTFT requests / biggest block
        holders the board and census carry.
      dump_dir: where the serving debug bundle lands (default
        ``FLUXMPI_TPU_ANOMALY_DIR`` or ``.`` — the bundle family
        shares the anomaly plane's directory).
      dump: write bundles at all.
      clock: burn-tracker time source (injectable for tests).
    """

    def __init__(
        self,
        *,
        path: str | None = None,
        log: RequestLog | None = None,
        slo_window: float | None = None,
        slo_target: float = _DEFAULT_SLO_TARGET,
        top_offenders: int = 5,
        dump_dir: str | None = None,
        dump: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.log = log if log is not None else (
            RequestLog(path) if path else None
        )
        self.burn = SLOBurnTracker(
            window=slo_window, slo_target=slo_target, clock=clock
        )
        self.enabled = True
        self.top_offenders = int(top_offenders)
        self.dump_dir = (
            dump_dir if dump_dir is not None
            else os.environ.get(_ENV_DIR, ".")
        )
        self.dump = dump
        self.records = 0
        self.last_dump_path: str | None = None
        self._dumped = False
        self._lock = threading.Lock()
        # Rolling TTFT sample for the board's p50/p99 (bounded — the
        # registry histogram owns the exact cumulative buckets).
        self._ttfts: deque[float] = deque(maxlen=512)
        self._offenders: list[tuple[float, int]] = []  # (ttft, id), worst first

    # -- terminal records ----------------------------------------------

    def build_record(
        self,
        req: Any,
        *,
        kv_blocks: int = 0,
        violations: tuple[str, ...] = (),
    ) -> dict[str, Any]:
        """One ``fluxmpi_tpu.request/v1`` record from a terminal
        request handle (see :func:`~fluxmpi_tpu_torch.telemetry.schema.validate_request_record`)."""
        status = "finished" if req.status == "finished" else "rejected"
        total_s = (
            req.finished_t - req.submitted_t
            if req.finished_t is not None else None
        )
        return {
            "schema": REQUEST_SCHEMA,
            "time_unix": time.time(),
            "process": _process_index(),
            "request_id": int(req.id),
            "status": status,
            "reason": req.reject_reason,
            "prompt_tokens": int(req.prompt.shape[0]),
            "output_tokens": len(req.tokens),
            "kv_blocks": int(kv_blocks),
            "queue_wait_s": req.queue_wait_s,
            "ttft_s": req.ttft_s,
            "per_token_s": req.per_token_s,
            "total_s": total_s,
            "slo_ok": bool(status == "finished" and not violations),
            "slo_violations": list(violations),
        }

    def observe_terminal(
        self,
        req: Any,
        *,
        kv_blocks: int = 0,
        violations: tuple[str, ...] = (),
    ) -> dict[str, Any]:
        """Bank one request's terminal transition: JSONL record, span
        chain, burn observation, offender accounting. Called by the
        engine exactly once per request (finish, reject, or drain)."""
        record = self.build_record(
            req, kv_blocks=kv_blocks, violations=violations
        )
        with self._lock:
            self.records += 1
            if req.ttft_s is not None:
                self._ttfts.append(float(req.ttft_s))
                self._offenders.append((float(req.ttft_s), int(req.id)))
                self._offenders.sort(reverse=True)
                del self._offenders[self.top_offenders:]
        self.burn.observe(record["slo_ok"])
        if self.log is not None:
            self.log.write(record)
        self._emit_spans(req, record)
        return record

    def _emit_spans(self, req: Any, record: dict[str, Any]) -> None:
        """The lifecycle span chain, one virtual track per request.
        Stamps are ``perf_counter`` seconds (the engine clock), exactly
        what :meth:`Tracer.add_complete_event` rebases at export."""
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            return
        rid = int(req.id)
        tracer.name_track(rid, f"request {rid}")
        end = req.finished_t if req.finished_t is not None else req._clock()
        queue_end = req.admitted_t if req.admitted_t is not None else end
        tracer.add_complete_event(
            "request.queue", req.submitted_t, queue_end,
            track=rid, request_id=rid,
        )
        if req.admitted_t is not None:
            prefill_end = (
                req.first_token_t if req.first_token_t is not None else end
            )
            tracer.add_complete_event(
                "request.prefill", req.admitted_t, prefill_end,
                track=rid, request_id=rid,
                prompt_tokens=record["prompt_tokens"],
            )
            if req.first_token_t is not None:
                tracer.add_complete_event(
                    "request.decode", req.first_token_t, end,
                    track=rid, request_id=rid,
                    tokens=record["output_tokens"],
                )
        if record["status"] == "finished":
            tracer.instant(
                "request.done", track=rid, request_id=rid,
                slo_ok=record["slo_ok"],
            )
        else:
            tracer.instant(
                "request.rejected", track=rid, request_id=rid,
                reason=record["reason"] or "",
            )

    # -- board / percentiles -------------------------------------------

    def ttft_percentiles(self) -> tuple[float | None, float | None]:
        """(p50, p99) over the rolling TTFT sample (None with no data)."""
        with self._lock:
            data = sorted(self._ttfts)
        if not data:
            return None, None

        def pct(p: float) -> float:
            return data[min(len(data) - 1, int(p * (len(data) - 1) + 0.5))]

        return pct(0.50), pct(0.99)

    def top_offender_list(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {"request_id": rid, "ttft_s": t}
                for t, rid in self._offenders
            ]

    def board(self) -> dict[str, Any]:
        """The SERVING status-board fields this plane contributes (what
        the JAX package's exporter shows beside the engine's counts)."""
        p50, p99 = self.ttft_percentiles()
        rates = self.burn.burn_rates()
        return {
            "burn_rate": max(rates.values()) if rates else 0.0,
            "burn_windows": {f"{w:g}": r for w, r in rates.items()},
            "ttft_p50": p50,
            "ttft_p99": p99,
            "top_offenders": self.top_offender_list(),
            "requests_logged": self.records,
        }

    # -- KV-pool forensics ---------------------------------------------

    def kv_debug(self, engine: Any) -> dict[str, Any]:
        """Pool forensics snapshot: occupancy, high watermark,
        fragmentation, and the census of the top-N sequences by blocks
        held (engine-side — the cache does not map blocks to
        sequences, the slots do)."""
        cache = engine.cache
        census = []
        for slot in engine._slots:
            if slot is None:
                continue
            census.append(
                {
                    "request_id": int(slot.req.id),
                    "blocks": len(slot.blocks),
                    "position": int(slot.position),
                    "generated": int(slot.generated),
                }
            )
        census.sort(key=lambda e: (-e["blocks"], e["request_id"]))
        total = cache.num_blocks - 1
        return {
            "blocks_total": total,
            "blocks_in_use": cache.used_blocks,
            "blocks_free": cache.free_blocks,
            "high_watermark_blocks": cache.high_watermark_blocks,
            "fragmentation": cache.fragmentation,
            # NOT engine.queue_depth: that property takes the engine
            # lock, and the queue_full bundle trigger fires from
            # _reject UNDER submit's lock — a torn len() is fine for
            # forensics, a deadlock is not.
            "queue_depth": len(engine._queue),
            "census": census[: self.top_offenders],
            "burn_rates": {
                f"{w:g}": r for w, r in self.burn.burn_rates().items()
            },
        }

    def dump_path(self) -> str:
        return os.path.join(
            self.dump_dir or ".",
            f"fluxmpi_serving.{_process_index()}.json",
        )

    def write_bundle(self, engine: Any, trigger: str) -> str:
        """Write the OOM-style serving debug bundle and return its
        path: the watchdog-dump record (thread stacks, flight-recorder
        tail, open spans, registry flush) with a ``serving`` section —
        the pool census — attached, so triage tooling for hang dumps
        reads it unchanged."""
        from ..telemetry.watchdog import Watchdog, get_watchdog

        wd = get_watchdog()
        if wd is None:
            # An unarmed watchdog: build_dump never starts threads or
            # installs signals — it only assembles the record.
            wd = Watchdog(deadline=1.0)
        record = wd.build_dump(f"serving:{trigger}")
        record["serving"] = self.kv_debug(engine)
        path = self.dump_path()
        os.makedirs(self.dump_dir or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1)
        self.last_dump_path = path
        return path

    def maybe_write_bundle(self, engine: Any, trigger: str) -> str | None:
        """Rate-limited bundle write (once per observer lifetime): the
        first load-shed explains the pool, later ones repeat it."""
        if not self.dump or self._dumped:
            return None
        self._dumped = True
        try:
            return self.write_bundle(engine, trigger)
        except Exception as exc:  # diagnostics must never kill serving
            warnings.warn(
                f"serving debug bundle write failed: {exc!r}",
                stacklevel=3,
            )
            return None

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Full reset: log closed, burn tracker and samples cleared —
        the fault-plane leak rule (``telemetry.shutdown()`` path)."""
        self.enabled = False
        if self.log is not None:
            self.log.close()
        self.burn.reset()
        with self._lock:
            self._ttfts.clear()
            self._offenders.clear()


# ---------------------------------------------------------------------------
# Plane wiring (init kwarg / env var)
# ---------------------------------------------------------------------------

_active: RequestObserver | None = None
_active_lock = threading.Lock()


def get_request_observer() -> RequestObserver | None:
    """The installed observer, if any (None = plane off)."""
    return _active


def set_request_observer(
    observer: RequestObserver | None,
) -> RequestObserver | None:
    """Install (or, with None, remove) the process request observer;
    returns the previous one."""
    global _active
    with _active_lock:
        prev, _active = _active, observer
    return prev


def configure(spec: Any = None) -> RequestObserver | None:
    """Wire the request-observability plane from a one-value spec
    (mirror of :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_REQUEST_LOG`` (same forms; no-op
      when unset/empty);
    - ``False`` / ``"0"`` — uninstall (log closed, burn cleared);
    - ``True`` / ``"1"`` — install with no file log (spans, burn
      accounting, and forensics still on);
    - any other string — install logging terminal records to that JSONL
      path (``{process}`` formatted with the process index);
    - a :class:`RequestObserver` — install it.

    Called by ``fluxmpi_tpu_torch.init(request_log=...)``; idempotent — an
    installed observer is kept (with its burn windows) on a replay with
    an equivalent spec. A malformed env path warns and degrades;
    the same mistake made programmatically raises.
    """
    from_env = spec is None
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _active
    if isinstance(spec, RequestObserver):
        if _active is not None and _active is not spec:
            _active.close()
        spec.enabled = True
        set_request_observer(spec)
        return spec
    if spec is False or spec == "0":
        shutdown()
        return None
    if spec is True or spec == "1":
        if _active is not None:
            _active.enabled = True
            return _active
        obs = RequestObserver()
        set_request_observer(obs)
        return obs
    if isinstance(spec, str):
        if (
            _active is not None
            and _active.log is not None
            and _active.log.path_spec == spec
        ):
            _active.enabled = True
            return _active
        try:
            obs = RequestObserver(path=spec)
        except ValueError as exc:
            if from_env:
                warnings.warn(
                    f"ignoring {_ENV_VAR}={spec!r}: {exc} — the request "
                    f"log stays off",
                    stacklevel=2,
                )
                return _active
            raise
        if _active is not None:
            _active.close()
        set_request_observer(obs)
        return obs
    raise ValueError(
        f"request_log spec must be a bool, '0'/'1', a path, or a "
        f"RequestObserver; got {spec!r}"
    )


def shutdown() -> None:
    """Reset the plane: close the request log, clear the burn tracker,
    uninstall — state left armed would leak into the next init cycle
    (the fault-plane leak rule)."""
    obs = set_request_observer(None)
    if obs is not None:
        try:
            obs.close()
        except Exception:
            pass
