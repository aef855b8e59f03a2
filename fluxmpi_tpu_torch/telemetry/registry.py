"""Lightweight labeled metrics registry (counterpart of
:mod:`fluxmpi_tpu.telemetry.registry`, the same instruments and records).

The measurement substrate under everything in this package: eager
collectives (:mod:`fluxmpi_tpu_torch.comm`), the train-step ``metrics=`` hook
(:func:`fluxmpi_tpu_torch.parallel.make_train_step`), the data loader, the
checkpoints, and :class:`~fluxmpi_tpu_torch.telemetry.monitor.TrainingMonitor`
all record through one of these.

Design constraints (why not a prometheus client):

- the hot-path cost of an update must be a couple of dict/float ops —
  instrumentation that costs more than ~1% of an eager collective or a
  train-step dispatch would get turned off and lie by omission;
- no background threads, no sockets: records leave the process only at
  explicit :meth:`MetricsRegistry.flush`, one JSONL line per flush, so a
  training loop's metrics stream is replayable and diffable;
- counters are cumulative and monotonic (rates are a consumer-side
  derivative), gauges hold the last set value, histograms keep running
  count/sum/min/max/last — enough for throughput, latency, and straggler
  questions without reservoir bookkeeping.

Instrument updates are lock-free: CPython dict/float ops under the GIL
are atomic enough for statistics, and every producer in this repo drives
a given instrument from one thread. Instrument *creation* and flush take
the registry lock.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Iterable

from .schema import HISTOGRAM_BUCKET_EDGES, SCHEMA

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "process_index_or_zero",
]


def process_index_or_zero() -> int:
    """Process index for stamping records, without initializing
    anything: the rank of the ``torch.distributed`` world once a process
    group is up, else 0 (a record made before the world exists is
    single-process by definition). Shared by every record producer in
    this package (registry flushes, trace exports, flight/watchdog
    dumps)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


class Counter:
    """Cumulative, monotonically increasing value (calls, bytes, steps)."""

    kind = "counter"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "type": self.kind,
            "labels": self.labels,
            "value": self.value,
        }


class Gauge:
    """Point-in-time value (loss, queue depth, bytes in use)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def snapshot(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "type": self.kind,
            "labels": self.labels,
            "value": self.value,
        }


class Histogram:
    """Running distribution summary: count/sum/min/max/last, plus —
    for the latency names with edges declared in
    ``schema.HISTOGRAM_BUCKET_EDGES`` — fixed cumulative buckets.

    The summary stats answer "how slow, how spread, how recent" and
    min/max bound the tail exactly (what straggler detection needs);
    the schema-declared buckets are what PromQL ``histogram_quantile``
    needs, exposed by the live exporter as ``_bucket{le=...}`` series.
    Names without declared edges stay bucket-free — no reservoir
    bookkeeping, no per-producer edge invention.
    """

    kind = "histogram"
    __slots__ = (
        "name", "labels", "count", "sum", "min", "max", "last",
        "edges", "bins",
    )

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0
        self.edges = HISTOGRAM_BUCKET_EDGES.get(name)
        self.bins = [0] * len(self.edges) if self.edges else None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.last = v
        if self.bins is not None:
            # First edge >= v: the observation lands in that bin (le
            # semantics); past the last edge it only counts toward the
            # implicit +Inf bucket, i.e. `count`.
            i = bisect_left(self.edges, v)
            if i < len(self.bins):
                self.bins[i] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "name": self.name,
            "type": self.kind,
            "labels": self.labels,
            "count": self.count,
        }
        if self.count:
            out.update(
                sum=self.sum, min=self.min, max=self.max,
                mean=self.mean, last=self.last,
            )
        if self.bins is not None:
            # Cumulative counts, Prometheus-shaped: counts[i] = samples
            # <= edges[i]; the +Inf bucket is `count` (rendered by the
            # exporter, not duplicated here).
            cum: list[int] = []
            running = 0
            for n in self.bins:
                running += n
                cum.append(running)
            out["buckets"] = {"edges": list(self.edges), "counts": cum}
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Create-or-get labeled instruments; snapshot/flush them to sinks.

    ``registry.counter("comm.bytes", op="allreduce")`` returns the same
    :class:`Counter` object on every call with the same (name, labels) —
    hot paths should cache the instrument, but looking it up each time is
    still just a dict hit. Requesting an existing name with a different
    instrument kind raises (one name, one type — the JSONL consumer's
    invariant).
    """

    def __init__(self, sinks: Iterable[Any] = ()):
        self._metrics: dict[tuple[str, tuple[tuple[str, str], ...]], Any] = {}
        self._kinds: dict[str, type] = {}
        self._sinks: list[Any] = list(sinks)
        self._lock = threading.Lock()
        # Hot-path switch read by the built-in instrumentation (comm, data
        # loader): False means "skip recording entirely" — the registry
        # itself keeps working for direct callers. Hot paths that cache
        # instrument handles key them on (registry identity, version); see
        # `version`.
        self.enabled = True
        self._version = 0

    @property
    def version(self) -> int:
        """Bumped whenever cached instrument handles go stale (currently:
        on :meth:`reset`, which orphans every existing instrument object).
        Hot-path handle caches compare this alongside registry identity."""
        return self._version

    # -- instruments --------------------------------------------------

    def _get(self, cls: type, name: str, labels: dict[str, str]) -> Any:
        if not name:
            raise ValueError("metric name must be non-empty")
        lab = {str(k): str(v) for k, v in labels.items()}
        key = (name, tuple(sorted(lab.items())))
        inst = self._metrics.get(key)
        if inst is None:
            with self._lock:
                # Name→kind is enforced ACROSS label sets, not just per
                # (name, labels) key — one name must never flush as two
                # instrument types.
                known = self._kinds.setdefault(name, cls)
                if known is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{known.kind}, requested {cls.kind}"
                    )
                inst = self._metrics.setdefault(key, cls(name, lab))
        if not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- sinks / output ------------------------------------------------

    def add_sink(self, sink: Any) -> Any:
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Any) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @property
    def sinks(self) -> tuple[Any, ...]:
        return tuple(self._sinks)

    def snapshot(self) -> list[dict[str, Any]]:
        """Point-in-time list of metric objects (schema.py shapes)."""
        with self._lock:
            return [m.snapshot() for m in self._metrics.values()]

    def _process_index(self) -> int:
        return process_index_or_zero()

    def flush(self, **extra: Any) -> dict[str, Any]:
        """Build one schema-v1 record from the current snapshot and write
        it to every sink (one JSONL line per flush). Extra keyword fields
        are merged into the record top-level (e.g. ``bench=result``).
        Counters/histograms are cumulative — flushing does not reset."""
        record: dict[str, Any] = {
            "schema": SCHEMA,
            "time_unix": time.time(),
            "process": self._process_index(),
            "metrics": self.snapshot(),
        }
        record.update(extra)
        for sink in self.sinks:
            sink.write(record)
        return record

    def reset(self) -> None:
        """Drop all instruments (test isolation helper). Sinks stay. Bumps
        :attr:`version` so hot-path handle caches re-resolve instead of
        recording into the orphaned objects."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._version += 1

    def close(self, flush: bool = True) -> None:
        """Close and detach every sink; by default flush a final record
        first (so shutdown never loses a partial interval). Pass
        ``flush=False`` when the caller just flushed and a duplicate
        line would be wrong."""
        if flush and self._sinks:
            self.flush()
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for sink in sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()


# ---------------------------------------------------------------------------
# Default registry: what the built-in instrumentation (comm, data loader,
# train-step hook with metrics=True) records into. Starts with no sinks —
# recording is always on (it is nearly free), *emission* is opt-in via
# configure()/add_sink.
# ---------------------------------------------------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry (returns the previous one)."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
