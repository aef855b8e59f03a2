"""Pluggable flush targets for :class:`~fluxmpi_tpu_torch.telemetry.MetricsRegistry`
(counterpart of :mod:`fluxmpi_tpu.telemetry.sinks`).

A sink receives the full flush record (schema.py shape) and owns its
transport. Three are provided: a JSONL file writer (one line per
flush), an in-memory list for tests, and a rank-0
console reporter. ``NullSink`` exists so overhead can be measured with
emission wired up but going nowhere.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Any, IO, Iterator

__all__ = [
    "Sink",
    "JSONLSink",
    "MemorySink",
    "ConsoleSink",
    "NullSink",
    "jsonl_lock",
]


@contextlib.contextmanager
def jsonl_lock(path: str) -> Iterator[None]:
    """Exclusive advisory lock on ``<path>.lock`` — the serialization
    protocol every writer of a shared JSONL must join: per-line sink
    appends here, and a merge-by-rename writer's read-merge-replace (the
    JAX package's ``bench.py``), so a merge never drops a line another writer lands
    mid-merge. Non-POSIX platforms degrade to best-effort unlocked."""
    with open(path + ".lock", "a", encoding="utf-8") as lock:
        try:
            import fcntl
        except ImportError:  # pragma: no cover - non-POSIX
            yield
            return
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock.fileno(), fcntl.LOCK_UN)


class Sink:
    """Interface: ``write(record)`` per flush, ``close()`` at shutdown."""

    def write(self, record: dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(Sink):
    """Discards every record (overhead measurement / disabled emission)."""

    def write(self, record: dict[str, Any]) -> None:
        pass


class MemorySink(Sink):
    """Keeps records in a list — test and notebook introspection."""

    def __init__(self) -> None:
        self.records: list[dict[str, Any]] = []

    def write(self, record: dict[str, Any]) -> None:
        self.records.append(record)

    def clear(self) -> None:
        self.records.clear()


class JSONLSink(Sink):
    """Append one JSON line per flush to a file.

    The file is opened lazily on first write (constructing the sink on a
    rank that never flushes creates nothing) and every line is flushed
    through to the disk (``fsync``) — a killed run keeps all completed lines, which is
    the whole point of a crash-forensics stream. Every controller process
    should write to its own path in multi-host runs (pass e.g.
    ``f"metrics.{fluxmpi_tpu_torch.process_index()}.jsonl"``); lines carry ``process``
    so merged streams stay attributable.

    ``shared=True`` opts into the shared-JSONL protocol for a path that a
    merge-by-rename writer also owns (the JAX package's
    ``FLUXMPI_TPU_BENCH_JSONL`` result bank): each line takes :func:`jsonl_lock` and
    reopens the file, so a concurrent merge never drops the line and the
    inode swap never strands the sink appending to an unlinked file. A
    sink on its own private stream (the default) keeps the cheap
    persistent handle and creates no ``.lock`` sidecar.
    """

    def __init__(self, path: str, *, shared: bool = False):
        self.path = path
        self.shared = shared
        self._file: IO[str] | None = None

    def write(self, record: dict[str, Any]) -> None:
        line = json.dumps(record) + "\n"
        if self.shared:
            with jsonl_lock(self.path):
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
            return
        if self._file is None:
            self._file = open(self.path, "a", encoding="utf-8")
        self._file.write(line)
        self._file.flush()
        # Through to the disk, not only the OS: a machine lost mid-run
        # keeps every completed line.
        os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class ConsoleSink(Sink):
    """Compact per-flush summary on stdout, lead process only.

    Multi-host etiquette: every process records, only process 0 prints —
    the serialized all-rank printer (:func:`fluxmpi_tpu_torch.fluxmpi_println`)
    takes a global barrier per line, far too heavy for periodic metrics.
    """

    def __init__(self, stream: IO[str] | None = None, max_metrics: int = 8):
        self._stream = stream
        self.max_metrics = max_metrics

    def _is_lead(self) -> bool:
        from .registry import process_index_or_zero

        return process_index_or_zero() == 0

    def write(self, record: dict[str, Any]) -> None:
        if not self._is_lead():
            return
        parts = []
        for m in record.get("metrics", [])[: self.max_metrics]:
            label = ",".join(f"{k}={v}" for k, v in m.get("labels", {}).items())
            name = m["name"] + (f"{{{label}}}" if label else "")
            if m["type"] == "histogram":
                if m.get("count"):
                    parts.append(
                        f"{name} n={m['count']} mean={m['mean']:.4g} "
                        f"max={m['max']:.4g}"
                    )
            else:
                parts.append(f"{name}={m['value']:.6g}")
        n_more = len(record.get("metrics", [])) - self.max_metrics
        if n_more > 0:
            parts.append(f"(+{n_more} more)")
        print("telemetry: " + "  ".join(parts), file=self._stream or sys.stdout)
