"""Collective flight recorder: a fixed-size ring of the last N launches
(counterpart of :mod:`fluxmpi_tpu.telemetry.flight_recorder`).

The shape of PyTorch's NCCL flight recorder, rendered for the eager
collective layer here: every launch in :mod:`fluxmpi_tpu_torch.comm` appends an
entry — monotonic per-process sequence number, op, path (``device`` /
``host``), payload bytes, start stamp — *before* the potentially-blocking
call, and marks it completed after. A rank hung inside a collective
therefore shows a tail entry with ``completed: false`` naming exactly
which collective it is stuck in; metrics alone can never say this,
because a hung rank cannot be seen *through* a collective
(telemetry/monitor.py's stated blind spot).

The dump format is designed for **cross-host diffing**
(:func:`diff_dumps`): sequence numbers advance in lockstep on every host
of an SPMD program, so after collecting one dump per host (the watchdog
writes them; or call :meth:`FlightRecorder.dump` over any transport),
mismatched tail sequence numbers localize a desync to the exact
collective — the lagging host's in-flight entry is where the ranks
diverged.

Hot-path cost: :meth:`begin` is one ``itertools.count`` tick, one tuple
of field reads, and one ``deque.append`` (lock-free under the GIL — the
same contract as the metrics instruments); :meth:`complete` is two
attribute writes and an int increment. No locks anywhere on the record
path; ``dump()`` snapshots with ``list()``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any

from .registry import process_index_or_zero as _process_index
from .schema import TRACE_SCHEMA

__all__ = [
    "FlightEntry",
    "FlightRecorder",
    "get_flight_recorder",
    "set_flight_recorder",
    "diff_dumps",
]

_DEFAULT_CAPACITY = 256


class FlightEntry:
    """One recorded collective launch. ``completed`` flips true when the
    call returned to the caller (for device collectives: async dispatch
    returned — the hang that matters still shows, because a wedged
    dispatch or host-blocking collective never comes back)."""

    __slots__ = (
        "seq", "op", "path", "nbytes", "time_unix", "start", "end",
        "completed", "aborted",
    )

    def __init__(self, seq: int, op: str, path: str, nbytes: int):
        self.seq = seq
        self.op = op
        self.path = path
        self.nbytes = int(nbytes)
        self.time_unix = time.time()
        self.start = time.perf_counter()
        self.end: float | None = None
        self.completed = False
        self.aborted = False

    def as_dict(self) -> dict[str, Any]:
        out = {
            "seq": self.seq,
            "op": self.op,
            "path": self.path,
            "nbytes": self.nbytes,
            "time_unix": self.time_unix,
            "duration": (
                self.end - self.start if self.end is not None else None
            ),
            "completed": self.completed,
        }
        if self.aborted:
            out["aborted"] = True
        return out


class FlightRecorder:
    """Bounded ring of :class:`FlightEntry` records with a monotonic
    per-process sequence number."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # Recording switch. On (the default) a launch costs one count tick
        # + one deque append; off, begin() returns None and the comm layer's
        # fast-guard skips the begin/complete pair entirely — the
        # "zero-cost-when-off" contract shared with the metrics registry
        # and the tracer.
        self.enabled = enabled
        self._ring: deque[FlightEntry] = deque(maxlen=capacity)
        # itertools.count.__next__ is atomic in CPython — sequence numbers
        # are unique and totally ordered without a lock. Between taking
        # the number and appending, a concurrent producer thread could
        # interleave, so ring *order* is only per-producer; dump() sorts
        # by seq and `sequence` advances with max() so neither ever
        # regresses. (Every producer in this repo drives collectives
        # from one thread; this is belt-and-braces.)
        self._count = itertools.count(1)
        self._last_seq = 0
        self._completed = 0

    def begin(self, op: str, path: str, nbytes: int) -> FlightEntry | None:
        """Record a launch BEFORE the potentially-blocking call. Returns
        ``None`` (records nothing) while disabled."""
        if not self.enabled:
            return None
        entry = FlightEntry(next(self._count), op, path, nbytes)
        if entry.seq > self._last_seq:
            self._last_seq = entry.seq
        self._ring.append(entry)
        return entry

    def complete(self, entry: FlightEntry) -> None:
        """Mark a launch returned. Call after the collective comes back."""
        entry.end = time.perf_counter()
        entry.completed = True
        self._completed += 1

    def abort(self, entry: FlightEntry) -> None:
        """Mark a launch that RAISED. The entry is finalized (so a later
        dump never reports a long-dead exception as the collective this
        host is "stuck in") but flagged ``aborted`` and not counted as
        watchdog progress."""
        entry.end = time.perf_counter()
        entry.completed = True
        entry.aborted = True

    @property
    def sequence(self) -> int:
        """Highest sequence number issued so far."""
        return self._last_seq

    @property
    def completed_count(self) -> int:
        """Total completed launches — a watchdog progress source: a rank
        stuck in one collective stops advancing it."""
        return self._completed

    def __len__(self) -> int:
        return len(self._ring)

    def entries(self) -> list[FlightEntry]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self) -> dict[str, Any]:
        """Schema ``fluxmpi_tpu.trace/v1`` / kind ``flight_recorder``
        snapshot — the cross-host-diffable artifact."""
        return {
            "schema": TRACE_SCHEMA,
            "kind": "flight_recorder",
            "time_unix": time.time(),
            "process": _process_index(),
            "capacity": self.capacity,
            "sequence": self._last_seq,
            "completed": self._completed,
            # Sorted by seq: ring order is append order, which under
            # concurrent producers is only per-thread; the dump contract
            # (and its validator) is strictly increasing seq.
            "entries": sorted(
                (e.as_dict() for e in list(self._ring)),
                key=lambda e: e["seq"],
            ),
        }


# ---------------------------------------------------------------------------
# Cross-host diff
# ---------------------------------------------------------------------------


def diff_dumps(dumps: list[dict[str, Any]]) -> dict[str, Any]:
    """Localize a desync from one flight-recorder dump per host.

    Returns a report with, per host (keyed by the dump's ``process``):
    the highest sequence number, the last *completed* sequence, and the
    in-flight entry (the collective that host is stuck in, if any);
    plus:

    - ``min_sequence`` / ``max_sequence`` — the lagging and leading
      hosts' positions; equal on a healthy synchronized program;
    - ``laggards`` — hosts whose sequence trails ``max_sequence`` (the
      hung/slow ranks; their in-flight entry names the collective);
    - ``first_mismatch`` — the lowest sequence number present in more
      than one dump where hosts disagree on ``(op, path, nbytes)``: a
      *divergence* (different collective order), which is a bug upstream
      of any hang, or ``None`` when the launch streams agree;
    - ``synchronized`` — true when every host sits at the same sequence
      with nothing in flight and no mismatch.
    """
    if not dumps:
        raise ValueError("diff_dumps needs at least one dump")
    hosts: dict[int, dict[str, Any]] = {}
    by_seq: dict[int, dict[int, dict[str, Any]]] = {}
    for d in dumps:
        proc = int(d.get("process", 0))
        if proc in hosts:
            # Silently keeping the last dump would collapse two hosts
            # into one row and could report a desynced pair as
            # synchronized (dumps taken pre-init all stamp process 0).
            raise ValueError(
                f"two dumps share process index {proc}; stamp each "
                f"host's dump with a distinct 'process' before diffing"
            )
        entries = d.get("entries", [])
        in_flight = [e for e in entries if not e.get("completed")]
        completed = [e for e in entries if e.get("completed")]
        hosts[proc] = {
            "sequence": int(d.get("sequence", 0)),
            "last_completed_seq": (
                max(e["seq"] for e in completed) if completed else 0
            ),
            "in_flight": in_flight[0] if in_flight else None,
        }
        for e in entries:
            by_seq.setdefault(int(e["seq"]), {})[proc] = e
    seqs = [h["sequence"] for h in hosts.values()]
    max_seq, min_seq = max(seqs), min(seqs)
    laggards = sorted(p for p, h in hosts.items() if h["sequence"] < max_seq)
    first_mismatch = None
    for seq in sorted(k for k, v in by_seq.items() if len(v) > 1):
        sigs = {
            p: (e.get("op"), e.get("path"), e.get("nbytes"))
            for p, e in by_seq[seq].items()
        }
        if len(set(sigs.values())) > 1:
            first_mismatch = {
                "seq": seq,
                "entries": {str(p): by_seq[seq][p] for p in sorted(sigs)},
            }
            break
    synchronized = (
        max_seq == min_seq
        and first_mismatch is None
        and all(h["in_flight"] is None for h in hosts.values())
    )
    return {
        "hosts": {str(p): hosts[p] for p in sorted(hosts)},
        "min_sequence": min_seq,
        "max_sequence": max_seq,
        "laggards": laggards,
        "first_mismatch": first_mismatch,
        "synchronized": synchronized,
    }


# ---------------------------------------------------------------------------
# Default recorder (what comm.py feeds)
# ---------------------------------------------------------------------------

_default = FlightRecorder()
_default_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global default flight recorder."""
    return _default


def set_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the default recorder (returns the previous one)."""
    global _default
    with _default_lock:
        prev, _default = _default, recorder
    return prev
