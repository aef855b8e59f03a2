"""Live N→M resizing: drain, save, reshard, resume, the badput accounted.

Counterpart of :mod:`fluxmpi_tpu.fleet.resize`. A resize is requested
explicitly (:func:`request_resize`, an operator thread or a signal
handler), honoured at a flush boundary (never mid-step), sample-exact
across the restart (the loader's cursor remap), and every second it costs
is attributed to a named phase of one ``fluxmpi_tpu.resize/v1`` record::

    OLD WORLD (N workers)                  NEW WORLD (M workers)
    request_resize(M)
      | agreed at the next flush boundary (one host max-reduce: every
      | worker stops at the same update)       [phase: drain]
    drain the in-flight steps
    final checkpoint save + wait               [phase: save]
    write the handoff stamp, return
                  ...the job restarts with M workers...
                                               [phase: restart]
                                           resume reads the stamp; the
                                           restore reshards through the
                                           manifest            [phase: reshard]
                                           complete: append the record,
                                           remove the stamp

The **handoff stamp** (``.fluxmpi_resize.json`` beside the step
directories) stitches a record across two worlds: the draining world banks
its phases and exit time there; the resumed world computes ``restart``
(the gap neither saw), adds its ``reshard`` seconds, validates the record
(:func:`~fluxmpi_tpu_torch.telemetry.schema.validate_resize_record`) and
appends it to the ``FLUXMPI_TPU_RESIZE=<path>`` JSONL bank, which
``scripts/check_metrics_schema.py`` validates.

Wiring: ``init(resize=...)`` / ``FLUXMPI_TPU_RESIZE`` arms the plane
(``"1"``: armed, a path: armed with a record bank); ``train_loop`` polls
the coordinator at flush boundaries while it is armed and a checkpoint
manager is attached. Progress lands on the live exporter's RESIZE board
and in the ``resize.*`` metrics.

Fault sites: ``resize.drain`` fires when the request is agreed (a
``delay=`` entry stalls the drain and books as drain badput);
``resize.reshard`` fires on the resumed world before the restore's bytes
move. A SIGTERM with a target armed is a resize: the preemption's drain
produces the handoff stamp.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Any

from ..telemetry.registry import get_registry as _get_registry
from ..telemetry.registry import process_index_or_zero as _process_index
from ..telemetry.schema import RESIZE_PHASES, RESIZE_SCHEMA

__all__ = [
    "ResizeCoordinator",
    "HANDOFF_FILENAME",
    "get_resize_coordinator",
    "set_resize_coordinator",
    "request_resize",
    "read_handoff",
    "configure",
    "enabled",
    "shutdown",
]

_ENV_VAR = "FLUXMPI_TPU_RESIZE"

# The cross-restart stitch point, written next to the step directories
# (the durable tier — the resumed world must see it on shared storage).
HANDOFF_FILENAME = ".fluxmpi_resize.json"


def _handoff_path(directory: str) -> str:
    return os.path.join(directory, HANDOFF_FILENAME)


def read_handoff(directory: str) -> dict[str, Any] | None:
    """The pending handoff stamp under ``directory``, or None (absent or
    unreadable — an unreadable stamp warns and reads as absent, the
    manifest discipline: telemetry corruption must never block a
    restore)."""
    path = _handoff_path(directory)
    try:
        with open(path) as f:
            stamp = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        warnings.warn(
            f"unreadable resize handoff stamp at {path}: {exc}; treating "
            f"as absent (the resize record for this restart is lost)",
            stacklevel=2,
        )
        return None
    if not isinstance(stamp, dict) or stamp.get("schema") != RESIZE_SCHEMA:
        warnings.warn(
            f"resize handoff stamp at {path} has unexpected schema "
            f"{stamp.get('schema') if isinstance(stamp, dict) else stamp!r}; "
            f"treating as absent",
            stacklevel=2,
        )
        return None
    return stamp


class ResizeCoordinator:
    """One job's resize state machine: the request flag the loop polls,
    the per-phase badput ledger, and the handoff stamp protocol.

    Thread discipline: :meth:`request_resize` is a plain-attribute write
    (callable from a signal handler or an operator thread, the
    preemption-flag rule); everything else runs on the training thread.

    Args:
      log_path: append one validated ``fluxmpi_tpu.resize/v1`` JSON line
        per completed resize here (None = no bank; the record still
        lands on the RESIZE board and ``resize.*`` gauges).
      enabled: arm immediately. The module default starts DISARMED —
        arm via ``init(resize=...)`` / ``FLUXMPI_TPU_RESIZE`` /
        :func:`configure`.
    """

    def __init__(
        self, *, log_path: str | None = None, enabled: bool = True
    ):
        self.enabled = enabled
        self.log_path = log_path
        self._target: int | None = None
        self._reason: str | None = None
        self._t0: float | None = None
        self._phase: str | None = None
        self._phase_seconds: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- request flag (signal-safe writes, loop-polled reads) ----------

    def request_resize(self, target: int, *, reason: str = "api") -> None:
        """Ask the running world to drain and hand off to ``target``
        processes. Takes effect at the next flush boundary; a second
        request before then overwrites the first (last writer wins —
        the autoscaler's newest verdict is the one that matters)."""
        if not isinstance(target, int) or isinstance(target, bool) or target < 1:
            raise ValueError(
                f"resize target must be an int >= 1, got {target!r}"
            )
        self._reason = reason
        self._target = target

    def requested_target(self) -> int:
        """The locally-requested target world size, 0 when none — the
        value the loop max-reduces across processes at flush boundaries
        (any process's request enrolls the world)."""
        return self._target or 0

    def clear_request(self) -> None:
        self._target = None
        self._reason = None

    # -- phase ledger ---------------------------------------------------

    def begin(self, target: int, *, from_processes: int) -> None:
        """The request was agreed by the world: start the drain clock,
        fire the ``resize.drain`` chaos site (a ``delay=`` entry stalls
        here and books as drain badput), and post the board."""
        from .. import faults as _faults

        self._target = target
        self._t0 = time.perf_counter()
        self._phase = "drain"
        self._phase_seconds = {}
        self._count("resize.requests")
        self._note_board(
            phase="drain",
            to_processes=target,
            from_processes=from_processes,
            reason=self._reason,
        )
        _faults.check("resize.drain")

    def note_drained(self) -> float:
        """The in-flight window is drained: close the drain phase and
        open ``save``. Returns the drain seconds."""
        drain = (
            time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        )
        self.note_phase("drain", drain)
        self._phase = "save"
        self._note_board(phase="save")
        return drain

    def note_phase(self, phase: str, seconds: float) -> None:
        """Attribute ``seconds`` of badput to ``phase`` (one of
        :data:`~fluxmpi_tpu_torch.telemetry.schema.RESIZE_PHASES`) — the
        ledger, the ``resize.badput_seconds`` gauge, and the board."""
        if phase not in RESIZE_PHASES:
            raise ValueError(
                f"unknown resize phase {phase!r}; must be one of "
                f"{RESIZE_PHASES}"
            )
        with self._lock:
            self._phase_seconds[phase] = (
                self._phase_seconds.get(phase, 0.0) + seconds
            )
            total = dict(self._phase_seconds)
        reg = _get_registry()
        if getattr(reg, "enabled", True):
            reg.gauge("resize.badput_seconds", phase=phase).set(total[phase])
        self._note_board(phase_seconds=total)

    # -- handoff protocol ----------------------------------------------

    def write_handoff(
        self,
        directory: str,
        *,
        step: int,
        from_processes: int,
        to_processes: int,
    ) -> str | None:
        """Bank the draining world's half of the record next to the
        checkpoint (lead process writes, fsync'd — the stamp must
        survive the same crash the checkpoint does; peers no-op).
        Returns the stamp path (lead) or None."""
        self._phase = "handoff"
        with self._lock:
            phases = dict(self._phase_seconds)
        self._note_board(phase="handoff", step=step)
        if _process_index() != 0:
            return None
        stamp = {
            "schema": RESIZE_SCHEMA,
            "handoff": True,
            "step": int(step),
            "from_processes": int(from_processes),
            "to_processes": int(to_processes),
            "reason": self._reason or "api",
            "drain_seconds": float(phases.get("drain", 0.0)),
            "save_seconds": float(phases.get("save", 0.0)),
            "exit_unix": time.time(),
        }
        path = _handoff_path(directory)
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(stamp, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def maybe_begin_reshard(self, directory: str) -> dict[str, Any] | None:
        """Called by the resumed world before its restore: when a
        handoff stamp is pending, fire the ``resize.reshard`` chaos
        site, post the board, and return the stamp (the caller times
        the restore and hands the seconds to :meth:`complete`). None
        when no resize is in flight."""
        stamp = read_handoff(directory)
        if stamp is None:
            return None
        from .. import faults as _faults

        self._phase = "reshard"
        self._note_board(
            phase="reshard",
            step=stamp.get("step"),
            from_processes=stamp.get("from_processes"),
            to_processes=stamp.get("to_processes"),
        )
        _faults.check("resize.reshard")
        return stamp

    def complete(
        self,
        directory: str,
        stamp: dict[str, Any],
        *,
        reshard_seconds: float,
        to_processes: int,
    ) -> dict[str, Any] | None:
        """Stitch the full record on the resumed world: ``restart`` is
        the wall-clock gap between the old world's exit stamp and this
        world reaching its restore, minus the reshard time already
        attributed. Validates against the schema, appends to the JSONL
        bank (lead process), removes the stamp, and posts the terminal
        board. Returns the record (every process) or None when the
        stamp is malformed."""
        now = time.time()
        try:
            exit_unix = float(stamp["exit_unix"])
            drain = float(stamp.get("drain_seconds", 0.0))
            save = float(stamp.get("save_seconds", 0.0))
            step = int(stamp["step"])
            from_processes = int(stamp["from_processes"])
        except (KeyError, TypeError, ValueError) as exc:
            warnings.warn(
                f"malformed resize handoff stamp: {exc}; dropping the "
                f"record for this resize",
                stacklevel=2,
            )
            self._remove_stamp(directory)
            return None
        restart = max(0.0, now - exit_unix - reshard_seconds)
        phases = {
            "drain": drain,
            "save": save,
            "reshard": float(reshard_seconds),
            "restart": restart,
        }
        record = {
            "schema": RESIZE_SCHEMA,
            "time_unix": now,
            "step": step,
            "from_processes": from_processes,
            "to_processes": int(
                stamp.get("to_processes") or to_processes
            ),
            "reason": stamp.get("reason") or None,
            "phases": phases,
            "badput_seconds": sum(phases.values()),
        }
        actual = int(to_processes)
        if record["to_processes"] != actual:
            # The scheduler gave a different world than requested (it
            # happens: capacity moved again mid-restart). The record
            # reports the world that actually resumed — that is the
            # resize that occurred — with the request kept in `reason`.
            record["reason"] = (
                f"{record['reason'] or 'api'} "
                f"(requested {record['to_processes']})"
            )
            record["to_processes"] = actual
        from ..telemetry.schema import validate_resize_record

        errors = validate_resize_record(record)
        if errors:  # pragma: no cover - producer bug guard
            warnings.warn(
                f"resize record failed its own schema: {errors}",
                stacklevel=2,
            )
        # The resumed world's ledger starts empty (fresh process): adopt
        # the stitched phases wholesale rather than note_phase-adding,
        # which would double-count anything the loop already attributed.
        with self._lock:
            self._phase_seconds = dict(phases)
        reg = _get_registry()
        if getattr(reg, "enabled", True):
            for phase, seconds in phases.items():
                reg.gauge("resize.badput_seconds", phase=phase).set(seconds)
        self._count("resize.completed")
        self._note_board(
            phase="completed",
            step=step,
            from_processes=from_processes,
            to_processes=record["to_processes"],
            badput_seconds=record["badput_seconds"],
            phase_seconds=phases,
        )
        if _process_index() == 0:
            if self.log_path:
                try:
                    with open(self.log_path, "a") as f:
                        f.write(json.dumps(record) + "\n")
                except OSError as exc:
                    warnings.warn(
                        f"cannot append resize record to "
                        f"{self.log_path}: {exc}",
                        stacklevel=2,
                    )
            self._remove_stamp(directory)
        self.clear_request()
        self._phase = None
        return record

    def _remove_stamp(self, directory: str) -> None:
        try:
            os.remove(_handoff_path(directory))
        except OSError:
            pass

    # -- telemetry ------------------------------------------------------

    def _count(self, name: str) -> None:
        reg = _get_registry()
        if getattr(reg, "enabled", True):
            reg.counter(name).inc()

    def _note_board(self, **fields: Any) -> None:
        try:
            from ..telemetry import export as _export

            exporter = _export.get_exporter()
        except Exception:  # pragma: no cover - board is best-effort
            return
        if exporter is not None:
            exporter.note_resize(**fields)

    # -- board/introspection -------------------------------------------

    @property
    def phase(self) -> str | None:
        """The current pipeline phase (None when no resize is live)."""
        return self._phase

    def phase_seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._phase_seconds)

    def reset(self) -> None:
        """Drop request + ledger (shutdown's no-leak contract)."""
        self.clear_request()
        self._t0 = None
        self._phase = None
        with self._lock:
            self._phase_seconds = {}


# ---------------------------------------------------------------------------
# Module plane: a process-global coordinator + configure()/shutdown(), the
# same shape as every telemetry plane (env var, init kwarg, no state leaks
# across init/shutdown cycles).
# ---------------------------------------------------------------------------

_default = ResizeCoordinator(enabled=False)
_default_lock = threading.Lock()


def get_resize_coordinator() -> ResizeCoordinator:
    """The process-global resize coordinator (disarmed until
    configured)."""
    return _default


def set_resize_coordinator(
    coordinator: ResizeCoordinator,
) -> ResizeCoordinator:
    """Swap the default coordinator (returns the previous one)."""
    global _default
    with _default_lock:
        prev, _default = _default, coordinator
    return prev


def request_resize(target: int, *, reason: str = "api") -> None:
    """Ask the running world to resize to ``target`` processes — the
    operator/autoscaler entry point; honored at the next flush boundary
    of a loop running with a checkpoint manager and the plane armed."""
    _default.request_resize(target, reason=reason)


def enabled() -> bool:
    """Is the resize plane armed? One attribute read — what
    ``train_loop`` gates its per-flush poll on."""
    return _default.enabled


def configure(spec: Any = None) -> ResizeCoordinator | None:
    """Wire the resize plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_RESIZE`` (same forms; no-op when
      unset/empty);
    - ``False`` / ``"0"`` — disarm and drop any pending request;
    - ``True`` / ``"1"`` — arm the plane (records land on the board and
      gauges only);
    - a path string — arm, and append one ``fluxmpi_tpu.resize/v1``
      JSON line per completed resize there;
    - a :class:`ResizeCoordinator` — install it (armed).

    Called by ``fluxmpi_tpu_torch.init(resize=...)``; idempotent.
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _default if _default.enabled else None
    if spec is False or spec == "0":
        shutdown()
        return None
    if isinstance(spec, ResizeCoordinator):
        spec.enabled = True
        set_resize_coordinator(spec)
        return spec
    if spec is True or spec == "1":
        _default.enabled = True
        return _default
    if isinstance(spec, str):
        _default.enabled = True
        _default.log_path = spec
        return _default
    raise ValueError(
        f"resize spec must be a bool, '0'/'1', a record-bank path, or a "
        f"ResizeCoordinator; got {spec!r}"
    )


def shutdown() -> None:
    """Disarm the default coordinator and drop its request/ledger — a
    resize request left armed across an init/shutdown cycle would drain
    the NEXT run at its first flush (the fault-plane leak rule)."""
    _default.enabled = False
    _default.log_path = None
    _default.reset()
