"""Checkpoint and resume, replicated layout.

Counterpart of :mod:`fluxmpi_tpu.utils.checkpoint` for state that every
worker holds whole (data-parallel training): :func:`save_checkpoint`
writes from the lead worker, :func:`restore_checkpoint` reads on the root
and broadcasts (the reference's load-on-root-then-``synchronize!`` flow),
and :class:`CheckpointManager` runs the lifecycle of a training run.

**On disk.** A checkpoint at ``<path>`` is a directory holding one file,
``state.pt``: a flat dict of CPU tensors keyed by each leaf's flax-style
path (:func:`~fluxmpi_tpu_torch.utils.manifest.named_leaves`), written with
``torch.save`` and read with ``torch.load(weights_only=True)``. Python int
leaves ride as int32 scalars (a ``TrainState``'s step, an optimizer's
count), the loop's counters as int64, as in the JAX payload. Beside it sit
the ``<path>.manifest.json`` sidecar (``fluxmpi_tpu.manifest/v1``) and the
``<path>.fluxmpi_layout`` commit marker, with the JAX package's names.

**Crash consistency** (the commit protocol): the bytes are written into
``<path>.tmp`` (fault site ``ckpt.write``, retried with capped exponential
backoff on ``OSError``), which is renamed to ``<path>``; the manifest is
written (site ``ckpt.manifest`` before it), and the fsync'd marker commits
the step (site ``ckpt.commit`` before it). Discovery believes committed
steps only. An overwrite decommits the old step only after the new bytes
are staged, so a failed write leaves the previous committed step intact.

**Workers.** The path must be on storage every worker sees. The lead
worker (rank 0) writes and keeps the directory; every worker first agrees
on the step (one all-reduce on the caller's thread; a disagreement raises
:class:`~fluxmpi_tpu_torch.errors.CheckpointDesyncError` on every worker).
A restore is decided and read on the root, then broadcast, so no other
worker reads the files.

**Snapshots.** A save first copies the state to host memory on the
caller's thread (site ``ckpt.snapshot``): CUDA tensors into pinned buffers
with copies queued on the current stream, so the step's in-place updates
queued after them cannot change the bytes, and a CUDA event after the
copies that the writer waits on before it reads them. The writer touches
no CUDA tensor.

**Environment.** ``FLUXMPI_TPU_CKPT_RETRIES`` (default 3) and
``FLUXMPI_TPU_CKPT_RETRY_BACKOFF_S`` (0.1) shape the write retries;
``FLUXMPI_TPU_CKPT_TIMEOUT`` sets a hard deadline on waits for a background
save; ``FLUXMPI_TPU_CKPT_ASYNC=0`` makes a manager's saves synchronous by
default; ``FLUXMPI_TPU_CKPT_LOCAL_DIR`` names its local fast tier.

**Telemetry.** Saves and restores on the training thread book their wall
time into the goodput ``checkpoint_save`` / ``checkpoint_restore``
buckets; the background writer's time goes to the tracker's off-driver
``checkpoint_async_write`` ledger. ``checkpoint.retries``,
``checkpoint.async_saves``, ``checkpoint.async_superseded`` and
``checkpoint.promotions`` count in the default registry.

Not ported yet: the sharded layout, elastic restore, and the
status-board hook.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .. import comm, faults, runtime
from ..errors import (CheckpointDesyncError, CheckpointTimeoutError, FaultInjectedError,
                      refuse_unported)
from ..telemetry import get_registry as _telemetry_registry
from ..telemetry import goodput as _goodput
from . import manifest as _manifest

__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]

_ENV_TIMEOUT = "FLUXMPI_TPU_CKPT_TIMEOUT"
_ENV_RETRIES = "FLUXMPI_TPU_CKPT_RETRIES"
_ENV_BACKOFF = "FLUXMPI_TPU_CKPT_RETRY_BACKOFF_S"
_ENV_ASYNC = "FLUXMPI_TPU_CKPT_ASYNC"
_ENV_LOCAL_DIR = "FLUXMPI_TPU_CKPT_LOCAL_DIR"
_BACKOFF_CAP_S = 5.0
_DATA = "state.pt"
_LAYOUT = "replicated"
_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")

# Retry tests replace this so backoff is asserted, not waited for.
_retry_sleep = time.sleep


def _world() -> tuple[int, int]:
    if runtime.is_initialized():
        return runtime.process_index(), runtime.process_count()
    return 0, 1


def _is_lead() -> bool:
    return _world()[0] == 0


def _hard_deadline_s() -> float | None:
    raw = os.environ.get(_ENV_TIMEOUT)
    if not raw:
        return None
    deadline = float(raw)
    return deadline if deadline > 0 else None


def _wait_with_diagnostic(fut: Future, what: str,
                          warn_after_s: float = 60.0) -> None:
    """``fut.result()`` that warns every ``warn_after_s`` while it waits,
    and raises :class:`CheckpointTimeoutError` past the
    ``FLUXMPI_TPU_CKPT_TIMEOUT`` deadline."""
    deadline = _hard_deadline_s()
    waited = 0.0
    while True:
        timeout = warn_after_s
        if deadline is not None:
            timeout = min(timeout, max(deadline - waited, 0.001))
        try:
            fut.result(timeout=timeout)
            return
        except _FutureTimeout:
            waited += timeout
            if deadline is not None and waited >= deadline:
                raise CheckpointTimeoutError(
                    f"{what} did not complete within the "
                    f"{_ENV_TIMEOUT}={deadline:.0f}s hard deadline"
                ) from None
            warnings.warn(f"{what} has not completed after {waited:.0f}s; "
                          f"still waiting", stacklevel=2)


def _count(name: str) -> None:
    """Count one checkpoint event (``checkpoint.retries``,
    ``checkpoint.async_saves``, ...) in the default telemetry registry."""
    try:
        registry = _telemetry_registry()
        if registry.enabled:
            registry.counter(name).inc()
    except Exception:  # instrumentation must never fail a checkpoint
        pass


def _note_background_save(seconds: float) -> None:
    """Book a background writer's wall time with the goodput tracker's
    off-driver ledger (``checkpoint_async_write``)."""
    tracker = _goodput.get_goodput_tracker()
    if tracker.enabled:
        tracker.note_background("checkpoint_async_write", seconds)


def _with_write_retries(fn, what: str) -> None:
    """Run a write attempt, retrying transient failures (``OSError`` and
    :class:`FaultInjectedError`, so chaos tests drive this loop) with
    capped exponential backoff."""
    retries = int(os.environ.get(_ENV_RETRIES, "3"))
    delay = float(os.environ.get(_ENV_BACKOFF, "0.1"))
    for attempt in range(retries + 1):
        try:
            if faults.ARMED:
                faults.check("ckpt.write")
            fn()
            return
        except (OSError, FaultInjectedError) as exc:
            if attempt >= retries:
                raise
            _count("checkpoint.retries")
            warnings.warn(
                f"{what} attempt {attempt + 1} failed transiently ({exc!r}); "
                f"retrying in {min(delay, _BACKOFF_CAP_S):.2f}s "
                f"({retries - attempt} left)", stacklevel=3)
            _retry_sleep(min(delay, _BACKOFF_CAP_S))
            delay *= 2.0


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename or create inside it is durable."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _layout_marker_path(path: str) -> str:
    return path.rstrip(os.sep) + ".fluxmpi_layout"


def _write_layout_marker(path: str, layout: str) -> None:
    """Write the commit marker, fsync'd with its directory entry: once this
    returns, the step is durably committed."""
    marker = _layout_marker_path(path)
    with open(marker, "w") as f:
        f.write(layout)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(os.path.dirname(marker))


def _read_layout_marker(path: str) -> str | None:
    marker = _layout_marker_path(path)
    if os.path.exists(marker):
        with open(marker) as f:
            return f.read().strip()
    return None


def _decommit(path: str) -> None:
    """Remove a step: the marker first, so an interrupted cleanup leaves
    nothing discovery would believe."""
    with contextlib.suppress(FileNotFoundError):
        os.remove(_layout_marker_path(path))
    with contextlib.suppress(FileNotFoundError, OSError):
        os.remove(_manifest.manifest_path(path))
    shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# Snapshot and commit
# ---------------------------------------------------------------------------


class _Snapshot(NamedTuple):
    """Host copies of a state's leaves (keyed by path), its manifest, and
    the CUDA event after the device-to-host copies (None on the CPU)."""

    tensors: dict
    manifest: dict
    ready: Any


def _snapshot(state: Any) -> _Snapshot:
    """Copy ``state`` to host memory on the caller's thread. CUDA leaves
    go into pinned buffers by copies queued on their device's current
    stream: the in-place updates of later steps are queued after them, so
    the bytes are this step's; the returned event marks their end."""
    if faults.ARMED:
        faults.check("ckpt.snapshot")
    tensors: dict[str, torch.Tensor] = {}
    cuda_device = None
    for path, leaf in _manifest.named_leaves(state):
        t = _manifest.leaf_tensor(leaf)
        if t is None:
            continue
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            cuda_device = t.device
        else:
            host = t.clone()
        tensors[path] = host
    ready = None
    if cuda_device is not None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(cuda_device))
    return _Snapshot(tensors, _manifest.build_manifest(state, layout=_LAYOUT),
                     ready)


def _commit(path: str, snap: _Snapshot, *, step: int | None) -> None:
    """The commit protocol for one snapshot (lead worker): stage in
    ``<path>.tmp``, decommit any old step, rename, manifest, marker."""
    tmp = path + ".tmp"
    if snap.ready is not None:
        snap.ready.synchronize()

    def attempt():
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _DATA), "wb") as f:
            torch.save(snap.tensors, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)

    try:
        _with_write_retries(attempt, f"checkpoint write to {tmp}")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _decommit(path)
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))
    if faults.ARMED:
        # A crash here leaves a renamed directory without manifest or
        # marker: uncommitted, quarantined at the next start.
        faults.check("ckpt.manifest")
    try:
        _manifest.write_manifest(path, {**snap.manifest, "step": step,
                                        "time_unix": time.time()})
    except (OSError, ValueError) as exc:
        warnings.warn(f"could not write the manifest beside {path} ({exc!r}); "
                      f"committing the checkpoint without it", stacklevel=2)
    if faults.ARMED:
        faults.check("ckpt.commit")
    _write_layout_marker(path, _LAYOUT)


def _refuse_overwrite(path: str, force: bool) -> None:
    if not force and (os.path.exists(_layout_marker_path(path))
                      or os.path.exists(path)):
        raise FileExistsError(f"checkpoint already exists at {path} (pass "
                              f"force=True to overwrite)")


def save_checkpoint(path: str, state: Any, *, force: bool = True,
                    step: int | None = None) -> None:
    """Write ``state`` (a ``TrainState``, a ``train_loop`` payload, or any
    tree of tensors, numpy arrays and numbers) to ``path``, crash
    consistently. Every worker calls it; the lead worker writes.
    ``force=False`` refuses to overwrite an existing checkpoint
    (``FileExistsError``). ``step`` is recorded in the manifest."""
    with _goodput.segment("checkpoint_save"):
        path = os.path.abspath(path)
        _refuse_overwrite(path, force)
        if _is_lead():
            _commit(path, _snapshot(state), step=step)


def _place(path: str, like: Any, value: torch.Tensor) -> Any:
    """``value`` laid out as the template leaf ``like``: a tensor on its
    device and dtype, or a number of its type. Refuses a shape change."""
    want = _manifest.leaf_tensor(like)
    if tuple(value.shape) != tuple(want.shape):
        raise ValueError(f"checkpoint leaf {path!r} shape {tuple(value.shape)} "
                         f"does not match expected {tuple(want.shape)}")
    if torch.is_tensor(like):
        return value.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(value.item())
    return value.numpy().astype(like.dtype)


def _read_values(path: str, like: Any, manifest: Any) -> dict[str, torch.Tensor]:
    """The checkpoint's leaves for ``like``'s paths, in ``like``'s dtypes
    (on the root)."""
    saved = _read_layout_marker(path)
    if saved is not None and saved != _LAYOUT:
        raise ValueError(f"checkpoint at {path} was saved with {saved} layout; "
                         f"the port restores the {_LAYOUT} layout only")
    man = _manifest.read_manifest(path) if manifest is _MANIFEST_UNREAD else manifest
    if man is not None:
        _manifest.check_manifest_shapes(man, like)
    data = torch.load(os.path.join(path, _DATA), map_location="cpu",
                      weights_only=True)
    values = {}
    for p, leaf in _manifest.named_leaves(like):
        want = _manifest.leaf_tensor(leaf)
        if want is None:
            continue
        if p not in data:
            raise ValueError(f"checkpoint at {path} has no leaf {p!r}: it was "
                             f"saved from another structure")
        v = data[p]
        if tuple(v.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {p!r} shape {tuple(v.shape)} does "
                             f"not match expected {tuple(want.shape)}")
        values[p] = v.to(want.dtype)
    return values


# "Not passed: read it from disk"; None means "looked, and there is none".
_MANIFEST_UNREAD = object()


def _bcast_status(exc: BaseException | None, root: int) -> None:
    """Tell every worker whether the root's step succeeded; the others
    raise what the root raised."""
    status = [None if exc is None else (type(exc).__name__, str(exc))]
    dist.broadcast_object_list(status, src=root)
    if status[0] is not None and exc is None:
        kind, msg = status[0]
        err = FileNotFoundError if kind == "FileNotFoundError" else RuntimeError
        raise err(f"the root worker failed to restore: {kind}: {msg}")


def restore_checkpoint(path: str, like: Any, *, root_rank: int = 0,
                       allow_layout_change: bool = False, rule: Any = None,
                       parallel: Any = None,
                       manifest: Any = _MANIFEST_UNREAD) -> Any:
    """Read the checkpoint at ``path`` on ``root_rank`` and return it laid
    out like ``like`` (same structure; tensors on its leaves' devices and
    dtypes, numbers as numbers) on every worker. ``like`` is not changed.
    A leaf missing from the checkpoint or of another shape raises
    ``ValueError``. ``manifest``: a manifest the caller already read
    (``None`` for "absent"), to skip a second read. The elastic path's
    ``allow_layout_change``, ``rule`` and ``parallel`` are not ported yet
    (``NotImplementedError``)."""
    refuse_unported("restore_checkpoint", {
        "allow_layout_change": bool(allow_layout_change),
        "rule": rule is not None, "parallel": parallel is not None})
    with _goodput.segment("checkpoint_restore"):
        return _restore(path, like, root_rank, manifest)


def _restore(path: str, like: Any, root_rank: int, manifest: Any) -> Any:
    if faults.ARMED:
        faults.check("ckpt.read")
    path = os.path.abspath(path)
    rank, world = _world()
    values = None
    err = None
    if rank == root_rank:
        try:
            values = _read_values(path, like, manifest)
        except BaseException as exc:  # re-raised below, after telling peers
            err = exc
    if world > 1:
        _bcast_status(err, root_rank)
    if err is not None:
        raise err
    if world > 1:
        if values is None:
            values = {p: _manifest.leaf_tensor(leaf)
                      for p, leaf in _manifest.named_leaves(like)
                      if _manifest.leaf_tensor(leaf) is not None}
        from ..sync import synchronize

        values = synchronize(values, root_rank=root_rank)
    return _manifest.map_with_path(
        lambda p, leaf: leaf if p not in values else _place(p, leaf, values[p]),
        like)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


def _gather_steps(step: int) -> tuple[int, int] | None:
    """(min, max) of every worker's step, or None in a world of one. One
    all-reduce on the caller's thread."""
    if _world()[1] == 1:
        return None
    both = comm.allreduce(torch.tensor([-step, step], dtype=torch.int64), op="max")
    return -int(both[0]), int(both[1])


class CheckpointManager:
    """A training run's checkpoints under ``directory``:

    - step directories ``<dir>/step_00000042``, committed by their marker;
    - keep-k retention (``max_to_keep``), oldest deleted after each save;
    - async saves (``async_save``, default on unless
      ``FLUXMPI_TPU_CKPT_ASYNC=0``; per call ``save(async_=...)``): the
      caller pays the host snapshot, one background writer runs the
      commit protocol (site ``ckpt.async_write``). At most one write is in
      flight; a newer request replaces a queued one (counted in
      ``superseded``). A background failure is raised by the next
      ``save``, ``wait_until_finished``, ``restore`` or ``close``;
    - a local fast tier (``local_dir``, or ``FLUXMPI_TPU_CKPT_LOCAL_DIR``):
      saves commit there first and are then promoted to ``directory`` with
      the same ordering; the tiers keep ``local_max_to_keep`` and
      ``max_to_keep`` steps, and a restore reads the fastest tier holding
      the step. A world of one worker only (per-host disks break the
      shared-storage contract); elsewhere it warns and uses ``directory``;
    - at start, uncommitted step directories and stale ``.tmp`` staging
      directories move to ``_quarantine/`` (lead worker);
    - before each save the workers agree on the step, or every one raises
      :class:`~fluxmpi_tpu_torch.errors.CheckpointDesyncError`.

    ``write_seconds`` lists the seconds each commit took (on the writer
    thread for async saves). Every method is called on every worker.
    """

    def __init__(self, directory: str, *, max_to_keep: int | None = 3,
                 async_save: bool | None = None, local_dir: str | None = None,
                 local_max_to_keep: int | None = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if async_save is None:
            async_save = os.environ.get(_ENV_ASYNC, "") != "0"
        self._async = bool(async_save)
        if local_dir is None:
            local_dir = os.environ.get(_ENV_LOCAL_DIR) or None
        if local_dir is not None and _world()[1] > 1:
            warnings.warn("CheckpointManager local_dir fast tier is for a "
                          "world of one worker; using the durable tier alone",
                          stacklevel=2)
            local_dir = None
        self.local_dir = os.path.abspath(local_dir) if local_dir is not None else None
        self.local_max_to_keep = local_max_to_keep
        self.quarantined: list[str] = []
        if _is_lead():
            os.makedirs(self.directory, exist_ok=True)
            self.quarantined = self._quarantine_partials(self.directory)
            if self.local_dir is not None:
                os.makedirs(self.local_dir, exist_ok=True)
                self.quarantined += self._quarantine_partials(self.local_dir)
        self._executor: ThreadPoolExecutor | None = None
        # Under _lock: the in-flight write (its writer drains _queued
        # before finishing), the one queued request, a stored failure.
        self._inflight: Future | None = None
        self._queued: tuple[int, _Snapshot, bool] | None = None
        self._async_error: BaseException | None = None
        self.superseded = 0
        self.write_seconds: list[float] = []
        self._lock = threading.Lock()

    @staticmethod
    def _quarantine_partials(directory: str) -> list[str]:
        """Move uncommitted step directories and staging directories into
        ``_quarantine/``; remove markers and manifests whose directory is
        gone. Returns the names."""
        qdir = os.path.join(directory, "_quarantine")
        moved, removed = [], []
        for name in sorted(os.listdir(directory)):
            full = os.path.join(directory, name)
            if not os.path.exists(full):
                continue  # moved with its step directory earlier
            partial = os.path.isdir(full) and (
                name.endswith(".tmp")
                or (_STEP_DIR_RE.match(name) and _read_layout_marker(full) is None))
            orphan = any(name.endswith(sfx) and not os.path.isdir(full[:-len(sfx)])
                         for sfx in (".fluxmpi_layout", ".manifest.json"))
            if orphan:
                os.remove(full)
                removed.append(name)
                continue
            if not partial:
                continue
            os.makedirs(qdir, exist_ok=True)
            target = os.path.join(qdir, name)
            suffix = 0
            while os.path.exists(target):
                suffix += 1
                target = os.path.join(qdir, f"{name}.{suffix}")
            os.rename(full, target)
            moved.append(name)
            sibling = _manifest.manifest_path(full)
            if os.path.exists(sibling):
                os.rename(sibling, target + ".manifest.json")
        if moved or removed:
            warnings.warn(
                f"quarantined partial checkpoint artifact(s) {moved} under "
                f"{qdir}, removed orphan marker/manifest file(s) {removed}: a "
                f"previous run stopped mid-save; the newest committed step is "
                f"unaffected", stacklevel=3)
        return moved + removed

    def _check_step_agreement(self, step: int) -> None:
        seen = _gather_steps(step)
        if seen is not None and seen[0] != seen[1]:
            raise CheckpointDesyncError(
                f"workers disagree on the checkpoint step (between {seen[0]} "
                f"and {seen[1]}; this worker: {step}): aborting the save "
                f"instead of banking a mixed-step checkpoint")

    def _step_path(self, step: int, directory: str | None = None) -> str:
        return os.path.join(self.directory if directory is None else directory,
                            f"step_{step:08d}")

    @staticmethod
    def _steps_in(directory: str) -> list[int]:
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_DIR_RE.match, names)
                      if m and _read_layout_marker(
                          os.path.join(directory, m.group(0))) is not None)

    def all_steps(self) -> list[int]:
        """Committed steps in any tier, ascending."""
        steps = set(self._steps_in(self.directory))
        if self.local_dir is not None:
            steps |= set(self._steps_in(self.local_dir))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def tier_of(self, step: int) -> str | None:
        """``"local"`` when the fast tier holds ``step`` committed, else
        ``"durable"`` when ``directory`` does, else None."""
        if self.local_dir is not None and _read_layout_marker(
                self._step_path(step, self.local_dir)) is not None:
            return "local"
        if _read_layout_marker(self._step_path(step)) is not None:
            return "durable"
        return None

    def _tier_path(self, step: int) -> str:
        if self.tier_of(step) == "local":
            return self._step_path(step, self.local_dir)
        return self._step_path(step)

    def _raise_async_error(self) -> None:
        with self._lock:
            err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def save(self, step: int, state: Any, *, force: bool = True,
             async_: bool | None = None) -> None:
        """Checkpoint ``state`` as ``step``.

        Async (``async_``, default the manager's ``async_save``): returns
        after the host snapshot; the background writer commits it. Sync:
        waits for any in-flight write, then commits inline. A stored
        background failure is raised first. Raises
        :class:`~fluxmpi_tpu_torch.errors.CheckpointDesyncError` when the
        workers disagree on ``step``, before any bytes move."""
        with _goodput.segment("checkpoint_save"):
            self._raise_async_error()
            self._check_step_agreement(step)
            if not _is_lead():
                return
            use_async = self._async if async_ is None else bool(async_)
            if not use_async:
                self.wait_until_finished()
                self._save_and_retain(step, _snapshot(state), force)
                return
            snap = _snapshot(state)
            with self._lock:
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="ckpt")
                if self._inflight is not None:
                    if self._queued is not None:
                        self.superseded += 1
                        _count("checkpoint.async_superseded")
                    self._queued = (step, snap, force)
                else:
                    self._inflight = self._executor.submit(self._async_writer,
                                                           step, snap, force)
                _count("checkpoint.async_saves")

    def _async_writer(self, step: int, snap: _Snapshot, force: bool) -> None:
        """Commit the snapshot, then the queued request until none is left.
        Never raises: a failure is stored for the caller's next call (and
        drops the queued request)."""
        while True:
            t0 = time.perf_counter()
            try:
                if faults.ARMED:
                    faults.check("ckpt.async_write")
                self._save_and_retain(step, snap, force)
            except BaseException as exc:
                with self._lock:
                    self._async_error = exc
                    self._queued = None
                    self._inflight = None
                return
            finally:
                _note_background_save(time.perf_counter() - t0)
            with self._lock:
                if self._queued is None:
                    self._inflight = None
                    return
                step, snap, force = self._queued
                self._queued = None

    def _retain(self, directory: str, keep_k: int | None, step: int) -> None:
        if keep_k is None:
            return
        steps = self._steps_in(directory)
        keep = set(steps[-keep_k:]) | {step}
        for s in steps:
            if s not in keep:
                _decommit(self._step_path(s, directory))

    def _save_and_retain(self, step: int, snap: _Snapshot, force: bool) -> None:
        t0 = time.perf_counter()
        target = self._step_path(step, self.local_dir)
        _refuse_overwrite(target, force)
        _commit(target, snap, step=step)
        if self.local_dir is None:
            self._retain(self.directory, self.max_to_keep, step)
        else:
            self._retain(self.local_dir, self.local_max_to_keep, step)
            self._promote(step)
            self._retain(self.directory, self.max_to_keep, step)
        self.write_seconds.append(time.perf_counter() - t0)

    def _promote(self, step: int) -> None:
        """Copy the locally committed ``step`` to ``directory`` in the
        commit order (stage, rename, manifest, marker)."""
        src, dst = self._step_path(step, self.local_dir), self._step_path(step)
        tmp = dst + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(src, tmp)
        _decommit(dst)
        os.rename(tmp, dst)
        _fsync_dir(os.path.dirname(dst))
        src_manifest = _manifest.manifest_path(src)
        if os.path.exists(src_manifest):
            shutil.copyfile(src_manifest, _manifest.manifest_path(dst))
        _write_layout_marker(dst, _read_layout_marker(src) or _LAYOUT)
        _count("checkpoint.promotions")

    def wait_until_finished(self) -> None:
        """Block until the in-flight write (and the queued one) has
        committed; raises a stored background failure."""
        while True:
            with self._lock:
                pending = self._inflight
            if pending is None:
                break
            _wait_with_diagnostic(pending, "in-flight async checkpoint save")
            with self._lock:
                if self._inflight is pending:
                    self._inflight = None
        self._raise_async_error()

    def read_manifest(self, step: int | None = None) -> dict[str, Any] | None:
        """The manifest of ``step`` (default the latest committed), or None
        when there is none."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        return _manifest.read_manifest(self._tier_path(step))

    def restore(self, like: Any, *, step: int | None = None,
                manifest: Any = _MANIFEST_UNREAD) -> tuple[int, Any]:
        """``(step, state)`` of ``step`` (default the latest committed, as
        the root worker sees it), laid out like ``like``; raises
        ``FileNotFoundError`` on every worker when there is none."""
        self.wait_until_finished()
        rank, world = _world()
        if step is None and rank == 0:
            step = self.latest_step()
        if world > 1:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {self.directory}")
        return step, restore_checkpoint(self._tier_path(step), like,
                                        manifest=manifest)

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
