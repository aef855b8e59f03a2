"""Checkpoint and resume: the replicated and the sharded layout, elastic
restore.

Counterpart of :mod:`fluxmpi_tpu.utils.checkpoint`. State that every
worker holds whole (data-parallel training) is written from the lead
worker and restored on the root, then broadcast (the reference's
load-on-root-then-``synchronize!`` flow). State laid out in blocks over a
mesh (FSDP and TP: tensors placed by
:func:`~fluxmpi_tpu_torch.parallel.sharding.shard_tree` or a plan's
``shard_state``, which carry their layout) is written and read by every
worker, each its own blocks: it never gathers on one worker.
:class:`CheckpointManager` runs the lifecycle of a training run.

**On disk, replicated.** A checkpoint at ``<path>`` is a directory
holding one file, ``state.pt``: a flat dict of CPU tensors keyed by each
leaf's flax-style path
(:func:`~fluxmpi_tpu_torch.utils.manifest.named_leaves`), written with
``torch.save`` and read with ``torch.load(weights_only=True)``. Python int
leaves ride as int32 scalars (a ``TrainState``'s step), the loop's
counters as int64, as in the JAX payload. Beside it sit the
``<path>.manifest.json`` sidecar (``fluxmpi_tpu.manifest/v1``) and the
``<path>.fluxmpi_layout`` commit marker (``replicated`` or ``sharded``),
with the JAX package's names.

**On disk, sharded.** The directory holds one file per worker,
``shard_<rank>.pt``: ``{"blocks": {path: tensor}, "offsets": {path:
[start, ...]}}``, the worker's blocks as CPU tensors keyed by leaf path,
each with its global start offset per dimension. Of the workers that hold
the same block (a leaf replicated over some axes) only the first writes
it; leaves with no layout (Python numbers, untagged tensors) are the lead
worker's. The manifest records every leaf's global shape, dtype and
partition spec and the mesh. A reader needs nothing else: a leaf is the
union of its blocks at their offsets. A restore onto M workers works out
each worker's new block per leaf and copies only the overlapping slices
out of the old files, opened with ``torch.load(mmap=True,
weights_only=True)``; no worker holds a whole sharded leaf, and a block
the files do not cover raises.

**Crash consistency** (the commit protocol): the bytes are written into
``<path>.tmp`` (fault site ``ckpt.write``, retried with capped exponential
backoff on ``OSError`` in a world of one worker), which is renamed to
``<path>``; the manifest is written (site ``ckpt.manifest`` before it),
and the fsync'd marker commits the step (site ``ckpt.commit`` before it).
Discovery believes committed steps only. An overwrite decommits the old
step only after the new bytes are staged, so a failed write leaves the
previous committed step intact. A sharded save runs the JAX package's
peer-failure protocol between named barriers over the runtime's
checkpoint group (gloo; ``ckpt_preclean``, ``ckpt_written``,
``ckpt_failcheck``, ``ckpt_abort``, ``ckpt_decommit``, ``ckpt_commit``,
``ckpt_save``, each also checking that every worker is at the same
barrier of the same path): a worker whose write fails leaves a
``<path>.tmp.write_failed.<rank>`` sentinel, and every worker then aborts
the save, the previous committed step untouched.

**Workers.** The path must be on storage every worker sees. Every worker
first agrees on the step (one all-reduce on the caller's thread; a
disagreement raises
:class:`~fluxmpi_tpu_torch.errors.CheckpointDesyncError` on every worker).

**Elastic restore.** ``restore_checkpoint(mesh=, rule=)`` (or
``parallel=``) builds the target layout from the rule or from the specs
the manifest banked (:func:`~fluxmpi_tpu_torch.utils.manifest.
sharded_template`; site ``elastic.restore`` fires before any bytes move),
so a checkpoint written by N workers restores on M; ``like`` then only
gives structure, global shapes and dtypes (meta tensors will do). A
replicated checkpoint restored onto a sharded layout is read on the root,
broadcast, and each worker keeps its block.

**Snapshots.** A save first copies the state to host memory on the
caller's thread (site ``ckpt.snapshot``), each worker its own blocks:
CUDA tensors into pinned buffers with copies queued on the current
stream, so the step's in-place updates queued after them cannot change
the bytes, and a CUDA event after the copies that the writer waits on
before it reads them. The writer touches no CUDA tensor.

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
``checkpoint.promotions`` count in the default registry; the manager posts
the live exporter's CHECKPOINT board.
"""

from __future__ import annotations

import contextlib
import glob
import math
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
from ..errors import CheckpointDesyncError, CheckpointTimeoutError, FaultInjectedError
from ..parallel.sharding import sharding_of, with_sharding
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
_SHARD_FILE = "shard_{}.pt"
_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")


class MissingLeafError(ValueError):
    """A leaf the template asks for is not in the checkpoint: it was saved
    from another structure (the reader ignores leaves the template does
    not ask for, so this is the one structure mismatch it sees)."""


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


def _with_write_retries(fn, what: str, *, collective: bool = False) -> None:
    """Run a write attempt, retrying transient failures (``OSError`` and
    :class:`FaultInjectedError`, so chaos tests drive this loop) with
    capped exponential backoff. ``collective=True`` (a sharded save in a
    world of several workers) makes one attempt: as in the JAX package, a
    failure then aborts the whole save on every worker through the
    peer-failure protocol, and the caller retries the save."""
    retries = 0 if collective else int(os.environ.get(_ENV_RETRIES, "3"))
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


def _process_barrier(name: str, failed: bool = False) -> bool:
    """A named barrier of every worker over the runtime's checkpoint group
    (gloo, never a device collective: a background save runs it while the
    training thread runs the step's collectives on their own groups).
    Returns whether any worker arrived ``failed``. The workers exchange
    the barrier's name, and a worker at another barrier (another step's
    save) raises :class:`CheckpointDesyncError` on every worker instead of
    pairing two different saves."""
    rank, world = _world()
    if world <= 1:
        return failed
    seen: list = [None] * world
    dist.all_gather_object(seen, (name, bool(failed)),
                           group=runtime.checkpoint_group())
    names = [n for n, _ in seen]
    if len(set(names)) > 1:
        raise CheckpointDesyncError(
            f"workers are at different checkpoint barriers: {names} (this "
            f"worker, {rank}: {name!r}); aborting instead of pairing two saves")
    return any(f for _, f in seen)


def _peer_write_failures(tmp: str) -> list[int]:
    """The ranks whose write failed terminally, read from the
    ``<tmp>.write_failed.<rank>`` sentinels on the shared checkpoint
    storage (every worker reads them after the ``ckpt_written`` barrier,
    so all have landed). Module-level so tests can fake a failed peer."""
    return sorted(int(s.rsplit(".", 1)[-1])
                  for s in glob.glob(glob.escape(tmp) + ".write_failed.*"))


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


def _is_sharded_tree(tree: Any) -> bool:
    """Does some leaf sit in a block of a layout that splits it over more
    than one worker (an FSDP/TP state)? Those never gather on one
    worker."""
    return any((sh := sharding_of(leaf)) is not None and sh.is_sharded
               for _, leaf in _manifest.named_leaves(tree))


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


def _check_layout(path: str, expected: str) -> None:
    saved = _read_layout_marker(path)
    if saved is not None and saved != expected:
        raise ValueError(
            f"checkpoint at {path} was saved with {saved} layout but the "
            f"restore template is {expected}: restoring a sharded (FSDP/TP) "
            "checkpoint needs a `like` tree carrying the training shardings "
            "(and vice versa) — re-shard the template with shard_tree, or "
            "pass allow_layout_change=True to cross layout families "
            "deliberately"
        )


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
    """Host copies of the leaves this worker writes (keyed by path), their
    global start offsets (sharded layout; None for the replicated one), the
    manifest, and the CUDA event after the device-to-host copies (None on
    the CPU)."""

    tensors: dict
    offsets: dict | None
    manifest: dict
    ready: Any


def _snapshot(state: Any) -> _Snapshot:
    """Copy ``state`` to host memory on the caller's thread: every leaf
    for the replicated layout; for the sharded one, the blocks this
    worker writes (module docstring). CUDA leaves go into pinned buffers
    by copies queued on their device's current stream: the in-place
    updates of later steps are queued after them, so the bytes are this
    step's; the returned event marks their end."""
    if faults.ARMED:
        faults.check("ckpt.snapshot")
    sharded = _is_sharded_tree(state)
    lead = _is_lead()
    tensors: dict[str, torch.Tensor] = {}
    offsets: dict[str, list[int]] | None = {} if sharded else None
    cuda_device = None
    for path, leaf in _manifest.named_leaves(state):
        t = _manifest.leaf_tensor(leaf)
        if t is None:
            continue
        if sharded:
            sh = sharding_of(leaf)
            if sh is None:
                if not lead:
                    continue
                offsets[path] = [0] * t.ndim
            else:
                if not sh.owns_block():
                    continue
                offsets[path] = list(sh.block_start(sh.global_shape(t.shape)))
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
    layout = "sharded" if sharded else "replicated"
    return _Snapshot(tensors, offsets, _manifest.build_manifest(state, layout=layout),
                     ready)


def _write_file(target: str, obj: Any) -> None:
    with open(target, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _finish_commit(path: str, snap: _Snapshot, step: int | None) -> None:
    """The lead's part after the rename: manifest, autotune sidecar, and
    (for the replicated layout) the marker."""
    if faults.ARMED:
        # A crash here leaves a renamed directory without manifest or
        # marker: uncommitted, quarantined at the next start.
        faults.check("ckpt.manifest")
    try:
        _manifest.write_manifest(path, {**snap.manifest, "step": step,
                                        "time_unix": time.time()})
    except (OSError, ValueError) as exc:
        warnings.warn(f"could not write the manifest beside {path} ({exc!r}); "
                      f"committing the checkpoint without it", stacklevel=3)
    # Under the layout autotuner's winning plan its banked record rides
    # beside the manifest (<path>.autotune.json), best-effort like it.
    try:
        from ..parallel.autotune import write_bank_sidecar

        write_bank_sidecar(path)
    except Exception:
        pass
    if faults.ARMED:
        faults.check("ckpt.commit")


def _commit(path: str, snap: _Snapshot, *, step: int | None) -> None:
    """The commit protocol for one snapshot: the replicated layout on the
    lead worker, the sharded one on every worker."""
    if snap.offsets is not None:
        _commit_sharded(path, snap, step)
        return
    tmp = path + ".tmp"
    if snap.ready is not None:
        snap.ready.synchronize()

    def attempt():
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_file(os.path.join(tmp, _DATA), snap.tensors)
        _fsync_dir(tmp)

    try:
        _with_write_retries(attempt, f"checkpoint write to {tmp}")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _decommit(path)
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))
    _finish_commit(path, snap, step)
    _write_layout_marker(path, "replicated")


def _commit_sharded(path: str, snap: _Snapshot, step: int | None) -> None:
    """Every worker writes ``shard_<rank>.pt`` into ``<path>.tmp``; a
    failure on any worker aborts the save on every worker (the peer
    sentinels, read between barriers); then the lead decommits the old
    step, renames, writes the manifest and commits."""
    rank, world = _world()
    lead = rank == 0
    tmp = path + ".tmp"
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)  # a stale staging directory
        for stale in glob.glob(glob.escape(tmp) + ".write_failed.*"):
            with contextlib.suppress(OSError):
                os.remove(stale)
    _process_barrier(f"ckpt_preclean:{path}")
    if snap.ready is not None:
        snap.ready.synchronize()

    def attempt():
        os.makedirs(tmp, exist_ok=True)
        _write_file(os.path.join(tmp, _SHARD_FILE.format(rank)),
                    {"blocks": snap.tensors, "offsets": snap.offsets})
        _fsync_dir(tmp)

    write_exc: BaseException | None = None
    try:
        _with_write_retries(attempt, f"sharded checkpoint write to {tmp}",
                            collective=world > 1)
    except (OSError, FaultInjectedError) as exc:
        # Tell the peers through the shared storage before the barrier, so
        # after it every worker reads the same failed set.
        write_exc = exc
        with contextlib.suppress(OSError):
            with open(f"{tmp}.write_failed.{rank}", "w", encoding="utf-8") as f:
                f.write(repr(exc))
    _process_barrier(f"ckpt_written:{path}")
    failed = _peer_write_failures(tmp)
    # Every worker reads the failed set before any may remove a sentinel.
    _process_barrier(f"ckpt_failcheck:{path}")
    if write_exc is not None or failed:
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            for s in glob.glob(glob.escape(tmp) + ".write_failed.*"):
                with contextlib.suppress(OSError):
                    os.remove(s)
        _process_barrier(f"ckpt_abort:{path}")
        if write_exc is not None:
            raise write_exc
        raise OSError(
            f"checkpoint write to {tmp} failed on peer worker(s) {failed} "
            f"(see their logs); aborted on every worker — the previous "
            f"committed checkpoint at {path} is untouched")
    if lead:
        # Only now that every block is staged: a failed write above leaves
        # the previous committed step intact.
        _decommit(path)
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(path))
        _finish_commit(path, snap, step)
    _process_barrier(f"ckpt_commit:{path}")
    if lead:
        _write_layout_marker(path, "sharded")
    _process_barrier(f"ckpt_save:{path}")


def _refuse_overwrite(path: str, force: bool) -> None:
    if not force and (os.path.exists(_layout_marker_path(path))
                      or os.path.exists(path)):
        raise FileExistsError(f"checkpoint already exists at {path} (pass "
                              f"force=True to overwrite)")


def save_checkpoint(path: str, state: Any, *, force: bool = True,
                    step: int | None = None) -> None:
    """Write ``state`` (a ``TrainState``, a ``train_loop`` payload, or any
    tree of tensors, numpy arrays and numbers) to ``path``, crash
    consistently. Every worker calls it: the lead worker writes a
    replicated state, every worker its own blocks of a sharded one.
    ``force=False`` refuses to overwrite an existing checkpoint
    (``FileExistsError``). ``step`` is recorded in the manifest."""
    with _goodput.segment("checkpoint_save"):
        path = os.path.abspath(path)
        _refuse_overwrite(path, force)
        if _is_sharded_tree(state):
            _commit(path, _snapshot(state), step=step)
            return
        _lead_writes(path, lambda: _commit(path, _snapshot(state), step=step))


def _lead_writes(path: str, write) -> None:
    """A replicated save on every worker: the lead runs ``write``, and
    then every worker meets at the ``ckpt_save`` barrier, so no worker
    returns before the step is committed (a restore or ``latest_step()``
    right after must find it), nor succeeds when the lead's write failed.
    Alone in its world the worker just writes."""
    if _world()[1] == 1:
        write()
        return
    err = None
    if _is_lead():
        try:
            write()
        except BaseException as exc:  # re-raised after telling the peers
            err = exc
    if _process_barrier(f"ckpt_save:{path}", failed=err is not None) and err is None:
        raise OSError(f"checkpoint save to {path} failed on the lead worker "
                      f"(see its log); the previous committed step is intact")
    if err is not None:
        raise err


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _target_device(like: torch.Tensor) -> torch.device:
    """Where a restored leaf lands: ``like``'s device, or for a meta
    template the runtime's worker device (the CPU before ``init``)."""
    if like.device.type != "meta":
        return like.device
    return runtime.worker_device() if runtime.is_initialized() else torch.device("cpu")


def _place(path: str, like: Any, value: torch.Tensor, sharding: Any = None) -> Any:
    """``value`` laid out as the template leaf ``like``: a tensor on its
    device (see :func:`_target_device`) and dtype, tagged with its block
    layout ``sharding`` when it has one, or a number of its type. Refuses
    a shape change."""
    want = _manifest.leaf_tensor(like)
    shape = tuple(want.shape) if sharding is None else sharding.shard_shape(
        _manifest.global_shape(like))
    if tuple(value.shape) != shape:
        raise ValueError(f"checkpoint leaf {path!r} shape {tuple(value.shape)} "
                         f"does not match expected {shape}")
    if torch.is_tensor(like):
        return with_sharding(value.to(device=_target_device(like), dtype=like.dtype),
                             sharding)
    if isinstance(like, (bool, int, float)):
        return type(like)(value.item())
    return value.numpy().astype(like.dtype)


def _read_values(path: str, like: Any) -> dict[str, torch.Tensor]:
    """The replicated checkpoint's leaves for ``like``'s paths at their
    global shapes, in ``like``'s dtypes (on the root)."""
    data = torch.load(os.path.join(path, _DATA), map_location="cpu",
                      weights_only=True)
    values = {}
    for p, leaf in _manifest.named_leaves(like):
        want = _manifest.leaf_tensor(leaf)
        if want is None:
            continue
        if p not in data:
            raise MissingLeafError(f"checkpoint at {path} has no leaf {p!r}: it "
                                   f"was saved from another structure")
        v = data[p]
        shape = _manifest.global_shape(leaf)
        if tuple(v.shape) != shape:
            raise ValueError(f"checkpoint leaf {p!r} shape {tuple(v.shape)} does "
                             f"not match expected {shape}")
        values[p] = v.to(want.dtype)
    return values


def _read_blocks(path: str, like: Any, targets: Any) -> dict[str, torch.Tensor]:
    """This worker's block of every leaf of ``like`` under the layout the
    matching leaf of ``targets`` carries (whole leaves where it has
    none), copied slice by slice out of the memory-mapped shard files of
    the sharded checkpoint at ``path``. A block the files do not cover
    whole raises."""
    files = sorted(glob.glob(os.path.join(glob.escape(path), "shard_*.pt")))
    if not files:
        raise FileNotFoundError(f"sharded checkpoint at {path} has no shard files")
    shards = [torch.load(f, map_location="cpu", mmap=True, weights_only=True)
              for f in files]
    layout = dict(_manifest.named_leaves(targets))
    values = {}
    for p, leaf in _manifest.named_leaves(like):
        want = _manifest.leaf_tensor(leaf)
        if want is None:
            continue
        gshape = _manifest.global_shape(leaf)
        sh = sharding_of(layout.get(p))
        start = sh.block_start(gshape) if sh is not None else (0,) * len(gshape)
        shape = sh.shard_shape(gshape) if sh is not None else gshape
        if not any(p in shard["blocks"] for shard in shards):
            raise MissingLeafError(f"sharded checkpoint at {path} has no leaf "
                                   f"{p!r}: it was saved from another structure")
        out = torch.empty(shape, dtype=want.dtype)
        covered = 0
        for shard in shards:
            block = shard["blocks"].get(p)
            if block is None:
                continue
            at = shard["offsets"][p]
            if len(at) != len(gshape) or any(
                    a + b > g for a, b, g in zip(at, block.shape, gshape)):
                raise ValueError(f"checkpoint leaf {p!r}: a saved block of shape "
                                 f"{tuple(block.shape)} at {list(at)} does not "
                                 f"fit the expected shape {gshape}")
            lo = [max(s, a) for s, a in zip(start, at)]
            hi = [min(s + n, a + b) for s, n, a, b in zip(start, shape, at, block.shape)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            src = block[tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, at))]
            out[tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, start))].copy_(src)
            covered += math.prod(h - l for l, h in zip(lo, hi))
        if covered != math.prod(shape):
            raise ValueError(
                f"sharded checkpoint at {path} does not cover this worker's "
                f"block of leaf {p!r} (shape {tuple(shape)} at {list(start)} of "
                f"{gshape}): {covered} of {math.prod(shape)} elements found — "
                f"it was saved from another structure, or a shard file is "
                f"missing")
        values[p] = out
    return values


# "Not passed: read it from disk"; None means "looked, and there is none".
_MANIFEST_UNREAD = object()

# One warning per checkpoint path per process (lead worker only).
_warned_missing_manifest: set[str] = set()
_warned_missing_marker: set[str] = set()


def _warn_once(cache: set[str], path: str, message: str) -> None:
    if not _is_lead() or path in cache:
        return
    cache.add(path)
    warnings.warn(message, stacklevel=4)


def _bcast_status(exc: BaseException | None, root: int) -> None:
    """Tell every worker whether the root's step succeeded; the others
    raise what the root raised."""
    status = [None if exc is None else (type(exc).__name__, str(exc))]
    dist.broadcast_object_list(status, src=root)
    if status[0] is not None and exc is None:
        kind, msg = status[0]
        err = {"FileNotFoundError": FileNotFoundError,
               "MissingLeafError": MissingLeafError}.get(kind, RuntimeError)
        raise err(f"the root worker failed to restore: {kind}: {msg}")


def restore_checkpoint(path: str, like: Any, *, root_rank: int = 0,
                       allow_layout_change: bool = False, mesh: Any = None,
                       rule: Any = None, parallel: Any = None,
                       manifest: Any = _MANIFEST_UNREAD) -> Any:
    """Read the checkpoint at ``path`` and return it laid out like
    ``like`` (same structure; tensors on its leaves' devices and dtypes,
    numbers as numbers) on every worker. ``like`` is not changed. A leaf
    missing from the checkpoint or of another shape raises ``ValueError``.

    A replicated checkpoint is read on ``root_rank`` and broadcast. A
    ``like`` whose tensors are placed blocks (FSDP/TP) restores the
    sharded checkpoint each worker its own blocks, in ``like``'s layout,
    whatever layout over however many workers wrote it.

    Elastic restore: with ``mesh=`` (and optionally ``rule=``, a
    :data:`~fluxmpi_tpu_torch.parallel.sharding.Rule`) the target layout
    is built here, from the rule or from the partition specs the manifest
    banked, re-validated against the new mesh (a leaf the new mesh cannot
    express raises :class:`~fluxmpi_tpu_torch.errors.TopologyMismatchError`
    naming it); ``like`` then only gives structure, global shapes and
    dtypes (meta tensors will do: they land on the worker's device).
    ``parallel``: a :class:`~fluxmpi_tpu_torch.parallel.ParallelConfig` or
    resolved plan in place of ``mesh``/``rule`` (its mesh and combined
    rule). Crossing the replicated/sharded layout family without them is
    refused by the commit marker unless ``allow_layout_change=True``.

    ``manifest``: a manifest the caller already read (``None`` for
    "absent"), to skip a second read."""
    if parallel is not None:
        if mesh is not None or rule is not None:
            raise ValueError(
                "pass either parallel= (the plan supplies mesh AND rule) "
                "or explicit mesh=/rule=, not both")
        from ..parallel.plan import resolve_parallel

        plan = resolve_parallel(parallel)
        mesh, rule = plan.mesh, plan.rule
    with _goodput.segment("checkpoint_restore"):
        if faults.ARMED:
            faults.check("ckpt.read")
        path = os.path.abspath(path)
        man = _manifest.read_manifest(path) if manifest is _MANIFEST_UNREAD else manifest
        if man is None:
            _warn_once(
                _warned_missing_manifest, path,
                f"checkpoint at {path} has no topology manifest (it predates "
                f"elastic checkpoints); restoring the topology-blind way — "
                f"same-topology restores are unaffected, but a cross-topology "
                f"restore needs the like tree to carry the target shardings")
        if mesh is not None or rule is not None:
            return _restore_elastic(path, like, man, mesh, rule, root_rank)
        expected = "sharded" if _is_sharded_tree(like) else "replicated"
        if not allow_layout_change:
            _check_layout(path, expected)
        elif _read_layout_marker(path) is None:
            _warn_once(_warned_missing_marker, path,
                       f"checkpoint at {path} has no layout marker (it predates "
                       f"layout markers, or the save never committed); "
                       f"allow_layout_change=True cannot tell an old checkpoint "
                       f"from a wrong-family one here — verify the source run")
        if man is not None:
            _manifest.check_manifest_shapes(man, like)
        if _saved_layout(path, man, like) == "sharded":
            return _restore_blocks(path, like, like)
        return _restore_replicated(path, like, like, root_rank)


def _saved_layout(path: str, man: Any, like: Any) -> str:
    """The layout family the checkpoint at ``path`` was written in: its
    commit marker (written last), else the manifest's, else the one
    ``like`` asks for (a checkpoint that predates both)."""
    return (_read_layout_marker(path) or (man or {}).get("layout")
            or ("sharded" if _is_sharded_tree(like) else "replicated"))


def _restore_elastic(path: str, like: Any, man: Any, mesh: Any, rule: Any,
                     root_rank: int) -> Any:
    """The explicit elastic restore (``mesh=``/``rule=``): the target
    layout from the rule or the banked specs over ``mesh`` (default the
    runtime's), each leaf landing in its new block."""
    if faults.ARMED:
        faults.check("elastic.restore")
    if mesh is None:
        mesh = runtime.global_mesh()
    if man is not None:
        _manifest.check_manifest_shapes(man, like)
    elif rule is None:
        raise ValueError(
            f"elastic restore of {path} without a partition rule needs the "
            f"checkpoint manifest to know the saved partition specs, and "
            f"this checkpoint has none (written before elastic "
            f"checkpoints) — pass rule= for the new topology, or restore "
            f"with a like tree already carrying the target shardings")
    template = _manifest.sharded_template(like, man, mesh, rule)
    if _saved_layout(path, man, like) == "sharded":
        return _restore_blocks(path, like, template)
    return _restore_replicated(path, like, template, root_rank)


def _restore_blocks(path: str, like: Any, targets: Any) -> Any:
    """A sharded checkpoint, each worker reading its own blocks (no
    broadcast: every worker sees the files)."""
    values = _read_blocks(path, like, targets)
    layout = dict(_manifest.named_leaves(targets))
    return _manifest.map_with_path(
        lambda p, leaf: leaf if p not in values
        else _place(p, leaf, values[p], sharding_of(layout.get(p))), like)


def _restore_replicated(path: str, like: Any, targets: Any, root_rank: int) -> Any:
    """A replicated checkpoint: read on the root and broadcast; each
    worker keeps its block of a leaf whose target carries a layout."""
    rank, world = _world()
    values = None
    err = None
    if rank == root_rank:
        try:
            values = _read_values(path, like)
        except BaseException as exc:  # re-raised below, after telling peers
            err = exc
    if world > 1:
        _bcast_status(err, root_rank)
    if err is not None:
        raise err
    if world > 1:
        if values is None:
            values = {p: torch.empty(_manifest.global_shape(leaf),
                                     dtype=_manifest.leaf_tensor(leaf).dtype)
                      for p, leaf in _manifest.named_leaves(like)
                      if _manifest.leaf_tensor(leaf) is not None}
        from ..sync import synchronize

        values = synchronize(values, root_rank=root_rank)
    layout = dict(_manifest.named_leaves(targets))

    def put(p, leaf):
        if p not in values:
            return leaf
        sh = sharding_of(layout.get(p))
        value = values[p] if sh is None else sh.local_block(values[p])
        return _place(p, leaf, value, sh)

    return _manifest.map_with_path(put, like)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


def _gather_steps(step: int) -> tuple[int, int] | None:
    """(min, max) of every worker's step, or None in a world of one. One
    all-reduce on the caller's thread."""
    if _world()[1] == 1:
        return None
    both = comm.allreduce(torch.tensor([-step, step], dtype=torch.int64), op="max",
                          mesh=comm.WORLD)
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
      ``superseded``), but for a sharded state in a world of several
      workers a request waits for the in-flight write instead, so every
      worker commits the same steps. A background failure is raised by the
      next ``save``, ``wait_until_finished``, ``restore`` or ``close``;
    - a local fast tier (``local_dir``, or ``FLUXMPI_TPU_CKPT_LOCAL_DIR``):
      saves commit there first and are then promoted to ``directory`` with
      the same ordering; the tiers keep ``local_max_to_keep`` and
      ``max_to_keep`` steps, and a restore reads the fastest tier holding
      the step. A world of one worker only (per-host disks break the
      shared-storage contract); elsewhere it warns and uses ``directory``;
    - at start, uncommitted step directories and stale ``.tmp`` staging
      directories move to ``_quarantine/`` (lead worker; the others wait);
    - before each save the workers agree on the step, or every one raises
      :class:`~fluxmpi_tpu_torch.errors.CheckpointDesyncError`;
    - the live exporter's CHECKPOINT board (when it serves): the last
      committed step and its tier, the in-flight step and its start.

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
        # No worker restores against the sweep; the barrier's group comes
        # up here, on the training thread, before any background save.
        _process_barrier(f"ckpt_quarantine:{self.directory}")
        self._executor: ThreadPoolExecutor | None = None
        # Under _lock: the in-flight write (its writer drains _queued
        # before finishing), the one queued request, a stored failure.
        self._inflight: Future | None = None
        self._queued: tuple[int, _Snapshot, bool] | None = None
        self._async_error: BaseException | None = None
        self.superseded = 0
        self.write_seconds: list[float] = []
        self._inflight_step: int | None = None
        self._inflight_since: float | None = None
        self._last_committed: tuple[int, str] | None = None
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
            # A replicated state is written by the lead; every worker runs
            # the commit's barrier (C.23), so every worker's wait covers it.
            writes = _is_sharded_tree(state) or _is_lead()
            use_async = self._async if async_ is None else bool(async_)
            if not use_async:
                self.wait_until_finished()
                self._save_and_retain(step, _snapshot(state) if writes else None, force)
                self._note_board()
                return
            if _world()[1] > 1:
                # Every worker's writer runs the same barriers: no worker
                # may supersede a request another has started.
                self.wait_until_finished()
            snap = _snapshot(state) if writes else None
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
                    self._inflight_step = step
                    self._inflight_since = time.time()
                    self._inflight = self._executor.submit(self._async_writer,
                                                           step, snap, force)
                _count("checkpoint.async_saves")
        self._note_board()

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
                    self._inflight_step = self._inflight_since = None
                return
            finally:
                _note_background_save(time.perf_counter() - t0)
            with self._lock:
                if self._queued is None:
                    self._inflight = None
                    self._inflight_step = self._inflight_since = None
                    return
                step, snap, force = self._queued
                self._queued = None
                self._inflight_step = step
                self._inflight_since = time.time()

    def _retain(self, directory: str, keep_k: int | None, step: int) -> None:
        if keep_k is None or not _is_lead():
            return
        steps = self._steps_in(directory)
        keep = set(steps[-keep_k:]) | {step}
        for s in steps:
            if s not in keep:
                _decommit(self._step_path(s, directory))

    def _save_and_retain(self, step: int, snap: _Snapshot | None, force: bool) -> None:
        """Commit ``snap`` as ``step`` and apply the retention. A
        replicated state in a world of several workers: the lead writes
        (``snap`` is None on the others) and every worker returns after the
        lead's commit (:func:`_lead_writes`)."""
        if snap is not None and snap.offsets is not None:
            self._write(step, snap, force)
            return
        tier = "durable" if self.local_dir is None else "local"
        _lead_writes(self._step_path(step, self.local_dir),
                     lambda: self._write(step, snap, force))
        if snap is None:
            self._set_committed(step, tier)

    def _write(self, step: int, snap: _Snapshot, force: bool) -> None:
        t0 = time.perf_counter()
        target = self._step_path(step, self.local_dir)
        _refuse_overwrite(target, force)
        _commit(target, snap, step=step)
        if self.local_dir is None:
            self._retain(self.directory, self.max_to_keep, step)
            self._set_committed(step, "durable")
        else:
            self._retain(self.local_dir, self.local_max_to_keep, step)
            self._set_committed(step, "local")
            self._promote(step)
            self._retain(self.directory, self.max_to_keep, step)
        self.write_seconds.append(time.perf_counter() - t0)

    def _set_committed(self, step: int, tier: str) -> None:
        with self._lock:
            self._last_committed = (step, tier)
        self._note_board()

    def _note_board(self) -> None:
        """Post the CHECKPOINT board to the live exporter when one serves:
        the last committed step and its tier, the in-flight save's step
        and start. No exporter, no calls."""
        from ..telemetry import export as _export

        exporter = _export.get_exporter()
        if exporter is None or not exporter.enabled:
            return
        with self._lock:
            committed = self._last_committed
            fields: dict[str, Any] = {
                "last_committed_step": committed[0] if committed else None,
                "tier": committed[1] if committed else None,
                "async": self._async,
                "inflight_step": self._inflight_step,
                "inflight_since_unix": self._inflight_since,
                "superseded": self.superseded,
            }
        exporter.note_checkpoint(**fields)

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
        if os.path.exists(src + ".autotune.json"):
            shutil.copyfile(src + ".autotune.json", dst + ".autotune.json")
        _write_layout_marker(dst, _read_layout_marker(src) or "replicated")
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
                allow_layout_change: bool = False, mesh: Any = None,
                rule: Any = None, parallel: Any = None,
                manifest: Any = _MANIFEST_UNREAD) -> tuple[int, Any]:
        """``(step, state)`` of ``step`` (default the latest committed, as
        the root worker sees it), laid out like ``like``; raises
        ``FileNotFoundError`` on every worker when there is none.
        ``allow_layout_change``, ``mesh``, ``rule``, ``parallel`` and
        ``manifest`` go to :func:`restore_checkpoint` (the elastic
        restore)."""
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
        return step, restore_checkpoint(
            self._tier_path(step), like, allow_layout_change=allow_layout_change,
            mesh=mesh, rule=rule, parallel=parallel, manifest=manifest)

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
