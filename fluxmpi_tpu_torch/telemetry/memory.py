"""Device-memory accounting and OOM forensics (counterpart of
:mod:`fluxmpi_tpu.telemetry.memory`, on the CUDA caching allocator).

A CUDA out-of-memory error names the failed allocation, not what was
already resident, and a preempted or crashed process is gone before
anyone can attach a debugger. This module gives the device-memory story
three surfaces:

- **normalized per-device stats** — :func:`device_memory_stats` is the
  ONE copy of the normalization onto the schema's ``memory.*`` keys
  (``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``; the CPU
  yields ``{}``), shared by
  :class:`~fluxmpi_tpu_torch.telemetry.monitor.TrainingMonitor` and
  everything here. On the card ``bytes_in_use`` is the allocator's
  ``allocated_bytes.all.current`` (``torch.cuda.memory_stats``),
  ``peak_bytes_in_use`` is ``torch.cuda.max_memory_allocated`` and
  ``bytes_limit`` is what the allocator could hold: what it reserved
  (``torch.cuda.memory_reserved``) plus what the card has free
  (``torch.cuda.mem_get_info``);
- **live gauges + peak watermark** — :func:`record_hbm` emits
  closed-namespace ``memory.*`` gauges per local device and maintains a
  process-lifetime high-water mark (``memory.peak_watermark_bytes``);
  when the plane is enabled, ``TrainingMonitor.collect`` folds the local
  peak into its existing single ``host_allgather``, so the world's
  min/max/mean memory pressure costs zero extra collectives;
- **the census** — :func:`census` walks the live CUDA tensors (the
  garbage collector's objects) and returns the top-N by bytes with
  shape, dtype and device — the "what was resident" answer;
- **OOM forensics** — :func:`write_oom_bundle` assembles a
  ``fluxmpi_oom.<process>.json`` bundle (the census, per-device stats,
  the watermark, and the watchdog's full dump sections — thread stacks,
  flight-recorder tail, open spans, final registry flush) validated by
  the same schema machinery as the JAX package's.
  :func:`~fluxmpi_tpu_torch.parallel.train_loop` catches a
  ``torch.cuda.OutOfMemoryError`` escaping its dispatch loop, writes the
  bundle, and re-raises.

Zero-cost-when-off: the plane's periodic surfaces (gauges, the monitor
fold) are gated on :func:`enabled` (``init(memory=True)`` /
``FLUXMPI_TPU_MEMORY=1`` — env/init-driven, hence the same on every
process for the allgather width); census walks happen only on demand or
on the OOM error path, never in steady state.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from .registry import MetricsRegistry, get_registry
from .registry import process_index_or_zero as _process_index

__all__ = [
    "device_memory_stats",
    "record_hbm",
    "peak_watermark_bytes",
    "census",
    "is_oom_error",
    "oom_dump_path",
    "write_oom_bundle",
    "enabled",
    "configure",
    "shutdown",
    "STATS_KEYS",
]

_ENV_VAR = "FLUXMPI_TPU_MEMORY"
_ENV_OOM_DIR = "FLUXMPI_TPU_OOM_DIR"

# The memory_stats() keys every consumer reads, in one place. Backends
# report more (num_allocs, largest_alloc_size, pool sizes); these three
# are the device-memory story: current residency, the allocator's
# high-water mark, and the capacity it is allowed to fill.
STATS_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

_enabled = False
_watermark = 0.0
_watermark_lock = threading.Lock()


def enabled() -> bool:
    """Whether the periodic device-memory surfaces (gauges + monitor fold) are on."""
    return _enabled


def device_memory_stats(device: Any) -> dict[str, float]:
    """The caching allocator's stats for a CUDA ``device`` normalized to
    the :data:`STATS_KEYS` as floats; ``{}`` for the CPU or a device
    that raises. The single copy of this normalization — TrainingMonitor
    and the OOM bundle both read through it."""
    try:
        import torch

        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(dev)
        free, _total = torch.cuda.mem_get_info(dev)
        return {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": float(torch.cuda.memory_reserved(dev) + free),
        }
    except Exception:  # a device that cannot report
        return {}


def _local_devices() -> list[Any]:
    """The devices this process drives: the worker's device once the
    runtime is up, else the current CUDA device if CUDA is already in use
    (never initializing it), else none."""
    import torch

    from .. import runtime

    if runtime.is_initialized():
        return [runtime.worker_device()]
    if torch.cuda.is_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return []


def record_hbm(registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """Snapshot every local device's memory stats into ``memory.*`` gauges
    (labeled ``device=<CUDA index>``), advance the process-lifetime peak
    watermark, and return the snapshot::

        {"local_peak_bytes": <max peak over local devices, 0.0 if unknown>,
         "watermark_bytes": <process-lifetime max of the same>,
         "devices": {"0": {<normalized stats>}, ...}}

    Works regardless of :func:`enabled` (callers gate; the OOM path
    wants the snapshot even when the periodic plane is off). Gauges are
    skipped on a recording-disabled registry."""
    global _watermark
    reg = registry if registry is not None else get_registry()
    emit = getattr(reg, "enabled", True)
    devices: dict[str, dict[str, float]] = {}
    local_peak = 0.0
    for i, d in enumerate(_local_devices()):
        stats = device_memory_stats(d)
        label = str(d.index if getattr(d, "index", None) is not None else i)
        devices[label] = stats
        if emit:
            # Already normalized to STATS_KEYS, so every emitted name is
            # a schema-known member of the closed memory.* namespace.
            for key, val in stats.items():
                reg.gauge(f"memory.{key}", device=label).set(val)
        peak = stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0.0))
        local_peak = max(local_peak, peak)
    with _watermark_lock:
        _watermark = max(_watermark, local_peak)
        watermark = _watermark
    if emit:
        reg.gauge("memory.peak_watermark_bytes").set(watermark)
    return {
        "local_peak_bytes": local_peak,
        "watermark_bytes": watermark,
        "devices": devices,
    }


def peak_watermark_bytes() -> float:
    """Process-lifetime device-memory high-water mark observed by
    :func:`record_hbm` (0.0 before the first snapshot / on the CPU)."""
    return _watermark


def census(top_n: int = 10) -> dict[str, Any]:
    """Walk the live CUDA tensors and summarize residency: total count
    and bytes, plus the top ``top_n`` tensors by bytes with shape, dtype
    and device spelled out (``sharding``: a tensor lives on one device).
    This is a full-heap walk — call it on demand (OOM forensics, an
    interactive session), never per step."""
    import gc

    import torch

    entries: list[dict[str, Any]] = []
    count = 0
    total = 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): some module-level objects warn
            # when their __class__ is read.
            if not issubclass(type(obj), torch.Tensor) or not obj.is_cuda:
                continue
            nbytes = int(obj.numel() * obj.element_size())
            shape = [int(d) for d in obj.shape]
            dtype = str(obj.dtype).replace("torch.", "")
            sharding = str(obj.device)
        except Exception:
            # A tensor freed or torn between enumeration and inspection —
            # the census must describe the heap, not crash on its churn.
            continue
        count += 1
        total += nbytes
        entries.append(
            {
                "nbytes": nbytes,
                "shape": shape,
                "dtype": dtype,
                "sharding": sharding,
            }
        )
    entries.sort(key=lambda e: e["nbytes"], reverse=True)
    return {
        "count": count,
        "total_bytes": total,
        "top_n": int(top_n),
        "arrays": entries[: int(top_n)],
    }


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------


def is_oom_error(exc: BaseException) -> bool:
    """Whether an exception is a device-memory exhaustion: a
    ``torch.cuda.OutOfMemoryError``, or an error whose message says "out
    of memory" (allocator and NCCL messages that arrive as a plain
    ``RuntimeError``)."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    return "out of memory" in str(exc).lower()


def oom_dump_path(dump_dir: str | None = None) -> str:
    """Where the OOM bundle lands: ``fluxmpi_oom.<process>.json`` in
    ``dump_dir`` (default ``FLUXMPI_TPU_OOM_DIR`` or ``.``) — the
    stable-per-process-filename convention of the watchdog/anomaly
    bundles."""
    if dump_dir is None:
        dump_dir = os.environ.get(_ENV_OOM_DIR, ".")
    return os.path.join(dump_dir, f"fluxmpi_oom.{_process_index()}.json")


def write_oom_bundle(
    exc: BaseException,
    *,
    dump_dir: str | None = None,
    registry: MetricsRegistry | None = None,
    top_n: int = 15,
) -> str:
    """Write the OOM forensics bundle for ``exc`` and return its path.

    The bundle IS a ``watchdog_dump``-kind record (thread stacks,
    flight-recorder tail, open spans, final registry flush — the anomaly
    bundle's exact machinery) with an ``oom`` section: the error string,
    the live-array census, every local device's normalized stats, and
    the process-lifetime peak watermark. ``validate_watchdog_dump``
    (hence ``scripts/check_metrics_schema.py``) validates it."""
    from .watchdog import Watchdog, get_watchdog

    wd = get_watchdog()
    if wd is None:
        # An unarmed builder: build_dump never starts threads or
        # installs signals — it only assembles the record.
        wd = Watchdog(deadline=1.0, registry=registry)
    record = wd.build_dump("oom")
    snapshot = record_hbm(registry)
    record["oom"] = {
        "error": str(exc),
        "error_type": type(exc).__name__,
        "census": census(top_n),
        "devices": snapshot["devices"],
        "peak_watermark_bytes": snapshot["watermark_bytes"],
    }
    path = oom_dump_path(dump_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# Plane wiring (init kwarg / env var)
# ---------------------------------------------------------------------------


def configure(spec: Any = None) -> bool:
    """Wire the periodic device-memory plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_MEMORY`` (no-op when unset/empty);
    - ``False`` / ``"0"`` — disable;
    - ``True`` / ``"1"`` — enable.

    Returns the resulting enabled state. Called by
    ``fluxmpi_tpu_torch.init(memory=...)``; idempotent. Enablement is
    env/init-driven on every process, so the TrainingMonitor allgather
    payload width it controls stays SPMD-consistent."""
    global _enabled
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _enabled
    if spec is False or spec == "0":
        _enabled = False
        return _enabled
    if spec is True or spec == "1":
        _enabled = True
        return _enabled
    raise ValueError(
        f"memory plane spec must be a bool or '0'/'1'; got {spec!r}"
    )


def shutdown() -> None:
    """Disable the plane and drop the watermark — a high-water mark left
    over from a previous run would misattribute the next run's OOM (the
    fault-plane leak rule)."""
    global _enabled, _watermark
    _enabled = False
    with _watermark_lock:
        _watermark = 0.0
