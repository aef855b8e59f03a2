"""The runtime: device resolution, and bringing up the data-parallel world.

Counterpart of :mod:`fluxmpi_tpu.runtime` (the reference's ``FluxMPI.Init``).
The port runs on NVIDIA GPUs. Every entry point takes ``device=``; the
default is a CUDA device, and the CPU is used only when the caller names
it. A machine without CUDA is an error unless the caller asked for
``"cpu"``: nothing falls back to the CPU quietly.

:func:`init` brings up ``torch.distributed``: NCCL on CUDA, gloo on the
CPU. One worker is one process driving one device (the reference's one
rank per GPU), bound to ``cuda:(local_rank % device_count)``. The world
comes from the arguments, else from the launcher's environment
(``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun``
sets them), else it is a single process, which needs no launcher: its
store listens on an ephemeral localhost port. A process group the caller
already initialized is adopted as it is.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import warnings
from typing import Any, Sequence

import torch
import torch.distributed as dist

from .errors import FluxMPINotInitializedError, refuse_unported

__all__ = [
    "Initialized",
    "clear_preemption",
    "device_count",
    "init",
    "install_preemption_handlers",
    "is_initialized",
    "local_device_count",
    "local_rank",
    "note_graph_generator",
    "preemption_handlers_installed",
    "preemption_requested",
    "process_count",
    "process_index",
    "request_preemption",
    "resolve_device",
    "shutdown",
    "total_workers",
    "uninstall_preemption_handlers",
    "watch_graph_generators",
    "worker_device",
]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` → ``cuda:0``; ``"cpu"`` → the CPU; any CUDA
    device requires CUDA to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda", 0 if dev.index is None else dev.index)


class _State:
    initialized = False
    owns_group = False
    device: torch.device | None = None
    rank = 0
    world = 1
    local_rank = 0
    # The gloo group the host_* collectives run over: None at world 1,
    # the default group on the CPU, a gloo group beside NCCL on the card.
    host_group: Any = None


_state = _State()

# init() arguments of the JAX package whose machinery is not ported yet.
_WAITING = ("devices", "mesh_shape", "parallel", "distributed", "preemption",
            "faults", "anomaly", "model_stats", "compileplane", "profile",
            "compile_cache", "export", "serving", "request_log", "fleet",
            "resize")


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return None if val in (None, "") else int(val)


def _configure_planes(telemetry: Any, trace: Any, watchdog: Any,
                      goodput: Any, memory: Any) -> None:
    """Wire the telemetry planes in the JAX package's order (each from its
    argument, else its environment variable)."""
    from . import telemetry as _telemetry
    from .telemetry import goodput as _goodput
    from .telemetry import memory as _memory
    from .telemetry import tracing as _tracing
    from .telemetry import watchdog as _watchdog

    _telemetry.configure(telemetry)
    _tracing.configure(trace)
    _watchdog.configure(watchdog)
    _goodput.configure(goodput)
    _memory.configure(memory)


def init(*, device: str | torch.device | None = None,
         coordinator_address: str | None = None,
         num_processes: int | None = None, process_id: int | None = None,
         timeout: float = 600.0,
         verbose: bool = False, telemetry: Any = None, trace: Any = None,
         watchdog: Any = None, goodput: Any = None, memory: Any = None,
         **waiting) -> torch.device:
    """Bring up the data-parallel world; returns this worker's device.
    Idempotent: a second call returns the same device.

    ``device``: ``None`` (CUDA, NCCL) or ``"cpu"`` (gloo); a CUDA machine
    is required unless ``"cpu"`` is asked for. ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` name the world
    explicitly (the JAX package's spelling); otherwise the launcher's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` are read, and
    without them the world is this one process. The launcher's
    ``LOCAL_RANK`` (else the rank) picks the CUDA device,
    ``cuda:(local_rank % device_count)``. ``timeout`` bounds every
    collective, in seconds. ``verbose`` prints the world from every rank
    and warns when it has a single worker.

    The telemetry planes, as in the JAX package (each ``None`` defers to
    its environment variable; a repeated ``init`` re-wires them):
    ``telemetry`` — a JSONL path, ``"console"``/``True``, a
    :class:`~fluxmpi_tpu_torch.telemetry.Sink` or a
    :class:`~fluxmpi_tpu_torch.telemetry.MetricsRegistry`
    (``FLUXMPI_TPU_TELEMETRY``); ``trace`` — ``True`` or an export path
    (``{process}`` is formatted with the rank) written at
    :func:`shutdown` (``FLUXMPI_TPU_TRACE``); ``watchdog`` — a stall
    deadline in seconds or ``True`` for 300 s, dumps in
    ``FLUXMPI_TPU_WATCHDOG_DIR`` (``FLUXMPI_TPU_WATCHDOG``); ``goodput``
    — ``True`` for the wall-time buckets and live MFU
    (``FLUXMPI_TPU_GOODPUT``); ``memory`` — ``True`` for the ``memory.*``
    gauges (``FLUXMPI_TPU_MEMORY``).

    Not ported yet (each raises ``NotImplementedError`` when passed):
    device lists and mesh shapes, ``parallel=``, ``distributed=``, the
    preemption and fault specs, the compile cache, and the anomaly,
    model-stats, compile, profile, export, serving, request-log, fleet
    and resize planes.
    """
    passed = sorted(k for k, v in waiting.items() if v is not None)
    unknown = [k for k in passed if k not in _WAITING]
    if unknown:
        raise TypeError(f"init() got unexpected arguments {unknown}")
    refuse_unported("init", {k: True for k in passed},
                    "the port has no device mesh or parallel plans, and its "
                    "anomaly, model-stats, compile, profile, export, serving, "
                    "request-log, fleet, resize, fault-spec, preemption-spec "
                    "and compile-cache planes are not ported; it runs one "
                    "process per device with torch.distributed")
    if _state.initialized:
        _configure_planes(telemetry, trace, watchdog, goodput, memory)
        return _state.device
    want = resolve_device(device)
    cpu = want.type == "cpu"
    adopt = dist.is_initialized()
    if adopt:
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = process_id if process_id is not None else _env_int("RANK")
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        if (rank is None) != (world is None):
            raise ValueError("pass the process index and count together "
                             "(process_id/num_processes, or RANK/WORLD_SIZE)")
        rank, world = (0, 1) if rank is None else (int(rank), int(world))
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} out of range for {world} processes")
    lr = _env_int("LOCAL_RANK")
    lr = rank if lr is None else lr
    if cpu:
        dev = want
    else:
        # Bind before the group comes up, so NCCL uses this device.
        dev = torch.device("cuda", lr % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not adopt:
        kwargs = dict(backend="gloo" if cpu else "nccl", rank=rank,
                      world_size=world,
                      timeout=datetime.timedelta(seconds=timeout))
        if coordinator_address is not None:
            kwargs["init_method"] = f"tcp://{coordinator_address}"
        elif world > 1 or "MASTER_ADDR" in os.environ:
            kwargs["init_method"] = "env://"
        else:
            # A single process needs no launcher: a store on an ephemeral
            # localhost port, never a fixed one.
            kwargs["store"] = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                            timeout=kwargs["timeout"])
        dist.init_process_group(**kwargs)
    if world == 1:
        host_group = None
    elif dist.get_backend() == "gloo":
        host_group = dist.group.WORLD
    else:
        # Every rank creates it here, in the same order: new_group is
        # collective.
        host_group = dist.new_group(backend="gloo")
    _state.initialized = True
    _state.host_group = host_group
    _state.owns_group = not adopt
    _state.device = dev
    _state.rank, _state.world, _state.local_rank = rank, world, lr
    _configure_planes(telemetry, trace, watchdog, goodput, memory)
    if verbose:
        if world == 1:
            warnings.warn(
                "Using fluxmpi_tpu_torch with only 1 worker. It might be faster "
                "to run the code without the distributed wrappers.",
                stacklevel=2,
            )
        from .logging import fluxmpi_println

        fluxmpi_println(f"Initialized: {world} process(es), device {dev}, "
                        f"backend {dist.get_backend()}")
    return dev


def is_initialized() -> bool:
    """Has :func:`init` run (and :func:`shutdown` not since)?"""
    return _state.initialized


# Reference-spelling alias (``FluxMPI.Initialized``).
Initialized = is_initialized


def shutdown() -> None:
    """Reset the runtime: tear down the telemetry planes first (the
    watchdog disarmed, the trace ring exported to its configured path
    while the rank is still known, the sinks flushed and detached), then
    destroy the process group if :func:`init` created it (one the caller
    brought up stays)."""
    try:
        from .telemetry import shutdown as _telemetry_shutdown

        _telemetry_shutdown()
    except Exception:
        pass
    if _state.initialized and _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.initialized = False
    _state.owns_group = False
    _state.device = None
    _state.host_group = None
    _state.rank, _state.world, _state.local_rank = 0, 1, 0


def _require_init() -> None:
    if not _state.initialized:
        raise FluxMPINotInitializedError()


def local_rank() -> int:
    """Rank of this worker (process) in the world."""
    _require_init()
    return _state.rank


def total_workers() -> int:
    """Number of data-parallel workers: one per process and device."""
    _require_init()
    return _state.world


def process_index() -> int:
    """Index of this process in the world."""
    _require_init()
    return _state.rank


def process_count() -> int:
    """Number of processes in the world."""
    _require_init()
    return _state.world


def device_count() -> int:
    """Global device count (one device per process)."""
    _require_init()
    return _state.world


def local_device_count() -> int:
    """Devices addressable by this process: the CUDA devices it sees, or 1
    on the CPU backend."""
    _require_init()
    return torch.cuda.device_count() if _state.device.type == "cuda" else 1


def worker_device() -> torch.device:
    """The device :func:`init` bound this worker to."""
    _require_init()
    return _state.device


# ---------------------------------------------------------------------------
# Preemption: a signal sets a flag that train_loop polls.
#
# A preemptible card is taken back with SIGTERM and a grace window (an
# operator's Ctrl-C is SIGINT, handled alike). The
# handler runs between bytecodes on the main thread, so it only sets a
# flag (no locks, no I/O, no CUDA); train_loop polls the flag at dispatch
# boundaries, drains, banks an emergency checkpoint and returns with
# summary["preempted"] = True.
# ---------------------------------------------------------------------------


class _PreemptionState:
    requested = False
    signum: int | None = None


_preemption = _PreemptionState()
_prev_signal_handlers: dict[int, Any] = {}


def preemption_requested() -> bool:
    """Has a preemption signal (or :func:`request_preemption`) arrived?"""
    return _preemption.requested


def request_preemption(signum: int | None = None) -> None:
    """Set the preemption flag, as the signal handler does."""
    _preemption.requested = True
    _preemption.signum = signum


def clear_preemption() -> None:
    """Reset the flag."""
    _preemption.requested = False
    _preemption.signum = None


def _on_preemption_signal(signum: int, frame: Any) -> None:
    _preemption.requested = True
    _preemption.signum = signum


def install_preemption_handlers(
    signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT),
) -> None:
    """Install the flag-setting handler for ``signals`` (default SIGTERM
    and SIGINT, so Ctrl-C drains and banks too; idempotent; the previous
    handlers are kept for :func:`uninstall_preemption_handlers`). Only the
    main thread can install one; elsewhere the install is skipped with a
    warning, and :func:`request_preemption` still sets the flag."""
    for sig in signals:
        if sig in _prev_signal_handlers:
            continue
        try:
            _prev_signal_handlers[sig] = signal.signal(sig, _on_preemption_signal)
        except (ValueError, OSError) as exc:  # not the main thread
            warnings.warn(
                f"cannot install preemption handler for signal {sig}: "
                f"{exc}; preemption polling still works via "
                f"request_preemption()",
                stacklevel=2,
            )


def preemption_handlers_installed() -> bool:
    """Is the flag-setting signal handler installed?"""
    return bool(_prev_signal_handlers)


def uninstall_preemption_handlers() -> None:
    """Restore the handlers that were there before the install, and clear
    the flag."""
    for sig, prev in list(_prev_signal_handlers.items()):
        try:
            signal.signal(sig, prev)
        except (ValueError, OSError):
            pass
        del _prev_signal_handlers[sig]
    clear_preemption()


# The CUDA generators a step drew from while a window program watched it
# (None: nobody watches).
_graph_generators: list | None = None


def note_graph_generator(generator: torch.Generator) -> None:
    """Record that the running step draws from the CUDA ``generator``. A
    window program that captures the step as a CUDA graph registers every
    generator noted in its eager first window with the graph, so that each
    replay draws afresh, as the eager updates do. The default CUDA
    generator needs no note; ``fluxmpi_tpu_torch.models.ddpm_loss`` notes
    its ``rng``."""
    watch = _graph_generators
    if (watch is not None and generator.device.type == "cuda"
            and all(g is not generator for g in watch)):
        watch.append(generator)


@contextlib.contextmanager
def watch_graph_generators():
    """Collect the generators :func:`note_graph_generator` records inside
    the block; yields the list."""
    global _graph_generators
    outer, _graph_generators = _graph_generators, []
    try:
        yield _graph_generators
    finally:
        _graph_generators = outer
