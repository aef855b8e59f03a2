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
import weakref
from typing import Any, Sequence

import torch
import torch.distributed as dist

from . import config
from .errors import FluxMPINotInitializedError, refuse_unported

__all__ = [
    "Initialized",
    "auto_parallel",
    "clear_preemption",
    "device_count",
    "dp_axis_name",
    "enable_compile_cache",
    "global_mesh",
    "global_plan",
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
    # The gloo group the host_* and the host-staged collectives run over:
    # None at world 1 without host staging, the default group on the CPU,
    # a gloo group beside NCCL on the card.
    host_group: Any = None
    # The global mesh (parallel.sharding.Mesh) and the installed plan.
    mesh: Any = None
    plan: Any = None
    # init(parallel="auto") armed the layout autotuner: the mesh starts as
    # the 1-D dp default and autotune() installs its winner over it.
    auto_parallel: bool = False
    # The gloo group of the checkpoint barriers (checkpoint_group()).
    ckpt_group: Any = None


_state = _State()

# init() arguments of the JAX package whose machinery is not ported yet: none left.
_WAITING: tuple = ()

_PREEMPTION_ENV = "FLUXMPI_TPU_PREEMPTION"
_SIGNALS_BY_NAME = {
    "term": (signal.SIGTERM,),
    "int": (signal.SIGINT,),
    "both": (signal.SIGTERM, signal.SIGINT),
}


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return None if val in (None, "") else int(val)


def _configure_preemption(spec: Any = None) -> None:
    """Wire preemption handling from one value: ``None`` reads
    ``FLUXMPI_TPU_PREEMPTION`` (no-op when unset); ``True``/``"1"``/
    ``"both"`` installs SIGTERM+SIGINT; ``"term"``/``"int"`` installs just
    that signal; ``False``/``"0"`` uninstalls."""
    if spec is None:
        spec = os.environ.get(_PREEMPTION_ENV)
        if spec is None or spec == "":
            return
    if spec is False or spec == "0":
        uninstall_preemption_handlers()
        return
    if spec is True or spec == "1":
        spec = "both"
    if not isinstance(spec, str) or spec not in _SIGNALS_BY_NAME:
        raise ValueError(
            f"preemption spec must be a bool or one of "
            f"{sorted(_SIGNALS_BY_NAME)}; got {spec!r}"
        )
    install_preemption_handlers(_SIGNALS_BY_NAME[spec])


# ---------------------------------------------------------------------------
# Persistent store of compiled kernels: the counterpart of the JAX
# package's persistent XLA compilation cache. Repeat runs, and every
# process that shares the directory, load the kernels' libraries instead
# of running nvcc again.
# ---------------------------------------------------------------------------

_COMPILE_CACHE_ENV = "FLUXMPI_TPU_COMPILE_CACHE"


def enable_compile_cache(cache_dir: str | None = None) -> bool:
    """Build and load the CUDA kernels' libraries under ``cache_dir``
    (default ``FLUXMPI_TPU_COMPILE_CACHE``, else the package's own
    ``ops/_build/``), so repeat runs skip ``nvcc``. Returns True when
    enabled.

    On the card only: a run on the CPU builds no kernel, so there it is a
    no-op (with a warning when the cache was explicitly requested), as
    the JAX package's cache is off the TPU."""
    from .ops import _build

    explicit = cache_dir is not None or bool(os.environ.get(_COMPILE_CACHE_ENV))
    if cache_dir is None:
        cache_dir = os.environ.get(_COMPILE_CACHE_ENV) or None
    on_card = (_state.device.type == "cuda" if _state.initialized
               else torch.cuda.is_available())
    if not on_card:
        if explicit:
            warnings.warn(
                "persistent compile cache skipped: this run is on the CPU, "
                "which builds no CUDA kernel; the cache holds the kernels' "
                "libraries for the card",
                stacklevel=2,
            )
        return False
    _build.set_build_dir(cache_dir)
    return True


def _configure_compile_cache(spec: Any = None) -> None:
    """Wire the persistent compile cache from a one-value spec (mirror of
    ``telemetry.configure``): ``None`` reads ``FLUXMPI_TPU_COMPILE_CACHE``
    (no-op when unset); a path string enables the cache there;
    ``True``/``"1"`` enables the default location; ``False``/``"0"`` is a
    no-op (libraries already loaded stay loaded)."""
    if spec is None:
        spec = os.environ.get(_COMPILE_CACHE_ENV)
        if spec is None or spec == "":
            return
    if spec is False or spec == "0":
        return
    if spec is True or spec == "1":
        enable_compile_cache()
        return
    if isinstance(spec, str):
        enable_compile_cache(spec)
        return
    raise ValueError(
        f"compile_cache spec must be a bool, '0'/'1', or a directory "
        f"path; got {spec!r}"
    )


def _configure_planes(telemetry: Any, trace: Any, watchdog: Any,
                      preemption: Any, faults: Any, goodput: Any, anomaly: Any,
                      model_stats: Any, compileplane: Any, memory: Any,
                      profile: Any, compile_cache: Any, export: Any,
                      serving: Any, request_log: Any, fleet: Any,
                      resize: Any) -> None:
    """Wire the telemetry, fault-tolerance, run-health, device, export,
    serving, fleet and resize planes in the JAX package's order (each from
    its argument, else its environment variable). The fleet plane comes
    after the exporter: its collector's default target is this process's
    own exporter."""
    from . import faults as _faults
    from . import serving as _serving
    from . import telemetry as _telemetry
    from .fleet import resize as _resize
    from .serving import observe as _serving_observe
    from .telemetry import anomaly as _anomaly
    from .telemetry import compileplane as _compileplane
    from .telemetry import export as _export
    from .telemetry import fleet as _fleet
    from .telemetry import goodput as _goodput
    from .telemetry import memory as _memory
    from .telemetry import modelstats as _modelstats
    from .telemetry import tracing as _tracing
    from .telemetry import watchdog as _watchdog
    from .utils import profiling as _profiling

    _telemetry.configure(telemetry)
    _tracing.configure(trace)
    _watchdog.configure(watchdog)
    _configure_preemption(preemption)
    _faults.configure(faults)
    _goodput.configure(goodput)
    _anomaly.configure(anomaly)
    _modelstats.configure(model_stats)
    _compileplane.configure(compileplane)
    _memory.configure(memory)
    _profiling.configure_auto_profiler(profile)
    _configure_compile_cache(compile_cache)
    _export.configure(export)
    _serving.configure(serving)
    _serving_observe.configure(request_log)
    _fleet.configure(fleet)
    _resize.configure(resize)


def init(*, devices: Sequence[int] | int | None = None,
         mesh_shape: dict[str, int] | None = None, parallel: Any = None,
         distributed: bool | None = None,
         device: str | torch.device | None = None,
         coordinator_address: str | None = None,
         num_processes: int | None = None, process_id: int | None = None,
         timeout: float = 600.0,
         verbose: bool = False, telemetry: Any = None, trace: Any = None,
         watchdog: Any = None, preemption: Any = None, faults: Any = None,
         goodput: Any = None, anomaly: Any = None, model_stats: Any = None,
         compileplane: Any = None, memory: Any = None, profile: Any = None,
         compile_cache: Any = None, export: Any = None,
         serving: Any = None, request_log: Any = None, fleet: Any = None,
         resize: Any = None, **waiting) -> torch.device:
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
    gauges (``FLUXMPI_TPU_MEMORY``). The fault-tolerance planes:
    ``preemption`` — ``True``/``"both"``, ``"term"`` or ``"int"`` installs
    the flag-setting signal handlers, ``False`` uninstalls them
    (``FLUXMPI_TPU_PREEMPTION``); ``faults`` — a fault schedule
    (:func:`fluxmpi_tpu_torch.faults.configure`; ``FLUXMPI_TPU_FAULTS``).
    The serving planes:
    ``serving`` — engine defaults, ``True``, a dict or a
    :class:`~fluxmpi_tpu_torch.serving.ServingConfig` (``False`` resets the
    plane; ``FLUXMPI_TPU_SERVING``); ``request_log`` — ``True`` or a JSONL
    path for the per-request records (``{process}`` formatted; ``False``
    uninstalls; ``FLUXMPI_TPU_REQUEST_LOG``).
    The run-health, device and live-export planes: ``anomaly`` — ``True``
    (NaN rules halt, the rest warn), ``"warn"`` or an
    :class:`~fluxmpi_tpu_torch.telemetry.AnomalyDetector`, bundles in
    ``FLUXMPI_TPU_ANOMALY_DIR`` (``FLUXMPI_TPU_ANOMALY``); ``model_stats``
    — ``True``, a grouping depth or a
    :class:`~fluxmpi_tpu_torch.telemetry.ModelStats`
    (``FLUXMPI_TPU_MODEL_STATS``, ``_DEPTH``, ``_TOPK``); ``compileplane``
    — ``True`` for the compile monitor (``FLUXMPI_TPU_COMPILEPLANE``);
    ``profile`` — a directory for anomaly-triggered ``torch.profiler``
    captures (``FLUXMPI_TPU_PROFILE_DIR``, ``_SECONDS``, ``_LIMIT``);
    ``compile_cache`` — ``True`` or a directory for the kernels' built
    libraries (:func:`enable_compile_cache`; ``FLUXMPI_TPU_COMPILE_CACHE``);
    ``export`` — ``True``, a port or an
    :class:`~fluxmpi_tpu_torch.telemetry.Exporter` for ``/metrics``,
    ``/status`` and ``/healthz`` (``FLUXMPI_TPU_EXPORT_PORT``, ``_ADDR``);
    ``fleet`` — ``True``, a snapshot-bank path or a
    :class:`~fluxmpi_tpu_torch.telemetry.FleetCollector`
    (``FLUXMPI_TPU_FLEET``, ``_HOSTS``, ``_INTERVAL``). ``False`` turns
    each one off.

    The layout (the JAX package's): ``parallel`` — a
    :class:`~fluxmpi_tpu_torch.parallel.ParallelConfig` or a resolved plan;
    the global mesh (:func:`global_mesh`) is the plan's mesh and the plan
    is installed as :func:`global_plan` (read by
    ``make_train_step(parallel=)``, the loader's batch axes and the
    ``/status`` PARALLEL board); ``mesh_shape`` — an ordered ``{axis:
    size}`` for an ad-hoc mesh (one size may be ``-1``), exclusive with
    ``parallel``; default a 1-D ``dp`` mesh over every worker;
    ``devices`` — the worker ranks (or their count) the mesh covers,
    default the whole world. The mesh is plain data over the workers
    (one process per device): unlike the JAX package, ``init`` returns
    this worker's device, not the mesh. ``distributed`` — ``True``
    joins the launcher's world (``RANK``/``WORLD_SIZE``/``MASTER_*``, or
    the explicit coordinator) and raises without one, ``False`` ignores
    the launcher's environment and runs this process alone, ``None``
    (default) joins when the environment names a world.

    ``parallel="auto"`` (or ``FLUXMPI_TPU_PARALLEL=auto`` with no
    explicit layout) arms the layout autotuner (:func:`auto_parallel`):
    the mesh comes up as the 1-D dp default and
    :func:`~fluxmpi_tpu_torch.parallel.autotune.autotune` installs its
    winning plan and mesh over it.

    The live-resize plane (:mod:`fluxmpi_tpu_torch.fleet.resize`):
    ``resize`` — ``True``/``"1"`` arms it, a path also banks one
    ``fluxmpi_tpu.resize/v1`` record per completed resize there, or a
    :class:`~fluxmpi_tpu_torch.fleet.resize.ResizeCoordinator`
    (``FLUXMPI_TPU_RESIZE``; ``False`` disarms). Armed, with
    ``train_loop(checkpoint=)`` attached, ``request_resize(M)`` drains the
    world at a flush boundary and hands off to a relaunch with M workers.
    """
    passed = sorted(k for k, v in waiting.items() if v is not None)
    unknown = [k for k in passed if k not in _WAITING]
    if unknown:
        raise TypeError(f"init() got unexpected arguments {unknown}")
    refuse_unported("init", {k: True for k in passed})
    # parallel="auto" (or FLUXMPI_TPU_PARALLEL=auto with no explicit
    # layout): arm auto mode. The mesh comes up as the 1-D dp default;
    # fluxmpi_tpu_torch.parallel.autotune.autotune(...) later installs its
    # winner over it (init cannot run trials: it does not know the model).
    auto_requested = False
    if isinstance(parallel, str):
        if parallel != "auto":
            raise ValueError(
                f'parallel= accepts a ParallelConfig, a ResolvedPlan, or '
                f'the string "auto", got {parallel!r}'
            )
        auto_requested = True
        parallel = None
    elif parallel is None and mesh_shape is None:
        env_parallel = os.environ.get("FLUXMPI_TPU_PARALLEL", "").strip()
        if env_parallel == "auto":
            auto_requested = True
        elif env_parallel:
            warnings.warn(
                f'ignoring FLUXMPI_TPU_PARALLEL={env_parallel!r} — the '
                f'only supported value is "auto" (pass a ParallelConfig '
                f'to init(parallel=) for an explicit layout)',
                stacklevel=2,
            )
    if parallel is not None and mesh_shape is not None:
        raise ValueError(
            "pass either parallel= (the declarative plan) or mesh_shape= "
            "(an ad-hoc mesh), not both"
        )
    planes = (telemetry, trace, watchdog, preemption, faults, goodput, anomaly,
              model_stats, compileplane, memory, profile, compile_cache, export,
              serving, request_log, fleet, resize)
    if _state.initialized:
        if parallel is not None and not _same_plan(parallel, _state.plan):
            # The mesh and plan are frozen at the first init.
            warnings.warn(
                "fluxmpi_tpu is already initialized; init(parallel=) "
                "cannot rebuild the global mesh on an idempotent replay "
                "— the existing mesh/plan stays. Call shutdown() first "
                "to re-init under a different ParallelConfig.",
                stacklevel=2,
            )
        _configure_planes(*planes)
        if auto_requested:
            _state.auto_parallel = True
        return _state.device
    want = resolve_device(device)
    cpu = want.type == "cpu"
    adopt = dist.is_initialized()
    launcher = distributed is not False
    if adopt:
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = process_id if process_id is not None else (
            _env_int("RANK") if launcher else None)
        world = num_processes if num_processes is not None else (
            _env_int("WORLD_SIZE") if launcher else None)
        if distributed and world is None and coordinator_address is None:
            raise RuntimeError(
                "init(distributed=True) found no world to join: set the "
                "launcher's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT, or pass "
                "coordinator_address/num_processes/process_id")
        if (rank is None) != (world is None):
            raise ValueError("pass the process index and count together "
                             "(process_id/num_processes, or RANK/WORLD_SIZE)")
        rank, world = (0, 1) if rank is None else (int(rank), int(world))
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} out of range for {world} processes")
    lr = _env_int("LOCAL_RANK") if launcher else None
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
            host, _, port = coordinator_address.rpartition(":")
            kwargs["store"] = _rendezvous_store(host, int(port), rank, world,
                                                kwargs["timeout"])
        elif world > 1 or (launcher and "MASTER_ADDR" in os.environ):
            if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
                raise ValueError(
                    f"init over {world} processes needs the launcher's "
                    f"MASTER_ADDR and MASTER_PORT, or coordinator_address")
            kwargs["store"] = _rendezvous_store(
                os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), rank, world,
                kwargs["timeout"])
        else:
            # A single process needs no launcher: a store on an ephemeral
            # localhost port, never a fixed one.
            kwargs["store"] = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                            timeout=kwargs["timeout"])
        dist.init_process_group(**kwargs)
    if world == 1 and not config.DEVICE_COLLECTIVES_DISABLED:
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
    try:
        _state.mesh, _state.plan = _build_mesh(devices, mesh_shape, parallel, world)
    except Exception:
        shutdown()
        raise
    _state.auto_parallel = auto_requested
    _configure_planes(*planes)
    if _state.plan is not None:
        # The PARALLEL board: the mesh on /status and the parallel.*
        # gauges the moment the plan is installed.
        from .parallel.plan import post_board

        post_board(_state.plan)
    if verbose:
        if world == 1:
            warnings.warn(
                "Using fluxmpi_tpu_torch with only 1 worker. It might be faster "
                "to run the code without the distributed wrappers.",
                stacklevel=2,
            )
        from .logging import fluxmpi_println

        fluxmpi_println(f"Initialized: {world} process(es), device {dev}, "
                        f"mesh axes {_state.mesh.shape}, backend "
                        f"{dist.get_backend()}")
    return dev


def _build_mesh(devices: Any, mesh_shape: Any, parallel: Any,
                world: int) -> tuple[Any, Any]:
    """The global mesh and the installed plan (None for a mesh from
    ``mesh_shape=`` or the default)."""
    import numpy as np

    from .parallel.plan import ParallelConfig, ResolvedPlan
    from .parallel.sharding import Mesh

    if devices is None:
        devs = list(range(world))
    elif isinstance(devices, int):
        devs = list(range(devices))
    else:
        devs = [int(d) for d in devices]
    if parallel is not None:
        if isinstance(parallel, ResolvedPlan):
            plan_devs = sorted(int(d) for d in parallel.mesh.devices.flat)
            if devices is not None and plan_devs != sorted(devs):
                from .errors import TopologyMismatchError

                raise TopologyMismatchError(
                    f"init(devices=) names {len(devs)} device(s) but "
                    f"the pre-resolved plan's mesh covers device ids "
                    f"{plan_devs} — resolve the ParallelConfig "
                    f"against those devices, or pass the config itself"
                )
            return parallel.mesh, parallel
        if isinstance(parallel, ParallelConfig):
            plan = parallel.resolve(devs)
            return plan.mesh, plan
        raise ValueError(f"parallel= must be a ParallelConfig or ResolvedPlan, "
                         f"got {parallel!r}")
    if mesh_shape is None:
        mesh_shape = {config.DP_AXIS_NAME: len(devs)}
    axis_names = tuple(mesh_shape.keys())
    sizes = list(mesh_shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may have inferred size -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if len(devs) % known != 0:
            raise ValueError(f"cannot infer mesh axis: {len(devs)} devices not "
                             f"divisible by {known}")
        sizes[sizes.index(-1)] = len(devs) // known
    if int(np.prod(sizes)) != len(devs):
        raise ValueError(f"mesh_shape {dict(zip(axis_names, sizes))} does not "
                         f"cover {len(devs)} devices")
    return Mesh(np.asarray(devs).reshape(sizes), axis_names), None


def _same_rule_config(a: Any, b: Any) -> bool:
    """Do two ParallelConfigs declare the same partition-rule behaviour?"""
    try:
        same_rules = a.rules is b.rules or a.rules == b.rules
    except Exception:
        same_rules = False
    return (bool(same_rules) and a.strict == b.strict
            and a.fsdp_min_size == b.fsdp_min_size)


def _same_plan(parallel: Any, installed: Any) -> bool:
    """Is the ``parallel=`` of a repeated ``init`` the installed layout
    (the plan, its config, an equivalent re-resolved plan, or a config
    with the same sizes, names and rule behaviour)?"""
    if installed is None:
        return False
    if parallel is installed or parallel is installed.config:
        return True
    sizes = getattr(parallel, "sizes", None)
    names = getattr(parallel, "axis_names", None)
    if not (isinstance(sizes, dict) and isinstance(names, dict)):
        return False
    cfg = installed.config
    other = getattr(parallel, "config", None)
    if other is not None:
        return (sizes == installed.sizes and names == installed.axis_names
                and _same_rule_config(other, cfg))
    if not _same_rule_config(parallel, cfg):
        return False
    if sizes == cfg.sizes and names == cfg.axis_names:
        return True
    try:
        resolved = parallel.resolve([int(d) for d in installed.mesh.devices.flat])
    except Exception:
        return False
    return (resolved.sizes == installed.sizes
            and resolved.axis_names == installed.axis_names)


def global_mesh() -> Any:
    """The mesh :func:`init` built (a
    :class:`~fluxmpi_tpu_torch.parallel.sharding.Mesh`)."""
    _require_init()
    return _state.mesh


def global_plan() -> Any:
    """The :class:`~fluxmpi_tpu_torch.parallel.plan.ResolvedPlan`
    installed by ``init(parallel=)``, or None."""
    return _state.plan


def auto_parallel() -> bool:
    """Was the runtime armed with ``init(parallel="auto")`` (or
    ``FLUXMPI_TPU_PARALLEL=auto``)? While True and no autotuned plan is
    installed yet, :func:`global_plan` is still None — the layout
    autotuner fills it in."""
    return _state.initialized and _state.auto_parallel


def _install_autotuned_plan(plan: Any) -> bool:
    """Install the layout autotuner's winning plan as the global plan
    (and its mesh as the global mesh), and post the PARALLEL board. Only
    under an armed auto mode on an initialized runtime — a hand-pinned
    init keeps its layout. Returns True when installed."""
    if not _state.initialized or not _state.auto_parallel:
        return False
    from .parallel.plan import post_board

    _state.mesh = plan.mesh
    _state.plan = plan
    post_board(plan)
    return True


def dp_axis_name() -> str:
    """Name of the data-parallel mesh axis (the installed plan's, else
    the preference)."""
    if _state.plan is not None:
        return _state.plan.dp_axis_name
    return config.DP_AXIS_NAME


def is_initialized() -> bool:
    """Has :func:`init` run (and :func:`shutdown` not since)?"""
    return _state.initialized


# Reference-spelling alias (``FluxMPI.Initialized``).
Initialized = is_initialized


# The launcher world's rendezvous stores, kept for the process's life:
# (host, port, world) -> [store, inits so far].
_STORES: dict = {}


def _rendezvous_store(host: str, port: int, rank: int, world: int,
                      timeout: datetime.timedelta) -> Any:
    """The store an :func:`init` in a launcher's world rendezvouses on:
    one ``TCPStore`` per address for the process's life (rank 0 serves
    it), under a fresh key prefix per :func:`init`. A worker that has shut
    down and initializes again while a slower peer still holds the
    previous group then meets its peers under the new prefix instead of
    the old group's keys, or a server that is about to go away (C.24).
    Every worker counts its inits alike: they are collective."""
    key = (host, port, world)
    entry = _STORES.get(key)
    if entry is None:
        entry = _STORES[key] = [dist.TCPStore(host, port, world, is_master=rank == 0,
                                              timeout=timeout), 0]
    entry[1] += 1
    entry[0].set_timeout(timeout)
    return dist.PrefixStore(f"fluxmpi_init_{entry[1]}/", entry[0])


def shutdown() -> None:
    """Reset the runtime: tear down the telemetry planes first (the
    watchdog disarmed, the trace ring exported to its configured path
    while the rank is still known, the sinks flushed and detached), then
    the fault-tolerance planes (the fault schedule cleared, the resize
    plane disarmed with its request dropped, the preemption handlers
    uninstalled and the flag cleared: left armed, the next run would inject
    faults, resize or "preempt" at its first boundary), then
    destroy the process group if :func:`init` created it (one the caller
    brought up stays), after releasing every CUDA graph captured since
    (:func:`release_captured_graphs`)."""
    try:
        from .telemetry import shutdown as _telemetry_shutdown

        _telemetry_shutdown()
    except Exception:
        pass
    from . import faults as _faults
    from .fleet import resize as _resize

    _faults.clear()
    # A resize request left armed would drain the next run at its first
    # flush boundary.
    _resize.shutdown()
    uninstall_preemption_handlers()
    release_captured_graphs()
    if _state.initialized and dist.is_initialized():
        if _state.owns_group:
            dist.destroy_process_group()  # every group made over it too
        else:
            # The caller's default group stays up: the gloo groups made
            # over it go, or each init/shutdown cycle leaks their sockets.
            for group in (_state.ckpt_group, _state.host_group):
                if group is not None and group is not dist.group.WORLD:
                    dist.destroy_process_group(group)
    _state.initialized = False
    _state.owns_group = False
    _state.device = None
    _state.host_group = None
    _state.rank, _state.world, _state.local_rank = 0, 1, 0
    _state.mesh = _state.plan = None
    _state.auto_parallel = False
    _state.ckpt_group = None


def checkpoint_group() -> Any:
    """The gloo process group a sharded checkpoint's barriers run over
    (every worker, its own group: a background save's barriers never
    interleave with the training thread's collectives). Made on the first
    call, which every worker makes at the same point on its training
    thread (:class:`~fluxmpi_tpu_torch.utils.CheckpointManager` and the
    save and restore entry points do): group creation is collective."""
    _require_init()
    if _state.ckpt_group is None:
        _state.ckpt_group = dist.new_group(backend="gloo")
    return _state.ckpt_group


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
# The objects holding CUDA graphs whose captured collectives run on this
# process's communicators (note_captured_graph).
_captured_graphs: weakref.WeakSet = weakref.WeakSet()


def note_captured_graph(owner: Any) -> None:
    """Record that ``owner`` (an object with a ``release_graph()`` method,
    such as a fused window program) holds a CUDA graph that captured
    collectives: :func:`shutdown` releases it before it destroys the
    process groups, because a communicator torn down while a live graph
    still holds its collectives can wait for that graph forever."""
    _captured_graphs.add(owner)


def release_captured_graphs() -> None:
    """Release the CUDA graph of every owner noted by
    :func:`note_captured_graph` and still alive, once the device has run
    everything queued (a later call of such an owner captures anew)."""
    owners = list(_captured_graphs)
    if owners and torch.cuda.is_available():
        torch.cuda.synchronize()
    for owner in owners:
        owner.release_graph()
    _captured_graphs.clear()


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
