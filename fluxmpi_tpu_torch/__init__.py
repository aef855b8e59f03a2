"""fluxmpi_tpu_torch: the PyTorch and CUDA port of :mod:`fluxmpi_tpu` for
NVIDIA Hopper (H100).

The port imports ``torch`` and numpy only, never JAX or the JAX package.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.

What is ported, slice by slice:

- serving: :class:`~fluxmpi_tpu_torch.models.TransformerLM` through
  :class:`~fluxmpi_tpu_torch.serving.InferenceEngine`, with attention in
  the hand-written CUDA flash-attention forward kernel;
- data-parallel training: :func:`init` → :func:`synchronize` →
  :class:`DistributedDataContainer` / :class:`DistributedDataLoader` →
  :func:`~fluxmpi_tpu_torch.parallel.make_train_step` (gradient all-reduce
  over ``torch.distributed``, the :mod:`~fluxmpi_tpu_torch.optim` rules)
  → :func:`~fluxmpi_tpu_torch.parallel.train_loop`, with the LM's
  attention forward and backward (dQ, dK/dV) in hand-written CUDA kernels
  and its loss through the chunked fused head;
- mixed-precision, fault-tolerant training: bf16 compute with f32 masters
  (:mod:`~fluxmpi_tpu_torch.utils.precision`, ``make_train_step(policy=,
  remat=)``), checkpoints with a crash-consistent commit protocol and
  their manifests (:mod:`~fluxmpi_tpu_torch.utils.checkpoint`,
  :mod:`~fluxmpi_tpu_torch.utils.manifest`), ``train_loop``'s periodic
  saves, resume and preemption drain (:func:`preemption_requested` and
  friends), and deterministic fault injection
  (:mod:`~fluxmpi_tpu_torch.faults`);
- one-program flush windows: ``train_loop(fuse="auto")`` runs each flush
  window over the device-gather loader as one CUDA graph
  (:func:`~fluxmpi_tpu_torch.parallel.make_window_program`);
- the reference's vision configs data-parallel: the Conv+BN
  :class:`~fluxmpi_tpu_torch.models.CNN` (sync-BN with ``axis_name``),
  :class:`~fluxmpi_tpu_torch.models.ResNet` (ResNet-18/34/50/101) and the
  :class:`~fluxmpi_tpu_torch.models.DEQ` with implicit gradients
  (:func:`~fluxmpi_tpu_torch.models.fixed_point_solve`), their BatchNorm
  statistics averaged by the step (``state_reduce="mean"``), with the rest
  of the FluxMPI surface: :func:`iallreduce` / :func:`ibcast` and their
  :class:`Request`, the ``host_*`` collectives, :func:`cpu` /
  :func:`device`, ``donate=``, :class:`FluxModelWrapper`,
  :class:`FlatParamVector`, :func:`local_device_count` and
  :mod:`~fluxmpi_tpu_torch.config`;
- the telemetry planes' core: :mod:`~fluxmpi_tpu_torch.telemetry` (the
  metrics registry and sinks, span tracing, the flight recorder and the
  watchdog, goodput with live MFU, the memory plane), wired through
  ``init(telemetry=, trace=, watchdog=, goodput=, memory=)`` and
  ``make_train_step(metrics=)`` / ``train_loop(metrics=)``;
- the parallel layouts: :class:`ParallelConfig` resolved into one mesh and
  one partition rule (:mod:`~fluxmpi_tpu_torch.parallel.plan`,
  :mod:`~fluxmpi_tpu_torch.parallel.sharding`), ``init(parallel=)`` with
  :func:`global_mesh` / :func:`global_plan`, ``make_train_step(parallel=,
  style=)``, the loader's ``mesh=``, the in-step collectives, the
  vocab-parallel fused cross-entropy and the MoE models with expert
  parallelism (:mod:`~fluxmpi_tpu_torch.models.moe`).
"""

from . import (comm, config, data, errors, faults, logging, models, ops, optim,
               optimizer, parallel, runtime, serving, sync, telemetry, utils)
from .comm import (Request, allreduce, barrier, bcast, cpu, device,
                   host_allgather, host_allreduce, host_bcast, iallreduce,
                   ibcast, reduce)
from .data import (ArrayDataset, DistributedDataContainer,
                   DistributedDataLoader, scan_batches)
from .errors import (CheckpointDesyncError, CheckpointTimeoutError,
                     CollectiveError, FaultInjectedError,
                     FluxMPINotInitializedError, TopologyMismatchError)
from .logging import fluxmpi_print, fluxmpi_println
from .optimizer import DistributedOptimizer, allreduce_gradients
from .parallel.plan import ParallelConfig, match_partition_rules
from .runtime import (Initialized, clear_preemption, device_count, dp_axis_name,
                      global_mesh, global_plan, init,
                      install_preemption_handlers, is_initialized,
                      local_device_count, local_rank,
                      preemption_handlers_installed, preemption_requested,
                      process_count, process_index, request_preemption,
                      resolve_device, shutdown, total_workers,
                      uninstall_preemption_handlers)
from .sync import FlatParamVector, FluxModelWrapper, synchronize

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset", "CheckpointDesyncError", "CheckpointTimeoutError",
    "CollectiveError", "DistributedDataContainer", "DistributedDataLoader",
    "DistributedOptimizer", "FaultInjectedError", "FlatParamVector",
    "FluxMPINotInitializedError", "FluxModelWrapper", "Initialized",
    "ParallelConfig",
    "Request", "TopologyMismatchError", "allreduce", "allreduce_gradients",
    "barrier", "bcast", "clear_preemption", "comm", "config", "cpu", "data",
    "device", "device_count", "dp_axis_name", "errors", "faults", "fluxmpi_print",
    "fluxmpi_println", "global_mesh", "global_plan", "host_allgather", "host_allreduce", "host_bcast",
    "iallreduce", "ibcast", "init", "install_preemption_handlers",
    "is_initialized", "local_device_count", "local_rank", "logging",
    "match_partition_rules",
    "models", "ops", "optim", "optimizer", "parallel",
    "preemption_handlers_installed", "preemption_requested",
    "process_count", "process_index", "reduce", "request_preemption",
    "resolve_device", "runtime", "scan_batches", "serving", "shutdown",
    "synchronize", "telemetry", "total_workers", "uninstall_preemption_handlers",
    "utils",
]
