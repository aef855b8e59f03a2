"""fluxmpi_tpu_torch: the PyTorch and CUDA port of :mod:`fluxmpi_tpu` for
NVIDIA Hopper (H100).

The port imports ``torch`` and numpy only, never JAX or the JAX package.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.

What is ported, in two slices:

- serving: :class:`~fluxmpi_tpu_torch.models.TransformerLM` through
  :class:`~fluxmpi_tpu_torch.serving.InferenceEngine`, with attention in
  the hand-written CUDA flash-attention forward kernel;
- data-parallel training: :func:`init` → :func:`synchronize` →
  :class:`DistributedDataContainer` / :class:`DistributedDataLoader` →
  :func:`~fluxmpi_tpu_torch.parallel.make_train_step` (gradient all-reduce
  over ``torch.distributed``, the :mod:`~fluxmpi_tpu_torch.optim` rules)
  → :func:`~fluxmpi_tpu_torch.parallel.train_loop`, with the LM's
  attention forward and backward (dQ, dK/dV) in hand-written CUDA kernels
  and its loss through the chunked fused head.
"""

from . import (comm, data, errors, logging, models, ops, optim, optimizer,
               parallel, runtime, serving, sync)
from .comm import allreduce, barrier, bcast, reduce
from .data import (ArrayDataset, DistributedDataContainer,
                   DistributedDataLoader, scan_batches)
from .errors import CollectiveError, FluxMPINotInitializedError
from .logging import fluxmpi_print, fluxmpi_println
from .optimizer import DistributedOptimizer, allreduce_gradients
from .runtime import (Initialized, device_count, init, is_initialized,
                      local_rank, process_count, process_index, resolve_device,
                      shutdown, total_workers)
from .sync import synchronize

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset", "CollectiveError", "DistributedDataContainer",
    "DistributedDataLoader", "DistributedOptimizer",
    "FluxMPINotInitializedError", "Initialized", "allreduce",
    "allreduce_gradients", "barrier", "bcast", "comm", "data", "device_count",
    "errors", "fluxmpi_print", "fluxmpi_println", "init", "is_initialized",
    "local_rank", "logging", "models", "ops", "optim", "optimizer", "parallel",
    "process_count", "process_index", "reduce", "resolve_device", "runtime",
    "scan_batches", "serving", "shutdown", "synchronize", "total_workers",
]
