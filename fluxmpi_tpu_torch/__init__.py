"""fluxmpi_tpu_torch: the PyTorch and CUDA port of :mod:`fluxmpi_tpu` for
NVIDIA Hopper (H100).

The port imports ``torch`` and numpy only, never JAX or the JAX package.
Entry points run on the first CUDA device unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.

This slice serves: :class:`~fluxmpi_tpu_torch.models.TransformerLM`
through :class:`~fluxmpi_tpu_torch.serving.InferenceEngine`, with
attention in the hand-written CUDA flash-attention forward kernel.
"""

from . import errors, models, ops, runtime, serving
from .runtime import resolve_device

__all__ = ["errors", "models", "ops", "resolve_device", "runtime", "serving"]
