"""Checkpointing, manifests, mixed precision and the parameter EMA (the
ported part of :mod:`fluxmpi_tpu.utils`, under the same names)."""

from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .ema import EMAState, ema_init, ema_params, ema_update
from .manifest import (MANIFEST_SCHEMA, build_manifest, manifest_path,
                       read_manifest, validate_manifest, write_manifest)
from .precision import (DynamicLossScale, Policy, all_finite, get_policy,
                        loss_scale_init)

__all__ = [
    "CheckpointManager", "DynamicLossScale", "EMAState", "MANIFEST_SCHEMA", "Policy",
    "all_finite", "build_manifest", "ema_init", "ema_params", "ema_update",
    "get_policy", "loss_scale_init",
    "manifest_path", "read_manifest", "restore_checkpoint", "save_checkpoint",
    "validate_manifest", "write_manifest",
]
