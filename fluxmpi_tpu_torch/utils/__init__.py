"""Checkpointing, manifests and mixed precision (the ported part of
:mod:`fluxmpi_tpu.utils`, under the same names)."""

from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .manifest import (MANIFEST_SCHEMA, build_manifest, manifest_path,
                       read_manifest, validate_manifest, write_manifest)
from .precision import (DynamicLossScale, Policy, all_finite, get_policy,
                        loss_scale_init)

__all__ = [
    "CheckpointManager", "DynamicLossScale", "MANIFEST_SCHEMA", "Policy",
    "all_finite", "build_manifest", "get_policy", "loss_scale_init",
    "manifest_path", "read_manifest", "restore_checkpoint", "save_checkpoint",
    "validate_manifest", "write_manifest",
]
