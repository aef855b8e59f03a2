"""Checkpointing, manifests, mixed precision, the parameter EMA, FLOPs and
MFU, step timing and profiling (the ported part of
:mod:`fluxmpi_tpu.utils`, under the same names)."""

from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .ema import EMAState, ema_init, ema_params, ema_update
from .flops import chip_peak_flops, mfu
from .manifest import (MANIFEST_SCHEMA, build_manifest, manifest_path,
                       read_manifest, validate_manifest, write_manifest)
from .precision import (DynamicLossScale, Policy, all_finite, get_policy,
                        loss_scale_init)
from .profiling import (AutoProfiler, configure_auto_profiler,
                        get_auto_profiler, maybe_auto_capture, profile_trace,
                        set_auto_profiler, shutdown_auto_profiler, step_timer)

__all__ = [
    "AutoProfiler", "configure_auto_profiler", "get_auto_profiler",
    "maybe_auto_capture", "profile_trace", "set_auto_profiler",
    "shutdown_auto_profiler",
    "CheckpointManager", "DynamicLossScale", "EMAState", "MANIFEST_SCHEMA", "Policy",
    "all_finite", "build_manifest", "chip_peak_flops", "ema_init", "ema_params",
    "ema_update", "get_policy", "loss_scale_init",
    "manifest_path", "mfu", "read_manifest", "restore_checkpoint", "save_checkpoint",
    "step_timer", "validate_manifest", "write_manifest",
]
