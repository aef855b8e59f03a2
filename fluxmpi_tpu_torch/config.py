"""Persistent configuration / preferences.

Counterpart of :mod:`fluxmpi_tpu.config` (the reference's
Preferences.jl-backed config surface), with the same file, format and key
names, so that one user's preferences read alike in both packages.

Preferences are stored in a JSON file next to the consuming project
(``./LocalPreferences.json``), under the ``"fluxmpi_tpu"`` namespace,
overridable via ``FLUXMPI_TPU_PREFS`` and per-key env vars
``FLUXMPI_TPU_<KEY>``. ``disable_device_collectives`` (read once at import
into :data:`DEVICE_COLLECTIVES_DISABLED`; also
``FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES=1``) makes the eager collectives
and ``synchronize`` stage through host memory over a gloo group instead of
running over the worker's device group (the reference's CPU-staging
fallback for CUDA-unaware MPI; :mod:`fluxmpi_tpu_torch.comm`). The
axis-name keys name the data-parallel axis, which the port's one-axis
world only spells.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any

__all__ = ["delete_preference", "disable_device_collectives", "env_int",
           "load_preference", "set_preference"]

_PREFS_ENV = "FLUXMPI_TPU_PREFS"
_PREFS_BASENAME = "LocalPreferences.json"
_PREFS_NAMESPACE = "fluxmpi_tpu"

# The reference warns on its removed env var; the port points users at the
# preference that replaced it.
_DEPRECATED_ENV = "FLUXMPI_DISABLE_CUDAMPI_SUPPORT"

_DEFAULTS: dict[str, Any] = {
    # Force eager collectives to stage via the host (the reference's
    # CPU-staging path).
    "disable_device_collectives": False,
    # Donate parameter/optimizer buffers in compiled train steps.
    "donate_buffers": True,
    # Default names of the mesh axes (data, FSDP, sequence, tensor,
    # expert and pipeline parallel).
    "dp_axis_name": "dp",
    "fsdp_axis_name": "fsdp",
    "sp_axis_name": "sp",
    "tp_axis_name": "tp",
    "ep_axis_name": "ep",
    "pp_axis_name": "pp",
}


def _prefs_path() -> str:
    return os.environ.get(_PREFS_ENV, os.path.join(os.getcwd(), _PREFS_BASENAME))


def _read_json(path: str) -> Any:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _write_json(path: str, data: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def _read_file() -> dict[str, Any]:
    data = _read_json(_prefs_path())
    ns = data.get(_PREFS_NAMESPACE, {}) if isinstance(data, dict) else {}
    return ns if isinstance(ns, dict) else {}


def _coerce(value: str, like: Any) -> Any:
    if isinstance(like, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def load_preference(key: str, default: Any = None) -> Any:
    """Read preference ``key``: env var > preferences file > default."""
    fallback = _DEFAULTS.get(key, default)
    env_key = f"FLUXMPI_TPU_{key.upper()}"
    if env_key in os.environ:
        return _coerce(os.environ[env_key], fallback)
    file_prefs = _read_file()
    if key in file_prefs:
        return file_prefs[key]
    return fallback


def set_preference(key: str, value: Any) -> None:
    """Persist preference ``key`` to the preferences file. Takes effect for
    values read after the call; the module-level cached flags need a fresh
    session, as in the reference."""
    path = _prefs_path()
    data = _read_json(path)
    if not isinstance(data, dict):
        data = {}
    data.setdefault(_PREFS_NAMESPACE, {})[key] = value
    _write_json(path, data)


def delete_preference(key: str) -> None:
    """Remove a persisted preference (no-op if absent)."""
    path = _prefs_path()
    data = _read_json(path)
    if isinstance(data, dict) and key in data.get(_PREFS_NAMESPACE, {}):
        del data[_PREFS_NAMESPACE][key]
        _write_json(path, data)


def disable_device_collectives() -> None:
    """Persist the opt-out of device collectives
    (``FluxMPI.disable_cudampi_support()``): the next session's eager
    collectives stage through host memory."""
    set_preference("disable_device_collectives", True)
    warnings.warn(
        "Device collectives disabled for future sessions; restart Python "
        "for the host-staging path to take effect.",
        stacklevel=2,
    )


def env_int(
    name: str,
    default: int | None = None,
    *,
    minimum: int | None = None,
) -> int | None:
    """The integer-env-knob parse with the warn-and-default convention (an
    env typo must degrade, never crash a job). Unset/empty returns
    ``default``; garbage, or a value below ``minimum``, warns and returns
    ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        warnings.warn(
            f"ignoring {name}={raw!r}: not an integer"
            + (f" — using the default {default}" if default is not None else ""),
            stacklevel=3,
        )
        return default
    if minimum is not None and value < minimum:
        warnings.warn(
            f"ignoring {name}={raw!r}: must be >= {minimum}"
            + (f" — using the default {default}" if default is not None else ""),
            stacklevel=3,
        )
        return default
    return value


def _warn_deprecated_env() -> None:
    if _DEPRECATED_ENV in os.environ:
        warnings.warn(
            f"`{_DEPRECATED_ENV}` is ignored. Use "
            "`fluxmpi_tpu_torch.config.disable_device_collectives()` to stage "
            "the collectives through host memory.",
            stacklevel=2,
        )


# Read once at import, as the reference reads its preferences at __init__.
_warn_deprecated_env()
DEVICE_COLLECTIVES_DISABLED: bool = bool(load_preference("disable_device_collectives"))
DP_AXIS_NAME: str = str(load_preference("dp_axis_name"))
FSDP_AXIS_NAME: str = str(load_preference("fsdp_axis_name"))
SP_AXIS_NAME: str = str(load_preference("sp_axis_name"))
TP_AXIS_NAME: str = str(load_preference("tp_axis_name"))
EP_AXIS_NAME: str = str(load_preference("ep_axis_name"))
PP_AXIS_NAME: str = str(load_preference("pp_axis_name"))
