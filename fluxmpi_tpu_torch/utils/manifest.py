"""Checkpoint manifests: the sidecar every save writes beside its step.

Counterpart of :mod:`fluxmpi_tpu.utils.manifest`, in the same
``fluxmpi_tpu.manifest/v1`` schema, so the JAX package's validator and
the repository's scripts read the port's manifests as they are. A
manifest records, for ``<path>.manifest.json`` beside the checkpoint:

- every leaf's path (the flax-style path of :func:`named_leaves`), global
  shape and dtype, with a ``null`` partition spec (the port's state is
  replicated on every worker);
- the world size in place of the mesh (``{"axes": {"dp": world}}``) and
  the process count;
- for a ``train_loop`` payload, the loop counters and the loader's
  position and batch geometry.

The schema checks are the port's own copy of the JAX package's
``validate_manifest``. The sharded template, ``decode_spec`` and
``topology_changed`` wait for sharded state and elastic resume.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from .. import runtime

__all__ = [
    "MANIFEST_SCHEMA",
    "build_manifest",
    "check_manifest_shapes",
    "manifest_path",
    "map_with_path",
    "named_leaves",
    "read_manifest",
    "validate_manifest",
    "write_manifest",
]

MANIFEST_SCHEMA = "fluxmpi_tpu.manifest/v1"
MANIFEST_LAYOUTS = ("replicated", "sharded")
_MANIFEST_LOADER_REQUIRED = ("epoch", "cursor", "seed")
_MANIFEST_LOADER_OPTIONAL = ("global_batch_size", "num_batches",
                             "process_count", "elastic_order")
_MANIFEST_COUNTER_KEYS = ("updates", "examples", "epochs")
_SUFFIX = ".manifest.json"


def manifest_path(path: str) -> str:
    """The manifest's file: a sibling of the checkpoint directory."""
    return path.rstrip(os.sep) + _SUFFIX


# ---------------------------------------------------------------------------
# Leaf paths
# ---------------------------------------------------------------------------


def _is_train_state(tree: Any) -> bool:
    from ..parallel.train import TrainState

    return isinstance(tree, TrainState)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  path: tuple = ()) -> Any:
    """Rebuild ``tree`` with every leaf ``x`` replaced by ``fn(path, x)``,
    ``path`` being the leaf's flax-style path (``"a/b/0/c"``).

    Dicts, lists, tuples and dataclasses are walked; ``None`` stays
    ``None``. A dict key holding dots (a state-dict name) spells as the
    nested path it names. A :class:`~fluxmpi_tpu_torch.parallel.TrainState`
    spells as the JAX package's ``TrainState`` of the same model and
    optax rule: its parameters under flax's ``params`` collection, and its
    optimizer state as the first (stateful) link of optax's chain, each
    per-parameter tree again under ``params``. The leaf paths of a
    checkpoint then equal those of the JAX package's for the same
    payload."""
    if tree is None:
        return None
    if _is_train_state(tree):
        opt = tree.opt_state
        if isinstance(opt, dict):
            opt_path = path + ("opt_state", "0")
            opt = {k: (map_with_path(fn, v, opt_path + (k, "params"))
                       if isinstance(v, dict) else
                       map_with_path(fn, v, opt_path + (k,)))
                   for k, v in opt.items()}
        else:
            opt = map_with_path(fn, opt, path + ("opt_state",))
        return dataclasses.replace(
            tree,
            step=map_with_path(fn, tree.step, path + ("step",)),
            params=map_with_path(fn, tree.params, path + ("params", "params")),
            opt_state=opt,
            model_state=map_with_path(fn, tree.model_state,
                                      path + ("model_state",)))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # namedtuple
            return type(tree)(*vals)
        return type(tree)(vals)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree) if f.init})
    return fn("/".join(path), tree)


def leaf_tensor(x: Any) -> torch.Tensor | None:
    """A leaf as the tensor a checkpoint stores, or None for a leaf it
    skips (strings and other objects). Python ints are int32 scalars (the
    JAX package's ``TrainState.step`` and optax's counts); the loop's
    counters come as int64 tensors already."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, bool):
        return torch.tensor(x)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64)
    if isinstance(x, (np.ndarray, np.generic)) and x.dtype != object:
        return torch.from_numpy(np.array(x))
    return None


def named_leaves(tree: Any) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` of :func:`map_with_path`, in walk order."""
    out: list[tuple[str, Any]] = []

    def take(path, leaf):
        out.append((path, leaf))
        return leaf

    map_with_path(take, tree)
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Build, write, read
# ---------------------------------------------------------------------------


def _int_section(tree: Any, section: str) -> dict[str, int] | None:
    """A ``train_loop`` payload's ``loader``/``loop`` section as plain
    ints; None when the tree is not such a payload."""
    if not isinstance(tree, dict):
        return None
    sub = tree.get(section)
    if not isinstance(sub, dict) or not sub:
        return None
    out: dict[str, int] = {}
    for key, val in sub.items():
        t = leaf_tensor(val)
        if t is None or t.ndim != 0 or t.is_floating_point():
            return None
        out[str(key)] = int(t)
    return out


def build_manifest(state: Any, *, layout: str = "replicated",
                   step: int | None = None) -> dict[str, Any]:
    """Describe ``state`` (the tree about to be checkpointed) as a
    ``fluxmpi_tpu.manifest/v1`` record; ``step`` is the manager's step
    number when saved through one."""
    leaves = []
    for path, leaf in named_leaves(state):
        t = leaf_tensor(leaf)
        if t is None:
            continue
        leaves.append({"path": path, "shape": [int(d) for d in t.shape],
                       "dtype": _dtype_name(t), "spec": None})
    world = runtime.process_count() if runtime.is_initialized() else 1
    counters = _int_section(state, "loop")
    if counters is not None and sorted(counters) != sorted(_MANIFEST_COUNTER_KEYS):
        counters = None
    loader = _int_section(state, "loader")
    if loader is not None and not (
        all(key in loader for key in _MANIFEST_LOADER_REQUIRED)
        and set(loader) <= set(_MANIFEST_LOADER_REQUIRED + _MANIFEST_LOADER_OPTIONAL)
    ):
        loader = None
    return {
        "schema": MANIFEST_SCHEMA,
        "time_unix": time.time(),
        "step": int(step) if step is not None else None,
        "layout": layout,
        "process_count": world,
        "mesh": {"axes": {"dp": world}},
        "leaves": leaves,
        "loader": loader,
        "counters": counters,
        "parallel": _parallel_section(),
    }


def _parallel_section() -> dict[str, Any] | None:
    """The installed plan's axes and mesh axis names (None without one),
    and, when the layout autotuner picked it, its bank key
    (``autotune_fingerprint``: the ``<ckpt>.autotune.json`` sidecar's
    record vouches for the layout)."""
    plan = runtime.global_plan()
    if plan is None:
        return None
    desc = plan.describe()
    out = {"axes": desc["axes"], "axis_names": desc["axis_names"]}
    fp = getattr(plan, "autotune_fingerprint", None)
    if fp:
        out["autotune_fingerprint"] = str(fp)
    return out


def write_manifest(path: str, manifest: dict[str, Any]) -> None:
    """Write (fsync'd) the manifest beside the checkpoint at ``path``,
    after validating it: a save never commits a manifest a restore would
    reject."""
    errors = validate_manifest(manifest)
    if errors:
        raise ValueError(
            f"refusing to write an invalid checkpoint manifest for {path}: "
            + "; ".join(errors)
        )
    with open(manifest_path(path), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def read_manifest(path: str) -> dict[str, Any] | None:
    """Read and validate the manifest beside the checkpoint at ``path``.
    None when it is absent, or unreadable or invalid (with a warning: a
    bad sidecar must not make a checkpoint unrestorable)."""
    target = manifest_path(path)
    try:
        with open(target, encoding="utf-8") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError) as exc:
        warnings.warn(f"checkpoint manifest at {target} is unreadable "
                      f"({exc!r}); ignoring it", stacklevel=2)
        return None
    errors = validate_manifest(manifest)
    if errors:
        warnings.warn(f"checkpoint manifest at {target} fails schema "
                      f"validation ({'; '.join(errors[:3])}); ignoring it",
                      stacklevel=2)
        return None
    return manifest


def check_manifest_shapes(manifest: dict[str, Any], like: Any) -> None:
    """Refuse a restore whose template disagrees with the manifest about
    any leaf's global shape, naming the leaf before any bytes move."""
    by_path = {leaf["path"]: leaf for leaf in manifest.get("leaves", [])}
    for path, leaf in named_leaves(like):
        t = leaf_tensor(leaf)
        entry = by_path.get(path)
        if t is None or entry is None:
            continue
        shape = tuple(entry["shape"])
        if tuple(t.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {path!r} shape {shape} (from the manifest) "
                f"does not match expected {tuple(t.shape)} — wrong checkpoint "
                f"for this model/optimizer"
            )


# ---------------------------------------------------------------------------
# Schema checks (the port's copy of the JAX package's validate_manifest)
# ---------------------------------------------------------------------------


def _is_int(x: object) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _is_number(x: object) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _validate_spec(spec: object, ndim: int, where: str) -> list[str]:
    if spec is None:
        return []
    if not isinstance(spec, list):
        return [f"{where}: 'spec' must be null or a list, got {spec!r}"]
    errors: list[str] = []
    if len(spec) > ndim:
        errors.append(f"{where}: 'spec' has {len(spec)} entries for a "
                      f"rank-{ndim} leaf")
    for d, names in enumerate(spec):
        if names is None or (isinstance(names, str) and names):
            continue
        if isinstance(names, list) and names and all(
                isinstance(n, str) and n for n in names):
            continue
        errors.append(f"{where}: spec[{d}] must be null, an axis name, or a "
                      f"non-empty list of axis names, got {names!r}")
    return errors


def validate_manifest(rec: object) -> list[str]:
    """Validate a ``fluxmpi_tpu.manifest/v1`` record; returns the errors
    (empty when valid)."""
    if not isinstance(rec, dict):
        return [f"manifest is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != MANIFEST_SCHEMA:
        errors.append(f"'schema' must be {MANIFEST_SCHEMA!r}, got "
                      f"{rec.get('schema')!r}")
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    if rec.get("layout") not in MANIFEST_LAYOUTS:
        errors.append(f"'layout' must be one of {MANIFEST_LAYOUTS}, got "
                      f"{rec.get('layout')!r}")
    if not _is_int(rec.get("process_count")) or rec["process_count"] < 1:
        errors.append("'process_count' must be an int >= 1")
    step = rec.get("step")
    if step is not None and not _is_int(step):
        errors.append("'step' must be an int or null")
    mesh = rec.get("mesh")
    if mesh is not None:
        axes = mesh.get("axes") if isinstance(mesh, dict) else None
        if not isinstance(axes, dict) or not axes or not all(
                isinstance(k, str) and k and _is_int(v) and v >= 1
                for k, v in axes.items()):
            errors.append("'mesh' must be null or {'axes': {name: size >= 1, "
                          f"...}}, got {mesh!r}")
    leaves = rec.get("leaves")
    if not isinstance(leaves, list):
        errors.append("'leaves' must be a list")
        leaves = []
    seen: set[str] = set()
    for i, leaf in enumerate(leaves):
        lw = f"leaves[{i}]"
        if not isinstance(leaf, dict):
            errors.append(f"{lw}: not an object")
            continue
        path = leaf.get("path")
        if not isinstance(path, str) or not path:
            errors.append(f"{lw}: missing/invalid 'path' (str)")
        elif path in seen:
            errors.append(f"{lw}: duplicate leaf path {path!r}")
        else:
            seen.add(path)
        shape = leaf.get("shape")
        if not isinstance(shape, list) or not all(_is_int(d) and d >= 0
                                                  for d in shape):
            errors.append(f"{lw}: 'shape' must be a list of ints >= 0")
            shape = []
        if not isinstance(leaf.get("dtype"), str) or not leaf.get("dtype"):
            errors.append(f"{lw}: missing/invalid 'dtype' (str)")
        errors.extend(_validate_spec(leaf.get("spec"), len(shape), lw))
    loader = rec.get("loader")
    if loader is not None:
        if not isinstance(loader, dict):
            errors.append(f"'loader' must be null or an object, got {loader!r}")
        else:
            for key in _MANIFEST_LOADER_REQUIRED:
                if not _is_int(loader.get(key)):
                    errors.append(f"loader: missing int {key!r}")
            for key in _MANIFEST_LOADER_OPTIONAL:
                if key in loader and not _is_int(loader[key]):
                    errors.append(f"loader: {key!r} must be an int")
    counters = rec.get("counters")
    if counters is not None:
        if not isinstance(counters, dict):
            errors.append(f"'counters' must be null or an object, got {counters!r}")
        else:
            for key in _MANIFEST_COUNTER_KEYS:
                if not _is_int(counters.get(key)):
                    errors.append(f"counters: missing int {key!r}")
    parallel = rec.get("parallel")
    if parallel is not None:
        if not isinstance(parallel, dict):
            errors.append(f"'parallel' must be null or an object, got {parallel!r}")
        else:
            axes = parallel.get("axes")
            if not isinstance(axes, dict) or not axes or not all(
                    isinstance(k, str) and k and _is_int(v) and v >= 1
                    for k, v in axes.items()):
                errors.append("parallel: 'axes' must map plan axis -> size >= 1")
            names = parallel.get("axis_names")
            if not isinstance(names, dict) or not all(
                    isinstance(k, str) and isinstance(v, str) and v
                    for k, v in names.items()):
                errors.append("parallel: 'axis_names' must map plan axis -> "
                              "mesh axis name")
            fp = parallel.get("autotune_fingerprint")
            if fp is not None and (not isinstance(fp, str) or not fp):
                errors.append("parallel: 'autotune_fingerprint' must be null "
                              "or a non-empty str")
    return errors
