"""Checkpoint manifests: the topology sidecar every save writes.

Counterpart of :mod:`fluxmpi_tpu.utils.manifest`, in the same
``fluxmpi_tpu.manifest/v1`` schema, so the JAX package's validator and
the repository's scripts read the port's manifests as they are. A
manifest records, for ``<path>.manifest.json`` beside the checkpoint:

- every leaf's path (the flax-style path of :func:`named_leaves`), global
  shape and dtype, and its partition spec in the JAX encoding (``null``,
  or per dimension ``null``, an axis name or a list of axes): the spec of
  the block layout a placed tensor carries
  (:func:`~fluxmpi_tpu_torch.parallel.sharding.sharding_of`), ``[]`` for a
  Python number of a tree laid out over a mesh (every worker holds it),
  ``null`` for a leaf with no layout;
- the mesh's axis sizes (the tree's own mesh, else the runtime's) and the
  process count;
- for a ``train_loop`` payload, the loop counters and the loader's
  position and batch geometry.

Restore builds its target layout from it: :func:`sharded_template` lays
every leaf of a ``like`` tree (meta tensors are the spelling of
"structure and global shapes only") out over the current mesh, from an
explicit rule or from the banked specs re-validated strictly, so a leaf
the new mesh cannot express raises
:class:`~fluxmpi_tpu_torch.errors.TopologyMismatchError` naming it.
:func:`topology_changed` tells a resume whether the world changed. The
schema checks are the port's own copy of the JAX package's
``validate_manifest``.
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
    "decode_spec",
    "manifest_path",
    "map_with_path",
    "mesh_axes",
    "named_leaves",
    "read_manifest",
    "sharded_template",
    "topology_changed",
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


def global_shape(leaf: Any) -> tuple[int, ...]:
    """A leaf's global shape: a placed block's leaf shape (its layout's),
    else its own."""
    from ..parallel.sharding import sharding_of

    shape = tuple(int(d) for d in leaf_tensor(leaf).shape)
    sh = sharding_of(leaf)
    return shape if sh is None else sh.global_shape(shape)


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


def _encode_spec(spec: Any) -> list | None:
    """PartitionSpec → JSON (per dimension: null, an axis, or a list of
    axes); None for "no layout opinion"."""
    if spec is None:
        return None
    out: list = []
    for names in tuple(spec):
        if names is None or isinstance(names, str):
            out.append(names)
        else:
            out.append([str(n) for n in names])
    return out


def decode_spec(encoded: list | None) -> Any:
    """JSON spec entry → :class:`~fluxmpi_tpu_torch.parallel.sharding.
    PartitionSpec` (``None`` decodes to fully replicated)."""
    from ..parallel.sharding import P

    if encoded is None:
        return P()
    return P(*(n if n is None or isinstance(n, str) else tuple(n) for n in encoded))


def mesh_axes(mesh: Any) -> dict[str, int] | None:
    """Mesh → ordered ``{axis: size}`` (None passes through)."""
    if mesh is None:
        return None
    return {str(name): int(size) for name, size in mesh.shape.items()}


def _tree_mesh(tree: Any) -> Any:
    """The mesh the tree's placed blocks name, else the runtime's global
    mesh, else None (before ``init``)."""
    from ..parallel.sharding import sharding_of

    for _, leaf in named_leaves(tree):
        sh = sharding_of(leaf)
        if sh is not None:
            return sh.mesh
    return runtime.global_mesh() if runtime.is_initialized() else None


def _placed(tree: Any) -> bool:
    from ..parallel.sharding import sharding_of

    return any(sharding_of(leaf) is not None for _, leaf in named_leaves(tree))


def _leaf_spec(leaf: Any, placed: bool) -> list | None:
    """The encoded spec of one leaf (module docstring)."""
    from ..parallel.sharding import sharding_of

    sh = sharding_of(leaf)
    if sh is not None:
        return _encode_spec(sh.spec)
    if placed and isinstance(leaf, (bool, int, float)):
        return []
    return None


def build_manifest(state: Any, *, layout: str = "replicated",
                   step: int | None = None, mesh: Any = None) -> dict[str, Any]:
    """Describe ``state`` (the tree about to be checkpointed) as a
    ``fluxmpi_tpu.manifest/v1`` record. ``layout`` is the save layout
    (``"replicated"``/``"sharded"``, what the commit marker records);
    ``step`` the manager's step number when saved through one; ``mesh``
    the mesh to record (default the tree's, else the runtime's)."""
    placed = _placed(state)
    leaves = []
    for path, leaf in named_leaves(state):
        t = leaf_tensor(leaf)
        if t is None:
            continue
        leaves.append({"path": path, "shape": list(global_shape(leaf)),
                       "dtype": _dtype_name(t), "spec": _leaf_spec(leaf, placed)})
    world = runtime.process_count() if runtime.is_initialized() else 1
    manifest_mesh = mesh if mesh is not None else _tree_mesh(state)
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
        "mesh": ({"axes": mesh_axes(manifest_mesh)} if manifest_mesh is not None
                 else None),
        "leaves": leaves,
        "loader": loader,
        "counters": counters,
        "parallel": _parallel_section(manifest_mesh),
    }


def _parallel_section(manifest_mesh: Any) -> dict[str, Any] | None:
    """The installed plan's axes and mesh axis names (None without one,
    or when the recorded mesh is not the plan's), and, when the layout
    autotuner picked it, its bank key (``autotune_fingerprint``: the
    ``<ckpt>.autotune.json`` sidecar's record vouches for the layout)."""
    plan = runtime.global_plan()
    if plan is None or (manifest_mesh is not None
                        and mesh_axes(plan.mesh) != mesh_axes(manifest_mesh)):
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
        if global_shape(leaf) != shape:
            raise ValueError(
                f"checkpoint leaf {path!r} shape {shape} (from the manifest) "
                f"does not match expected {global_shape(leaf)} — wrong "
                f"checkpoint for this model/optimizer"
            )


def sharded_template(like: Any, manifest: dict[str, Any] | None, mesh: Any,
                     rule: Any = None) -> Any:
    """The elastic restore template: ``like``'s structure with every
    tensor leaf replaced by a meta tensor of its global shape and dtype
    that carries its target :class:`~fluxmpi_tpu_torch.parallel.sharding.
    NamedSharding` over ``mesh`` (Python numbers stay as they are).

    Layout source, per leaf: an explicit ``rule`` wins; otherwise the
    spec the manifest banked, re-validated against the new mesh (same
    axis names, new sizes). Validation is strict: an axis the new mesh
    lacks, or a dimension its size no longer divides, raises
    :class:`~fluxmpi_tpu_torch.errors.TopologyMismatchError` naming the
    leaf, the first in the JAX package's leaf order (never a silent
    fall-back to replicated)."""
    from ..parallel.sharding import (NamedSharding, P, leaf_paths,
                                     validated_spec_strict, with_sharding)

    by_path = ({leaf["path"]: leaf for leaf in manifest.get("leaves", [])}
               if manifest is not None else {})

    def leaf_template(path: str, leaf: Any) -> Any:
        if torch.is_tensor(leaf):
            shape = global_shape(leaf)
        elif isinstance(leaf, (bool, int, float)):
            shape = ()
        else:
            return leaf
        entry = by_path.get(path)
        if rule is not None:
            spec = rule(path, shape)
        elif entry is not None:
            spec = decode_spec(entry.get("spec"))
        else:
            spec = P()
        spec = validated_spec_strict(spec, shape, mesh, path=path)
        if not torch.is_tensor(leaf):
            return leaf
        return with_sharding(torch.empty(shape, dtype=leaf.dtype, device="meta"),
                             NamedSharding(mesh, spec))

    templates = leaf_paths(like, leaf_template)
    return map_with_path(lambda p, x: templates.get(p, x), like)


def topology_changed(manifest: dict[str, Any] | None, mesh: Any = None) -> bool:
    """Did the world change since this manifest was written? True when
    the process count or the mesh axis sizes differ from the current ones
    (``mesh`` defaults to the runtime's global mesh); False when they
    match or the manifest predates topology recording."""
    if manifest is None:
        return False
    world = runtime.process_count() if runtime.is_initialized() else 1
    if int(manifest.get("process_count", 0)) != world:
        return True
    saved_mesh = manifest.get("mesh")
    if saved_mesh is None:
        return False
    if mesh is None:
        if not runtime.is_initialized():
            return False
        mesh = runtime.global_mesh()
    return dict(saved_mesh.get("axes") or {}) != mesh_axes(mesh)


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
