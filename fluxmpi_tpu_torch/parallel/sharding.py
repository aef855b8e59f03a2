"""Parameter and optimizer sharding rules: tensor parallelism and FSDP/ZeRO.

Counterpart of :mod:`fluxmpi_tpu.parallel.sharding`. A **rule** is
``rule(path, shape) -> PartitionSpec | None`` (``None``: no opinion;
compose with :func:`combine_rules`), where ``path`` is the leaf's
flax-style path joined with ``/`` (``encoder/block_0/ff1/kernel``), the
spelling the JAX package's rules match, so a rule table written for the
JAX package carries over unchanged. A state dict's keys hold the same
path joined with ``.``; the port hands every rule the ``/`` form, and a
:class:`~fluxmpi_tpu_torch.parallel.TrainState` spells its leaves as the
JAX package's ``TrainState`` does (optimizer moments carry the parameter
path as a suffix, so one rule shards both).

The port's mesh is plain data (:class:`Mesh`: axis names, sizes and the
worker ranks laid out row-major, as ``jax.sharding.Mesh`` lays out its
devices), enough to resolve rules, validate specs and describe a layout in
one process. Placing a tree (:func:`shard_tree`) needs the world the mesh
names: one process per device, ``world == mesh.size``. Each worker then
holds the block of every leaf that the JAX package's addressable shard on
the same mesh coordinate holds; the mesh's process groups (one per set of
axes) and its ``torch.distributed`` ``DeviceMesh`` come up on first use.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import config
from ..errors import TopologyMismatchError

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "Rule",
    "combine_rules",
    "fsdp_rule",
    "rule_from_table",
    "shard_tree",
    "sharding_of",
    "transformer_tp_rules",
    "tree_partition_specs",
    "validated_spec_strict",
]


class _Unconstrained:
    def __repr__(self) -> str:
        return "UNCONSTRAINED"


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s spelling: one entry per leading
    dimension, each a mesh axis name, a tuple of names (the product of
    those axes) or ``None`` (not partitioned); missing trailing entries
    mean ``None``. ``P.UNCONSTRAINED`` leaves a dimension to the layout."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec

# A sharding rule: (leaf path like "encoder/block_0/ff1/kernel", leaf shape)
# -> PartitionSpec, or None for "no opinion".
Rule = Callable[[str, tuple], "PartitionSpec | None"]


def _axis_group(names: Any) -> tuple:
    return (names,) if isinstance(names, str) else tuple(names)


class Mesh:
    """A named mesh of workers: ``devices`` (worker ranks, any shape) laid
    out over ``axis_names`` as ``jax.sharding.Mesh`` lays out devices.
    ``shape`` maps each axis name to its size, in order.

    Plain data until a collective needs the world: :meth:`group` returns
    the process group of the workers that differ only along some axes,
    :attr:`device_mesh` the ``torch.distributed`` ``DeviceMesh``
    (``mesh_dim_names`` = the axis names). Both need
    ``torch.distributed`` up with one process per device of the mesh."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=np.int64)
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"mesh of {devs.ndim} dims needs as many axis "
                             f"names, got {axis_names}")
        self.devices = devs
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(s) for s in devs.shape)))
        self._groups: dict[tuple, Any] = {}
        self._device_mesh = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> dict[str, int]:
        """The mesh coordinate of worker ``rank``."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"worker {rank} is not on {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def block_index(self, rank: int, names: Any) -> tuple[int, int]:
        """``(index, count)`` of ``rank``'s block along the axes ``names``
        (one name or a tuple, the first outermost)."""
        c = self.coords(rank)
        index, count = 0, 1
        for n in _axis_group(names):
            index = index * self.shape[n] + c[n]
            count *= self.shape[n]
        return index, count

    def _check_world(self) -> int:
        import torch.distributed as dist

        from .. import runtime

        world = runtime.total_workers() if runtime.is_initialized() else (
            dist.get_world_size() if dist.is_initialized() else 1)
        if world != self.size or sorted(self.devices.flat) != list(range(world)):
            raise TopologyMismatchError(
                f"{self!r} covers workers {sorted(int(d) for d in self.devices.flat)} "
                f"but the world has {world}: placing tensors over a mesh needs "
                f"one process per device of it (init() with that many workers)")
        return world

    def my_rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def device_mesh(self):
        """The ``torch.distributed.device_mesh.DeviceMesh`` over this
        mesh's workers, with ``mesh_dim_names`` = :attr:`axis_names`."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            from .. import runtime

            self._check_world()
            dev = runtime.worker_device() if runtime.is_initialized() else None
            kind = "cuda" if dev is not None and dev.type == "cuda" else "cpu"
            self._device_mesh = init_device_mesh(
                kind, tuple(self.shape.values()), mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axes: Sequence[str]) -> Any:
        """The process group of the workers that share this worker's
        coordinates on every axis but ``axes``; ``None`` when that is
        this worker alone, ``torch.distributed.group.WORLD`` when it is
        the world. Every worker must ask for the same axes in the same
        order: group creation is collective."""
        import torch.distributed as dist

        axes = tuple(a for a in self.axis_names if a in set(axes))
        key = axes
        if key in self._groups:
            return self._groups[key]
        span = math.prod(self.shape[a] for a in axes)
        if span == 1:
            group = None
        elif span == self.size:
            self._check_world()
            group = dist.group.WORLD
        elif len(axes) == 1:
            group = self.device_mesh.get_group(axes[0])
        else:
            group = self._new_groups(axes)
        self._groups[key] = group
        return group

    def _new_groups(self, axes: tuple, **kwargs: Any) -> Any:
        """One ``dist.new_group`` (``kwargs`` its options) per slice of
        the mesh along ``axes``, every worker making all of them in the
        same order; returns this worker's."""
        import torch.distributed as dist

        self._check_world()
        me = self.my_rank()
        others = [a for a in self.axis_names if a not in axes]
        dims = {a: i for i, a in enumerate(self.axis_names)}
        group = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            index = [slice(None)] * len(self.axis_names)
            for a, i in zip(others, fixed):
                index[dims[a]] = i
            ranks = sorted(int(r) for r in self.devices[tuple(index)].flat)
            g = dist.new_group(ranks, **kwargs)
            if me in ranks:
                group = g
        return group

    def host_group(self, axes: Sequence[str]) -> Any:
        """:meth:`group` over gloo, for collectives staged through host
        memory: the same group in a gloo world; beside NCCL, gloo groups
        of the same workers (made collectively on first use, as
        :meth:`group`)."""
        import torch.distributed as dist

        if dist.get_backend() == "gloo":
            return self.group(axes)
        axes = tuple(a for a in self.axis_names if a in set(axes))
        key = ("host",) + axes
        if key not in self._groups:
            self._groups[key] = self._new_groups(axes, backend="gloo")
        return self._groups[key]

    def group_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self.axis_names if a in set(axes))


class NamedSharding:
    """``jax.sharding.NamedSharding``: a :class:`PartitionSpec` over a
    :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one worker's block of a leaf of ``global_shape``."""
        out = list(global_shape)
        for d, names in enumerate(self.spec):
            if names is not None and names is not P.UNCONSTRAINED:
                out[d] //= self.mesh.group_size(_axis_group(names))
        return tuple(out)

    @property
    def is_sharded(self) -> bool:
        """Does some dimension split over more than one worker (JAX's
        ``not is_fully_replicated`` over a mesh of several devices)?"""
        return any(names is not None and names is not P.UNCONSTRAINED
                   and self.mesh.group_size(_axis_group(names)) > 1
                   for names in self.spec)

    def global_shape(self, block_shape: Sequence[int]) -> tuple[int, ...]:
        """The global shape of a leaf whose blocks have ``block_shape``."""
        out = list(block_shape)
        for d, names in enumerate(self.spec):
            if names is not None and names is not P.UNCONSTRAINED:
                out[d] *= self.mesh.group_size(_axis_group(names))
        return tuple(out)

    def block_start(self, global_shape: Sequence[int],
                    rank: int | None = None) -> tuple[int, ...]:
        """The global start offsets of worker ``rank``'s (default this
        worker's) block of a leaf of ``global_shape``."""
        rank = self.mesh.my_rank() if rank is None else rank
        start = [0] * len(global_shape)
        for d, names in enumerate(self.spec):
            if names is None or names is P.UNCONSTRAINED:
                continue
            index, count = self.mesh.block_index(rank, names)
            start[d] = index * (global_shape[d] // count)
        return tuple(start)

    def owns_block(self, rank: int | None = None) -> bool:
        """Is worker ``rank`` the one that writes its block to a sharded
        checkpoint: the first of the workers holding the same block (index
        0 on every mesh axis the spec does not split over)?"""
        rank = self.mesh.my_rank() if rank is None else rank
        used = {n for names in self.spec
                if names is not None and names is not P.UNCONSTRAINED
                for n in _axis_group(names)}
        return all(i == 0 for a, i in self.mesh.coords(rank).items() if a not in used)

    def local_block(self, x: torch.Tensor, rank: int | None = None) -> torch.Tensor:
        """Worker ``rank``'s (default this worker's) block of the full
        tensor ``x``, as a contiguous copy."""
        rank = self.mesh.my_rank() if rank is None else rank
        for d, names in enumerate(self.spec):
            if names is None or names is P.UNCONSTRAINED:
                continue
            index, count = self.mesh.block_index(rank, names)
            size = x.shape[d] // count
            x = x.narrow(d, index * size, size)
        return x.contiguous().clone()


# The attribute a placed tensor carries its NamedSharding in: the port's
# spelling of a jax.Array's ``.sharding``. The step updates its state in
# place, so the tag stays with the tensor for the run.
_SHARDING_ATTR = "_fluxmpi_sharding"


def sharding_of(x: Any) -> NamedSharding | None:
    """The :class:`NamedSharding` of a tensor that :func:`shard_tree`,
    :meth:`~fluxmpi_tpu_torch.parallel.plan.ResolvedPlan.shard_state` or a
    checkpoint restore placed (its block's layout over the mesh), else
    None."""
    return getattr(x, _SHARDING_ATTR, None) if torch.is_tensor(x) else None


def with_sharding(x: torch.Tensor, sharding: NamedSharding | None) -> torch.Tensor:
    """Tag ``x`` as a block laid out by ``sharding``; returns ``x``."""
    if sharding is not None:
        setattr(x, _SHARDING_ATTR, sharding)
    return x


def combine_rules(*rules: Rule) -> Rule:
    """First rule with an opinion wins (e.g. TP table first, FSDP fallback)."""

    def rule(path: str, shape: tuple) -> PartitionSpec | None:
        for r in rules:
            spec = r(path, shape)
            if spec is not None:
                return spec
        return None

    return rule


def rule_from_table(table: Sequence[tuple[str, PartitionSpec]]) -> Rule:
    """Build a rule from ``(regex, spec)`` pairs matched against the leaf
    path (``re.search``; first match wins)."""
    compiled = [(re.compile(pat), spec) for pat, spec in table]

    def rule(path: str, shape: tuple) -> PartitionSpec | None:
        for pat, spec in compiled:
            if pat.search(path):
                return spec
        return None

    return rule


def fsdp_rule(mesh: Mesh, *, axis_name: str | None = None,
              min_size: int = 1024) -> Rule:
    """ZeRO-3 rule: shard the largest mesh-divisible dimension of every
    leaf with ``size >= min_size`` over the data-parallel axis (parameters
    and optimizer state alike); smaller leaves stay replicated."""
    name = axis_name or config.DP_AXIS_NAME
    axis_size = mesh.shape[name]

    def rule(path: str, shape: tuple) -> PartitionSpec | None:
        if int(np.prod(shape or (1,))) < min_size:
            return None
        divisible = [d for d in range(len(shape)) if shape[d] % axis_size == 0]
        if not divisible:
            return None
        dim = max(divisible, key=lambda d: shape[d])
        spec = [None] * len(shape)
        spec[dim] = name
        return P(*spec)

    return rule


def transformer_tp_rules(tp_axis: str | None = None) -> Rule:
    """Megatron-style tensor-parallel layout for the transformer models:
    attention Q/K/V column-parallel over heads, the output projection
    row-parallel, ``ff1`` column- and ``ff2`` row-parallel, the token
    embedding vocab-parallel."""
    tp = tp_axis or config.TP_AXIS_NAME
    return rule_from_table(
        [
            # q/k/v kernels (d_model, heads, head_dim); out (heads, head_dim, d_model)
            (r"attn/(query|key|value)/kernel$", P(None, tp, None)),
            (r"attn/(query|key|value)/bias$", P(tp, None)),
            (r"attn/out/kernel$", P(tp, None, None)),
            (r"ff1/kernel$", P(None, tp)),
            (r"ff1/bias$", P(tp)),
            (r"ff2/kernel$", P(tp, None)),
            (r"embed/embedding$", P(tp, None)),
        ]
    )


def _walk_spec(spec, shape, mesh) -> tuple[list, list]:
    """The spec-vs-leaf traversal both validators share: ``(entries,
    problems)``, each problem ``(kind, dim, names, detail)`` with kind in
    {"rank", "missing", "indivisible"}."""
    if spec is None:
        return [], []
    if len(spec) > len(shape):
        return [], [("rank", -1, tuple(spec), None)]
    entries: list = []
    problems: list = []
    for d, names in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            entries.append(None)
            continue
        group = _axis_group(names)
        missing = [n for n in group if n not in mesh.shape]
        if missing:
            problems.append(("missing", d, names, missing[0]))
            entries.append(None)
            continue
        size = int(np.prod([mesh.shape[n] for n in group]))
        if shape[d] % size:
            problems.append(("indivisible", d, names, size))
            entries.append(None)
        else:
            entries.append(names)
    return entries, problems


def _mesh_axes_str(mesh: Mesh) -> str:
    return str(tuple(mesh.axis_names))


def _validated(spec, shape, mesh: Mesh, path: str = "<leaf>") -> PartitionSpec:
    """Clamp a rule's spec to what the leaf supports: a mismatched rank or
    a non-divisible dim degrades to replicated on that dim, with a
    warning naming the leaf."""
    entries, problems = _walk_spec(spec, shape, mesh)
    for kind, d, names, detail in problems:
        if kind == "rank":
            message = (
                f"sharding rule for {path!r} has spec {spec} with more dims "
                f"than the leaf shape {shape}; leaf stays replicated"
            )
        elif kind == "missing":
            message = (
                f"sharding rule for {path!r} names mesh axis {detail!r} "
                f"absent from mesh axes {_mesh_axes_str(mesh)}; dim {d} "
                f"stays replicated"
            )
        else:
            message = (
                f"sharding rule for {path!r}: dim {d} of shape {shape} not "
                f"divisible by axis {names!r} size {detail}; dim stays "
                f"replicated"
            )
        warnings.warn(message, stacklevel=3)
    return P(*entries)


def validated_spec_strict(spec, shape, mesh: Mesh, path: str = "<leaf>") -> PartitionSpec:
    """Validate a spec against a leaf shape and mesh, raising
    :class:`~fluxmpi_tpu_torch.errors.TopologyMismatchError` instead of
    degrading to replicated (the restore-time discipline)."""
    entries, problems = _walk_spec(spec, shape, mesh)
    for kind, d, names, detail in problems:
        where = f"cannot restore {path!r} onto mesh axes {dict(mesh.shape)}"
        if kind == "rank":
            raise TopologyMismatchError(
                f"{where}: partition spec {spec} has more dimensions than "
                f"the saved leaf shape {shape}"
            )
        if kind == "missing":
            raise TopologyMismatchError(
                f"{where}: dimension {d} is partitioned over mesh axis "
                f"{detail!r}, which the current mesh does not have — "
                f"restore with a mesh that names it, or pass a partition "
                f"rule for the new topology"
            )
        raise TopologyMismatchError(
            f"{where}: dimension {d} of shape {shape} is not divisible by "
            f"the {names!r} axis size {detail} — the saved layout does not "
            f"fit this topology; resize the mesh or pass a partition rule "
            f"that avoids the axis"
        )
    return P(*entries)


def _shape(leaf: Any) -> tuple:
    return tuple(getattr(leaf, "shape", ()) or ())


def map_leaves(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf ``x`` replaced by ``fn(path, x)``, ``path``
    the JAX package's ``/``-joined leaf path (state-dict keys split at
    their dots; a ``TrainState`` spelled as the JAX one)."""
    from ..utils.manifest import map_with_path

    return map_with_path(fn, tree)


def _jax_keys(tree: Any, path: tuple = (), key: tuple = (),
              out: dict | None = None) -> dict:
    """``{path: sort key}`` of ``tree``'s leaves, the keys ordering them as
    JAX flattens the same tree: dict keys sorted, sequences and dataclass
    fields in order, a ``TrainState``'s fields in declaration order with
    optax's state in its fields' order (the paths are
    :func:`~fluxmpi_tpu_torch.utils.manifest.map_with_path`'s)."""
    from ..utils.manifest import _is_train_state

    out = {} if out is None else out
    if tree is None:
        return out
    if _is_train_state(tree):
        _jax_keys(tree.step, path + ("step",), key + (0,), out)
        _jax_keys(tree.params, path + ("params", "params"), key + (1,), out)
        opt = tree.opt_state
        if isinstance(opt, dict):
            for i, (k, v) in enumerate(opt.items()):
                sub = path + ("opt_state", "0", k) + (("params",) if isinstance(v, dict)
                                                      else ())
                _jax_keys(v, sub, key + (2, i), out)
        else:
            _jax_keys(opt, path + ("opt_state",), key + (2,), out)
        _jax_keys(tree.model_state, path + ("model_state",), key + (3,), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            parts = tuple(str(k).split("."))
            _jax_keys(v, path + parts, key + (parts,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _jax_keys(v, path + (str(i),), key + (i,), out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for i, f in enumerate(f for f in dataclasses.fields(tree) if f.init):
            _jax_keys(getattr(tree, f.name), path + (f.name,), key + (i,), out)
    else:
        out["/".join(path)] = key
    return out


def leaf_paths(tree: Any, fn: Callable[[str, Any], Any]) -> dict:
    """``{path: fn(path, leaf)}`` over ``tree``'s leaves, in the order JAX
    flattens the same tree (so the first leaf a strict rule rejects is
    JAX's)."""
    leaves: dict = {}
    map_leaves(lambda p, x: leaves.__setitem__(p, x), tree)
    order = _jax_keys(tree)
    return {p: fn(p, leaves[p]) for p in sorted(leaves, key=order.__getitem__)}


def tree_partition_specs(tree: Any, mesh: Mesh, rule: Rule) -> Any:
    """Map a rule over a tree → the tree of validated PartitionSpecs."""

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return _validated(rule(path, shape), shape, mesh, path=path)

    specs = leaf_paths(tree, leaf_spec)
    return map_leaves(lambda p, x: specs[p], tree)


def place(tree: Any, specs: dict, mesh: Mesh) -> tuple[Any, Any]:
    """``(placed, shardings)``: each tensor leaf of ``tree`` replaced by
    this worker's block under its spec in ``specs`` (``{path: spec}``),
    and the tree of :class:`NamedSharding`."""
    if mesh.size > 1:
        mesh._check_world()
    shardings = {p: NamedSharding(mesh, s) for p, s in specs.items()}

    def block(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        sh = shardings[path]
        if any(n is not None for n in sh.spec):
            out = sh.local_block(leaf.detach())
        else:
            out = leaf.detach().clone()
        # A parameter stays a leaf the step differentiates; the block
        # carries its layout (what a checkpoint of it records).
        return with_sharding(out.requires_grad_(leaf.requires_grad), sh)

    return map_leaves(block, tree), map_leaves(lambda p, x: shardings[p], tree)


def shard_tree(tree: Any, mesh: Mesh, rule: Rule) -> tuple[Any, Any]:
    """Lay a tree out over the mesh per ``rule``: ``(placed, shardings)``,
    ``placed`` holding this worker's block of every leaf and
    ``shardings`` the matching tree of :class:`NamedSharding` (feed it to
    ``make_train_step(state_sharding=...)``)."""
    specs = leaf_paths(tree, lambda p, x: _validated(rule(p, _shape(x)), _shape(x), mesh, path=p)
                       if _shape(x) else P())
    return place(tree, specs, mesh)
