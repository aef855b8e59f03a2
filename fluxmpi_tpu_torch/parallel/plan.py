"""Declarative N-D parallelism: one ``ParallelConfig`` → one mesh + one rule.

Counterpart of :mod:`fluxmpi_tpu.parallel.plan`.
:class:`ParallelConfig` declares axis sizes (``dp=``, ``fsdp=``, ``tp=``,
``pp=``, ``sp=``, ``ep=``; one may be ``-1``, inferred from the worker
count) and an optional regex partition-rule table;
:meth:`ParallelConfig.resolve` validates the topology and returns a
:class:`ResolvedPlan`: one :class:`~fluxmpi_tpu_torch.parallel.sharding.Mesh`
in the canonical axis order (``dp`` outermost, ``tp`` innermost), the
combined partition rule (user table, then the Megatron TP table when
``tp`` is present, then the ZeRO rule when ``fsdp`` is), the batch spec
and the per-source rule-hit counts of the PARALLEL board.
:func:`match_partition_rules` is the strict engine: an unmatched
non-scalar leaf raises.

The port's mesh is plain data (its shape, axis names and worker ranks):
resolving, specs, :meth:`ResolvedPlan.describe` and validation need no
world, so one process resolves a plan over any number of devices.
:meth:`ResolvedPlan.shard_state` places a state, which needs
``torch.distributed`` up with one process per device of the mesh.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from .. import config
from ..errors import TopologyMismatchError
from .sharding import (Mesh, P, Rule, _validated, fsdp_rule,
                       leaf_paths, map_leaves, place, rule_from_table,
                       transformer_tp_rules)

__all__ = [
    "ParallelConfig",
    "ResolvedPlan",
    "match_partition_rules",
    "plan_axis_name",
]

# Canonical mesh-axis order: dp outermost, tp innermost (two all-reduces
# per block want the fastest links, ahead of ep's one all-to-all per MoE
# layer); fsdp next to dp, pp/sp between.
_PLAN_AXES = ("dp", "fsdp", "pp", "sp", "ep", "tp")

# Axes whose devices consume distinct batch shards.
_DATA_AXES = ("dp", "fsdp")


def _default_axis_name(kind: str) -> str:
    return {
        "dp": config.DP_AXIS_NAME,
        "fsdp": config.FSDP_AXIS_NAME,
        "pp": config.PP_AXIS_NAME,
        "sp": config.SP_AXIS_NAME,
        "tp": config.TP_AXIS_NAME,
        "ep": config.EP_AXIS_NAME,
    }[kind]


def _is_scalar_shape(shape: tuple) -> bool:
    """Scalars and single-element leaves are never partitioned."""
    return len(shape) == 0 or int(np.prod(shape)) == 1


def _shape(leaf: Any) -> tuple:
    return tuple(getattr(leaf, "shape", ()) or ())


def match_partition_rules(rules: Any, tree: Any) -> Any:
    """Apply a ``(regex, PartitionSpec)`` table (or any rule) to a whole
    tree, strictly: every non-scalar leaf must match some rule, else
    ``ValueError`` names it. Scalar and single-element leaves get ``P()``.
    Returns the tree of PartitionSpecs."""
    rule = rules if callable(rules) else rule_from_table(list(rules))

    def get_spec(name, leaf):
        shape = _shape(leaf)
        if _is_scalar_shape(shape):
            return P()
        spec = rule(name, shape)
        if spec is None:
            raise ValueError(
                f"partition rule not found for parameter {name!r} "
                f"(shape {shape}) — add a table entry or use the "
                f"non-strict tree_partition_specs for heuristic layouts"
            )
        return spec

    specs = leaf_paths(tree, get_spec)
    return map_leaves(lambda p, x: specs[p], tree)


def _visible_workers() -> int:
    import torch
    import torch.distributed as dist

    from .. import runtime

    if runtime.is_initialized():
        return runtime.total_workers()
    if dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


class ParallelConfig:
    """Declarative N-D parallel layout: axis sizes + partition rules
    (:class:`fluxmpi_tpu.parallel.ParallelConfig`, the same arguments and
    errors).

    ``dp``: data-parallel size; ``fsdp``: ZeRO-3 size (parameters and
    optimizer state sharded, largest divisible dim of each leaf of at
    least ``fsdp_min_size``; its workers are data workers too); ``tp``:
    Megatron tensor-parallel size (the built-in transformer table);
    ``pp``, ``sp``: pipeline and sequence-parallel sizes (the sequence dim
    of the batch spec over ``sp``; the stacked stages over ``pp`` by a
    ``pipeline_rules`` table); ``ep``: expert-parallel size. Exactly one size may be ``-1``; all at 1 means ``dp=-1``.
    ``rules``: a ``(regex, PartitionSpec)`` table or a rule, layered
    first. ``strict``: an unmatched non-scalar leaf raises.
    ``axis_names``: ``{plan axis: mesh axis name}`` overrides."""

    def __init__(self, *, dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1,
                 sp: int = 1, ep: int = 1, rules: Any = None, strict: bool = False,
                 fsdp_min_size: int = 1024, axis_names: dict[str, str] | None = None):
        sizes = {"dp": dp, "fsdp": fsdp, "tp": tp, "pp": pp, "sp": sp, "ep": ep}
        for axis, size in sizes.items():
            if not isinstance(size, int) or isinstance(size, bool) or (
                    size < 1 and size != -1):
                raise ValueError(
                    f"ParallelConfig {axis}= must be a positive int or -1 "
                    f"(inferred), got {size!r}"
                )
        if sum(1 for s in sizes.values() if s == -1) > 1:
            raise ValueError(
                "at most one ParallelConfig axis may have inferred size -1"
            )
        if all(s == 1 for s in sizes.values()):
            sizes["dp"] = -1  # the default 1-D data-parallel mesh
        self.sizes = sizes
        self.rules = rules
        self.strict = bool(strict)
        self.fsdp_min_size = int(fsdp_min_size)
        names = {axis: _default_axis_name(axis) for axis in _PLAN_AXES}
        if axis_names:
            unknown = set(axis_names) - set(_PLAN_AXES)
            if unknown:
                raise ValueError(
                    f"axis_names keys must be plan axes {_PLAN_AXES}, "
                    f"got {sorted(unknown)}"
                )
            names.update(axis_names)
        if len(set(names.values())) != len(names):
            raise ValueError(f"mesh axis names must be distinct, got {names}")
        self.axis_names = names

    def __repr__(self) -> str:
        return f"ParallelConfig{self._spec_str()}"

    def resolve(self, devices: Sequence[int] | int | None = None) -> "ResolvedPlan":
        """Resolve against ``devices``: a list of worker ranks, a count
        (ranks ``0..n-1``), or ``None`` for every worker of the world (the
        card count before :func:`~fluxmpi_tpu_torch.init`). Infers the
        ``-1`` axis and raises
        :class:`~fluxmpi_tpu_torch.errors.TopologyMismatchError` when the
        sizes cannot cover the devices exactly."""
        if devices is None:
            devices = _visible_workers()
        if isinstance(devices, int):
            n_dev = devices
            from .. import runtime

            if runtime.is_initialized() and n_dev > runtime.total_workers():
                raise TopologyMismatchError(
                    f"ParallelConfig asks for {n_dev} devices but only "
                    f"{runtime.total_workers()} are visible"
                )
            devs = list(range(n_dev))
        else:
            devs = [int(d) for d in devices]
            n_dev = len(devs)
        sizes = dict(self.sizes)
        known = int(np.prod([s for s in sizes.values() if s != -1]))
        if -1 in sizes.values():
            if known == 0 or n_dev % known:
                raise TopologyMismatchError(
                    f"cannot infer the -1 axis of {self._spec_str()}: "
                    f"{n_dev} device(s) not divisible by the known axes' "
                    f"product {known}"
                )
            for axis, size in sizes.items():
                if size == -1:
                    sizes[axis] = n_dev // known
        total = int(np.prod(list(sizes.values())))
        if total != n_dev:
            raise TopologyMismatchError(
                f"ParallelConfig {self._spec_str()} covers {total} "
                f"device(s) but {n_dev} are available — resize an axis "
                f"(or set one to -1 to infer it)"
            )
        return ResolvedPlan(self, sizes, devs)

    def _spec_str(self) -> str:
        return "(" + ", ".join(f"{a}={s}" for a, s in self.sizes.items() if s != 1) + ")"


class ResolvedPlan:
    """A :class:`ParallelConfig` bound to concrete workers: the one mesh,
    the combined partition rule (with per-source hit counts), the batch
    spec, and the state sharding ``make_train_step(parallel=)`` reads."""

    def __init__(self, cfg: ParallelConfig, sizes: dict[str, int],
                 devices: Sequence[int]):
        self.config = cfg
        # Every plan axis above 1 in canonical order; dp always rides
        # along, so there is always a data axis for batch specs.
        mesh_axes = [axis for axis in _PLAN_AXES if sizes[axis] > 1 or axis == "dp"]
        self.sizes = {axis: int(sizes[axis]) for axis in mesh_axes}
        self.axis_names = {axis: cfg.axis_names[axis] for axis in mesh_axes}
        shape = [self.sizes[axis] for axis in mesh_axes]
        self.mesh = Mesh(np.asarray(devices).reshape(shape),
                         tuple(self.axis_names[axis] for axis in mesh_axes))
        self.rule_hits: dict[str, int] = {}
        self._rule = self._build_rule()
        self._state_sharding: Any | None = None
        # partition_specs memo: the leaves' (path, shape) → (specs, hits).
        # The rule table is frozen at resolve time, so the plan instance
        # is the table's identity.
        self._spec_cache: dict[tuple, tuple[dict, dict[str, int]]] = {}
        self.spec_cache_hits = 0
        self.spec_cache_misses = 0
        # Set on the layout autotuner's winner: the bank key of its record.
        self.autotune_fingerprint: str | None = None

    # -- axis queries ---------------------------------------------------

    def axis_name(self, kind: str) -> str | None:
        """Mesh axis name of plan axis ``kind``, or None when the plan
        does not have that axis."""
        return self.axis_names.get(kind)

    @property
    def dp_axis_name(self) -> str:
        return self.axis_names["dp"]

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Mesh axis names whose workers consume distinct batch shards
        (``dp``, plus ``fsdp`` when present)."""
        return tuple(self.axis_names[axis] for axis in _DATA_AXES
                     if axis in self.axis_names)

    def covers(self, mesh: Any) -> bool:
        """Does ``mesh`` carry this plan's data axes (None = the plan's
        own mesh)? The gate the loader's default batch axes and the step
        factories' installed-plan defaults share."""
        return mesh is None or set(self.data_axes) <= set(mesh.axis_names)

    @property
    def data_parallel_size(self) -> int:
        """Distinct batch shards: the effective data-parallel workers."""
        return int(np.prod([self.mesh.shape[name] for name in self.data_axes]))

    @property
    def batch_spec(self) -> P:
        """Leading (batch) dim over the data axes, the sequence dim over
        ``sp`` when present."""
        axes = self.data_axes
        lead = axes[0] if len(axes) == 1 else axes
        if "sp" in self.axis_names:
            return P(lead, self.axis_names["sp"])
        return P(lead)

    @property
    def shards_parameters(self) -> bool:
        """Does this plan lay parameters out non-replicated (fsdp/tp axes
        or user rules)?"""
        return ("fsdp" in self.axis_names or "tp" in self.axis_names
                or self.config.rules is not None)

    # -- the rule engine ------------------------------------------------

    def _build_rule(self) -> Rule:
        components: list[tuple[str, Rule]] = []
        user = self.config.rules
        if user is not None:
            components.append(
                ("table", user if callable(user) else rule_from_table(list(user))))
        if "tp" in self.axis_names:
            components.append(("tp", transformer_tp_rules(tp_axis=self.axis_names["tp"])))
        if "fsdp" in self.axis_names:
            components.append(("fsdp", fsdp_rule(
                self.mesh, axis_name=self.axis_names["fsdp"],
                min_size=self.config.fsdp_min_size)))
        self._components = components

        def rule(path: str, shape: tuple) -> P | None:
            match = self._match(path, shape)
            return match[1] if match else None

        return rule

    def _match(self, path: str, shape: tuple) -> tuple[str, P] | None:
        """First component with an opinion → ``(source, spec)``."""
        for source, component in self._components:
            spec = component(path, shape)
            if spec is not None:
                return source, spec
        return None

    @property
    def rule(self) -> Rule:
        """The combined partition rule (user table → TP table → FSDP;
        first opinion wins). Direct calls do not touch ``rule_hits``."""
        return self._rule

    def _specs_by_path(self, tree: Any) -> dict[str, P]:
        """``{leaf path: validated spec}``, memoized per the leaves'
        paths and shapes; refreshes ``rule_hits`` (the last tree laid
        out)."""
        shapes = leaf_paths(tree, lambda p, x: _shape(x))
        key = tuple(shapes.items())
        cached = self._spec_cache.get(key)
        if cached is not None:
            specs, hits = cached
            self.spec_cache_hits += 1
            self.rule_hits = dict(hits)
            return specs
        self.rule_hits = {}
        hits = self.rule_hits
        specs = {}
        for name, shape in shapes.items():
            if _is_scalar_shape(shape):
                specs[name] = P()
                continue
            match = self._match(name, shape)
            if match is None:
                if self.config.strict:
                    raise ValueError(
                        f"partition rule not found for parameter "
                        f"{name!r} (shape {shape}) under strict "
                        f"ParallelConfig — add a rules= entry or drop "
                        f"strict=True"
                    )
                hits["replicated"] = hits.get("replicated", 0) + 1
                specs[name] = P()
                continue
            source, spec = match
            hits[source] = hits.get(source, 0) + 1
            specs[name] = _validated(spec, shape, self.mesh, path=name)
        self.spec_cache_misses += 1
        if len(self._spec_cache) >= 16:
            self._spec_cache.clear()
        self._spec_cache[key] = (specs, dict(hits))
        return specs

    def partition_specs(self, tree: Any) -> Any:
        """Map the plan's rule over ``tree`` → validated PartitionSpecs
        (scalar leaves ``P()``; an unmatched non-scalar leaf raises under
        ``strict=True``, else counts into ``rule_hits["replicated"]``).
        Memoized per the leaves' paths and shapes; a hit restores that
        tree's ``rule_hits`` and fires no warning."""
        specs = self._specs_by_path(tree)
        return map_leaves(lambda p, x: specs[p], tree)

    def shard_state(self, state: Any) -> tuple[Any, Any]:
        """Lay a :class:`~fluxmpi_tpu_torch.parallel.TrainState` (or any
        tree) out over the plan's mesh: ``(placed, shardings)``, ``placed``
        holding this worker's block of every leaf (new tensors; the
        caller's stay as they are). Banks the shardings for
        ``make_train_step(parallel=plan)`` and posts the PARALLEL board.
        Needs one process per device of the mesh."""
        placed, shardings = place(state, self._specs_by_path(state), self.mesh)
        self._state_sharding = shardings
        post_board(self)
        return placed, shardings

    @property
    def state_sharding(self) -> Any | None:
        """The shardings of the last :meth:`shard_state` (None before)."""
        return self._state_sharding

    # -- description (manifest / status board) -------------------------

    def describe(self) -> dict[str, Any]:
        """JSON-able description: plan axis sizes, the plan→mesh axis
        name map, the mesh shape and the per-source rule hit counts."""
        return {
            "axes": dict(self.sizes),
            "axis_names": dict(self.axis_names),
            "mesh": {str(name): int(size) for name, size in self.mesh.shape.items()},
            "data_parallel_size": self.data_parallel_size,
            "rule_hits": dict(self.rule_hits),
        }


def resolve_parallel(parallel: Any) -> ResolvedPlan:
    """Normalize a ``parallel=`` argument: a :class:`ResolvedPlan` passes
    through; a :class:`ParallelConfig` returns the installed plan when it
    is that plan's config, else resolves against the runtime's mesh
    workers (every worker before ``init``)."""
    if isinstance(parallel, ResolvedPlan):
        return parallel
    if isinstance(parallel, ParallelConfig):
        from ..runtime import global_mesh, global_plan, is_initialized

        installed = global_plan()
        if installed is not None and parallel is installed.config:
            return installed
        if is_initialized():
            return parallel.resolve([int(d) for d in global_mesh().devices.flat])
        return parallel.resolve()
    raise ValueError(
        f"parallel= must be a ParallelConfig or ResolvedPlan, got {parallel!r}"
    )


def plan_axis_name(kind: str) -> str:
    """Default mesh axis name for plan axis ``kind``: the installed plan's
    (``init(parallel=)``), else the ``*_axis_name`` preference."""
    from ..runtime import global_plan

    plan = global_plan()
    if plan is not None:
        name = plan.axis_name(kind)
        if name is not None:
            return name
    return _default_axis_name(kind)


def post_board(plan: ResolvedPlan) -> None:
    """Publish the PARALLEL board: the mesh and rule hit counts onto the
    live ``/status`` endpoint (when the exporter serves) and the
    ``parallel.*`` gauges into the default registry (when telemetry is
    on)."""
    from ..telemetry import export as _export
    from ..telemetry import get_registry

    desc = plan.describe()
    exporter = _export.get_exporter()
    if exporter is not None and exporter.enabled:
        exporter.note_parallel(**desc)
    registry = get_registry()
    if registry is not None and getattr(registry, "enabled", True):
        for axis, size in desc["mesh"].items():
            registry.gauge("parallel.axis_size", axis=axis).set(float(size))
        # Every known source posts every time (absent → 0).
        sources = {"table", "tp", "fsdp", "replicated"} | set(desc["rule_hits"])
        for source in sources:
            registry.gauge("parallel.rule_hits", source=source).set(
                float(desc["rule_hits"].get(source, 0)))
