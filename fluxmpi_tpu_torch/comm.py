"""Collectives over the data-parallel world.

Counterpart of the eager collectives of :mod:`fluxmpi_tpu.comm` (the
reference's ``allreduce!``, ``bcast!``, ``reduce!``, ``Iallreduce!``,
``Ibcast!`` and ``MPI.Barrier``), on ``torch.distributed``: NCCL between
GPUs, gloo on the CPU. Each worker passes its own value: a tensor, or a
nested dict/list/tuple of tensors (numpy arrays and Python numbers are
taken as tensors). The leaves of a tree travel as one flat collective per
dtype, so the number of collectives does not grow with the number of
leaves. Results are new tensors on the leaves' own devices and dtypes; the
inputs are left as they were, unless ``donate=True`` hands them over.

The non-blocking :func:`iallreduce` and :func:`ibcast` start the same
collectives as ``torch.distributed`` work handles (``async_op=True``) and
return a :class:`Request`. The ``host_*`` collectives take and give numpy
arrays, one value per process, over a gloo group (the default group on the
CPU, a gloo group beside NCCL on the card), so they never touch the card.
:func:`cpu` and :func:`device` move tensors and numpy arrays between the
host and the worker's device.

Host staging (the reference's CPU-staging fallback for CUDA-unaware MPI):
with ``config.DEVICE_COLLECTIVES_DISABLED`` set (the
``disable_device_collectives`` preference, or
``FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES=1`` before import),
:func:`allreduce`, :func:`bcast`, :func:`reduce`, :func:`iallreduce` and
:func:`~fluxmpi_tpu_torch.synchronize` copy each flat buffer to host
memory (pinned on the card), run the collective over the runtime's gloo
group and copy the result back to the caller's device and dtype; the same
values as the device path, recorded under path ``host``. ``donate=True``
then warns that it has no effect, and :func:`iallreduce` completes before
it returns.

Each collective checks its fault site (``comm.allreduce``, ``comm.bcast``,
``comm.reduce``, ``comm.barrier``, ``comm.host_*``) before it runs, and
before any staging.

Each also records, as the JAX package's do: ``comm.calls``,
``comm.bytes`` (this worker's payload) and ``comm.block_seconds`` (the
host's time inside the call) by ``op`` and ``path`` (``device`` for the
collectives over the worker's device, ``host`` for the staged ones,
``barrier`` and the ``host_*`` collectives) into the default telemetry
registry, a
flight-recorder entry (begun before the call, completed after it, so a
rank hung in a collective names it), and a ``comm.<op>`` trace event.
:func:`iallreduce` and :func:`ibcast` begin their entry at the launch
and record under ``allreduce`` / ``bcast`` at ``wait()``, timing the
wait. With the registry, the flight recorder and the tracer all off,
a collective reads no clock and touches none of them. The gradient
all-reduce inside a train step is not an eager collective and records
nothing.
"""

from __future__ import annotations

from typing import Any, Callable

import functools
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import config, faults
from .errors import CollectiveError
from .runtime import _require_init, _state, resolve_device
from .telemetry import get_registry as _telemetry_registry
from .telemetry import tracing as _tracing
from .telemetry.flight_recorder import get_flight_recorder as _flight_recorder

__all__ = ["Request", "allreduce", "barrier", "bcast", "cpu", "device",
           "host_allgather", "host_allreduce", "host_bcast", "iallreduce",
           "ibcast", "reduce", "shard_ranks", "unshard_ranks"]

_OP_ALIASES = {
    "+": "sum", "sum": "sum", "add": "sum",
    "*": "prod", "prod": "prod", "mul": "prod",
    "min": "min", "max": "max",
    "mean": "mean", "avg": "mean",
}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "mean": dist.ReduceOp.SUM}
_NUMPY_OPS = {"sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max,
              "mean": np.mean}


def cpu(x: Any) -> Any:
    """A tensor moved to host memory, a numpy array as it is; anything
    else unchanged (the reference's ``cpu``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def device(x: Any, d: Any = None) -> Any:
    """A tensor or numpy array moved to device ``d`` (default: the
    worker's device after :func:`~fluxmpi_tpu_torch.init`, else
    ``cuda:0``); anything else unchanged (the reference's ``gpu``)."""
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    if d is None:
        d = _state.device if _state.initialized else resolve_device(None)
    return torch.as_tensor(x).to(d)


def _canonical_op(op: str) -> str:
    try:
        return _OP_ALIASES[op]
    except (KeyError, TypeError):
        raise ValueError(
            f"unsupported reduction op {op!r}; expected one of "
            f"{sorted(set(_OP_ALIASES))}"
        ) from None


def _check_root(root: int, world: int | None = None) -> int:
    world = _state.world if world is None else world
    if not isinstance(root, (int, np.integer)) or not 0 <= root < world:
        raise ValueError(f"root {root!r} out of range for {world} worker(s)")
    return int(root)


class _Axis:
    """The mesh axis an eager collective runs over, as this worker sees
    it: its ``size``, this worker's ``index`` along it, the ``members``
    (their world ranks, by index), and the process groups: ``group`` on
    the worker's device, ``host_group`` over gloo for host staging (made
    when a staged collective first asks: the step's device reductions
    over an axis never do)."""

    def __init__(self, mesh: Any, name: str):
        self.mesh, self.name = mesh, name
        self.size = int(mesh.shape[name])
        coords = mesh.coords(mesh.my_rank())
        self.index = coords[name]
        self.members = [
            int(mesh.devices[tuple(i if a == name else coords[a] for a in mesh.axis_names)])
            for i in range(self.size)]
        self.group = mesh.group((name,)) if self.size > 1 else None

    @functools.cached_property
    def host_group(self) -> Any:
        return self.mesh.host_group((self.name,)) if self.size > 1 else None


def _axis_and_size(mesh: Any, axis_name: str | None) -> tuple[str, int]:
    """The axis ``axis_name`` of ``mesh`` (which must have it), else its
    ``dp`` axis, else its first, and the axis's size."""
    if axis_name is not None:
        if axis_name not in mesh.shape:
            raise ValueError(f"axis {axis_name!r} not in mesh axes {mesh.axis_names}")
        return axis_name, mesh.shape[axis_name]
    name = config.DP_AXIS_NAME if config.DP_AXIS_NAME in mesh.shape else mesh.axis_names[0]
    return name, mesh.shape[name]


def shard_ranks(x: Any, mesh: Any = None, axis_name: str | None = None) -> torch.Tensor:
    """This worker's slice of a value stacked over the workers of a mesh
    axis (leading axis = the axis size; the axis as :func:`allreduce`
    picks it), on the worker's device: a ``[1, ...]`` tensor tagged with
    its layout, the block of the JAX package's laid-out array at this
    worker's coordinate. An input already laid out so is returned as
    it is."""
    from .parallel.sharding import NamedSharding, P, sharding_of, with_sharding

    _require_init()
    mesh = mesh or _state.mesh
    name, size = _axis_and_size(mesh, axis_name)
    sh = sharding_of(x)
    if (sh is not None and sh.mesh is mesh and tuple(sh.spec)[:1] == (name,)
            and not any(tuple(sh.spec)[1:])):
        return x
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"per-worker value must have leading axis == world size {size}, "
            f"got shape {tuple(x.shape)}")
    sharding = NamedSharding(mesh, P(name, *([None] * (x.ndim - 1))))
    return with_sharding(sharding.local_block(x).to(_state.device), sharding)


def unshard_ranks(x: Any) -> np.ndarray:
    """Every worker's block of ``x`` gathered back to a host numpy array of
    the global shape (the stacked value of :func:`shard_ranks`); a value
    with no layout is whole already."""
    from .parallel.sharding import sharding_of

    sh = sharding_of(x)
    if sh is None:
        return np.asarray(cpu(x))
    axes = [n for names in sh.spec if names is not None
            for n in ((names,) if isinstance(names, str) else names)]
    group = sh.mesh.group(axes)
    full = torch.empty(sh.global_shape(x.shape), dtype=x.dtype)
    ranks = dist.get_process_group_ranks(group) if group is not None else [sh.mesh.my_rank()]
    parts = [torch.empty_like(x) for _ in ranks]
    if group is not None:
        dist.all_gather(parts, x.detach().contiguous(), group=group)
    else:
        parts = [x.detach()]
    for r, part in zip(ranks, parts):
        start = sh.block_start(full.shape, r)
        index = tuple(slice(s, s + n) for s, n in zip(start, part.shape))
        full[index] = part.cpu()
    return full.numpy()


def _laid_out(x: Any, mesh: Any, axis_name: str | None) -> tuple[Any, str | None]:
    """``(mesh, axis_name)`` of a collective: an input that
    :func:`shard_ranks` laid out runs over its own axis unless the caller
    names one (the JAX package takes such an input as it is laid out)."""
    from .parallel.sharding import sharding_of

    sh = sharding_of(x)
    lead = tuple(sh.spec)[:1] if sh is not None else ()
    if mesh is None and axis_name is None and lead and isinstance(lead[0], str):
        return sh.mesh, lead[0]
    return mesh, axis_name


def _keep_layout(x: Any, out: Any) -> Any:
    """``out`` tagged with ``x``'s layout (a laid-out input's result is
    laid out the same way)."""
    from .parallel.sharding import sharding_of, with_sharding

    if torch.is_tensor(out) and out is not x:
        with_sharding(out, sharding_of(x))
    return out


# ``mesh=WORLD``: the whole world whatever the global mesh, for the
# package's own agreements (a preemption, a dataset's common length, a
# checkpoint's step), which every worker must reach together.
WORLD = object()


def _axis(mesh: Any, axis_name: str | None) -> "_Axis | None":
    """The axis a collective reduces over (the JAX package's choice:
    ``axis_name``, else the mesh's ``dp`` axis, else its first; ``mesh``
    defaults to the global mesh), or None when that axis spans the whole
    world (the world's own groups then carry it) or ``mesh`` is
    :data:`WORLD`."""
    if mesh is WORLD:
        return None
    if mesh is None:
        if not _state.initialized:
            return None
        mesh = _state.mesh
    if axis_name is not None and axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {mesh.axis_names}")
    name = axis_name or (config.DP_AXIS_NAME if config.DP_AXIS_NAME in mesh.shape
                         else mesh.axis_names[0])
    if mesh.shape[name] == _state.world:
        return None
    return _Axis(mesh, name)


def _all_reduce(flat: torch.Tensor, op: str, axis: "_Axis | None", group: Any = None,
                **kwargs: Any) -> Any:
    """``dist.all_reduce`` over the axis (``group`` when the caller staged
    through the host), or over the world; a one-member axis keeps
    ``flat``."""
    if axis is not None:
        if axis.size == 1:
            return None
        group = group if group is not None else axis.group
    return dist.all_reduce(flat, op=_REDUCE_OPS[op], group=group, **kwargs)


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        return torch.as_tensor(leaf)
    raise CollectiveError(
        f"collectives take tensors, numpy arrays or numbers, not "
        f"{type(leaf).__name__}"
    )


class _Packed:
    """A tree's leaves packed into one flat buffer per dtype on ``dev``
    (dtypes in a fixed order, so every worker's collectives line up), and
    the tree of results: views of the buffers where a leaf lives on
    ``dev``, else tensors filled by :meth:`finish`."""

    def __init__(self, tree: Any, dev: torch.device):
        leaves, self.spec = pytree.tree_flatten(tree)
        tensors = [_as_tensor(x) for x in leaves]
        groups: dict[torch.dtype, list[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        self.flats: list[torch.Tensor] = []
        self.out: list[Any] = [None] * len(tensors)
        self._copies: list[tuple[torch.Tensor, torch.Tensor]] = []
        for dtype in sorted(groups, key=str):
            idxs = groups[dtype]
            flat = torch.cat([tensors[i].detach().reshape(-1).to(dev) for i in idxs])
            offset = 0
            for i in idxs:
                t = tensors[i]
                view = flat[offset:offset + t.numel()].reshape(t.shape)
                if t.device == dev:
                    self.out[i] = view
                else:
                    self.out[i] = torch.empty_like(t)
                    self._copies.append((self.out[i], view))
                offset += t.numel()
            self.flats.append(flat)

    def finish(self) -> Any:
        for dst, src in self._copies:
            dst.copy_(src)
        return pytree.tree_unflatten(self.out, self.spec)


def _run(flat: torch.Tensor, fn: Callable[[torch.Tensor], Any]) -> Any:
    try:
        return fn(flat)
    except RuntimeError as exc:
        raise CollectiveError(f"collective on {flat.dtype} leaves failed: {exc}") from exc


def fused(tree: Any, fn: Callable[[torch.Tensor], None]) -> Any:
    """Run the in-place collective ``fn`` on one flat buffer per dtype,
    on the worker's device, holding copies of ``tree``'s leaves; returns
    the tree of results, each leaf on its own device and dtype."""
    packed = _Packed(tree, _state.device)
    for flat in packed.flats:
        _run(flat, fn)
    return packed.finish()


def _staging() -> bool:
    """Do the eager collectives stage through host memory?"""
    return bool(config.DEVICE_COLLECTIVES_DISABLED)


def _host_buffer(flat: torch.Tensor) -> torch.Tensor:
    """A host copy of ``flat``: pinned when it comes from the card."""
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=flat.is_cuda)
    host.copy_(flat)
    return host


def staged(tree: Any, fn: Callable[..., None], group: Any = None) -> Any:
    """:func:`fused` through host memory: each flat buffer is copied to a
    (pinned) host buffer, ``fn(host, group=...)`` runs over the runtime's
    gloo group (or ``group``) there, and the result is copied back;
    returns the tree of results, each leaf on its own device and dtype."""
    group = _state.host_group if group is None else group
    packed = _Packed(tree, _state.device)
    for flat in packed.flats:
        host = _host_buffer(flat)
        _run(host, lambda h: fn(h, group=group))
        flat.copy_(host)
    return packed.finish()


def eager(tree: Any, fn: Callable[..., None]) -> Any:
    """``fn(flat, group=None)`` over ``tree``'s flat buffers on the
    worker's device group, or through host memory under host staging
    (:func:`staged`)."""
    return staged(tree, fn) if _staging() else fused(tree, fn)


def _collective(x: Any, fn: Callable[..., None], donate: bool,
                axis: "_Axis | None" = None) -> Any:
    """Run the in-place collective ``fn(flat, group=None)`` over ``x``: on
    one flat buffer per dtype (a new result tree), or, with
    ``donate=True``, on each leaf in place (one collective per leaf, no
    copy; ``x`` itself is returned, its leaves contiguous tensors on the
    worker's device). Under host staging the buffers go through host
    memory (over ``axis``'s gloo group when one is given) and
    ``donate=True`` warns that it has no effect."""
    dev = _state.device
    if _staging():
        if donate:
            warnings.warn(
                "donate=True has no effect with device collectives disabled: "
                "the host-staging path copies through host memory (no "
                "in-place reuse)", stacklevel=5)
        return staged(x, fn, axis.host_group if axis is not None else None)
    if donate:
        leaves = pytree.tree_leaves(x)
        for leaf in leaves:
            if (not isinstance(leaf, torch.Tensor) or leaf.device != dev
                    or not leaf.is_contiguous()):
                raise ValueError(
                    f"donate=True needs contiguous tensors on the worker's "
                    f"device ({dev}); got "
                    + (f"a tensor on {leaf.device}" if isinstance(leaf, torch.Tensor)
                       else type(leaf).__name__))
        with torch.no_grad():
            for leaf in leaves:
                _run(leaf, fn)
        return x
    return fused(x, fn)


# ---------------------------------------------------------------------------
# Instrumentation (the JAX package's comm.py, the same names and labels).
# One `_instrumentation_on()` check gates everything; when on, the three
# labeled handles per (op, path) are resolved once and cached, keyed on
# the registry's identity and version.
# ---------------------------------------------------------------------------

# (op, path) -> (registry, registry.version, calls, bytes, block_seconds).
_handles: dict[tuple[str, str], tuple[Any, int, Any, Any, Any]] = {}


def _instrumentation_on() -> bool:
    """The single fast-guard for the collective hot path."""
    return (
        _telemetry_registry().enabled
        or _flight_recorder().enabled
        or _tracing.get_tracer().enabled
    )


def _begin_op(op_name: str, path: str, nbytes: int) -> Any:
    try:
        return _flight_recorder().begin(op_name, path, nbytes)
    except Exception:  # instrumentation must never take down a collective
        return None


def _abort_op(flight: Any) -> None:
    """Finalize a flight entry whose collective RAISED: an exception is
    not a hang."""
    if flight is None:
        return
    try:
        _flight_recorder().abort(flight)
    except Exception:
        pass


def _record_op(op_name: str, path: str, nbytes: int, t0: float,
               flight: Any = None) -> None:
    try:
        t1 = time.perf_counter()
        if flight is not None:
            _flight_recorder().complete(flight)
        _tracing.add_complete_event(
            "comm." + op_name, t0, t1, path=path, nbytes=int(nbytes)
        )
        reg = _telemetry_registry()
        if not reg.enabled:
            return
        key = (op_name, path)
        cached = _handles.get(key)
        if cached is None or cached[0] is not reg or cached[1] != reg.version:
            cached = (
                reg,
                reg.version,
                reg.counter("comm.calls", op=op_name, path=path),
                reg.counter("comm.bytes", op=op_name, path=path),
                reg.histogram("comm.block_seconds", op=op_name, path=path),
            )
            _handles[key] = cached
        _, _, calls, nbytes_total, block = cached
        calls.inc()
        nbytes_total.inc(float(nbytes))
        block.observe(t1 - t0)
    except Exception:  # instrumentation must never take down a collective
        pass


def _tree_nbytes(x: Any) -> int:
    total = 0
    for leaf in pytree.tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


def _instrumented(op_name: str, path: str, nbytes: Any, call: Callable[[], Any]) -> Any:
    """Run ``call()`` as the eager collective ``op_name``: with the
    instrumentation on, inside a flight entry and timed (``nbytes`` is a
    number, or a zero-argument callable evaluated only then)."""
    if not _instrumentation_on():
        return call()
    t0 = time.perf_counter()
    n = nbytes() if callable(nbytes) else nbytes
    flight = _begin_op(op_name, path, n)
    try:
        out = call()
    except BaseException:
        _abort_op(flight)
        raise
    _record_op(op_name, path, n, t0, flight)
    return out


def _mean_fix(flat: torch.Tensor, world: int) -> None:
    if flat.is_floating_point():
        flat.div_(world)
    else:
        flat.floor_divide_(world)


def _path() -> str:
    return "host" if _staging() else "device"


def allreduce(x: Any, op: str = "sum", *, mesh: Any = None,
              axis_name: str | None = None, donate: bool = False) -> Any:
    """Every worker gets the reduction (``sum``, ``prod``, ``min``,
    ``max`` or ``mean``) of all workers' values. ``donate=True`` reduces
    each leaf (a contiguous tensor on the worker's device) in place and
    returns ``x`` itself. ``mesh``/``axis_name``: reduce over one axis of
    a mesh (default the global mesh's ``dp`` axis, else its first): the
    workers that differ only along that axis; every other coordinate of
    the mesh gets its own result, as the JAX package's collective over a
    mesh axis gives."""
    _require_init()
    op = _canonical_op(op)
    if faults.ARMED:
        faults.check("comm.allreduce")
    axis = _axis(*_laid_out(x, mesh, axis_name))
    size = _state.world if axis is None else axis.size

    def run(flat, group=None):
        _all_reduce(flat, op, axis, group)
        if op == "mean":
            _mean_fix(flat, size)

    return _keep_layout(x, _instrumented("allreduce", _path(), lambda: _tree_nbytes(x),
                                         lambda: _collective(x, run, donate, axis)))


def _broadcast(flat: torch.Tensor, root: int, axis: "_Axis | None", group: Any = None,
               **kwargs: Any) -> Any:
    """``dist.broadcast`` from member ``root`` of the axis (or of the
    world)."""
    if axis is None:
        return dist.broadcast(flat, src=root, group=group, **kwargs)
    if axis.size == 1:
        return None
    return dist.broadcast(flat, src=axis.members[root],
                          group=group if group is not None else axis.group, **kwargs)


def bcast(x: Any, root: int = 0, *, mesh: Any = None, axis_name: str | None = None,
          donate: bool = False) -> Any:
    """Every worker gets the ``root`` worker's value (``root`` indexes the
    axis's workers under ``mesh``/``axis_name``, as in :func:`allreduce`).
    ``donate=True`` broadcasts into each leaf in place and returns ``x``
    itself."""
    _require_init()
    axis = _axis(*_laid_out(x, mesh, axis_name))
    root = _check_root(root, None if axis is None else axis.size)
    if faults.ARMED:
        faults.check("comm.bcast")
    return _keep_layout(x, _instrumented(
        "bcast", _path(), lambda: _tree_nbytes(x),
        lambda: _collective(
            x, lambda flat, group=None: _broadcast(flat, root, axis, group),
            donate, axis)))


def reduce(x: Any, op: str = "sum", root: int = 0, *, mesh: Any = None,
           axis_name: str | None = None, donate: bool = False) -> Any:
    """The ``root`` worker gets the reduction of all workers' values;
    every other worker gets its own input back (over one mesh axis with
    ``mesh``/``axis_name``, as in :func:`allreduce`). ``donate=True``
    reduces into the root's leaves in place and returns ``x`` itself on
    every worker (the others' values unchanged)."""
    _require_init()
    op = _canonical_op(op)
    axis = _axis(mesh, axis_name)
    size, me = (_state.world, _state.rank) if axis is None else (axis.size, axis.index)
    root = _check_root(root, size)
    if faults.ARMED:
        faults.check("comm.reduce")

    def run(flat, group=None):
        # An all-reduce whose result only the root keeps: a rooted reduce
        # may use the other workers' buffers as scratch, which their
        # donated inputs forbid.
        own = None if me == root else flat.clone()
        _all_reduce(flat, op, axis, group)
        if own is not None:
            flat.copy_(own)
        elif op == "mean":
            _mean_fix(flat, size)

    return _instrumented("reduce", _path(), lambda: _tree_nbytes(x),
                         lambda: _collective(x, run, donate, axis))


class Request:
    """Completion handle of :func:`iallreduce` and :func:`ibcast` (the
    reference's ``MPI.Request``): ``wait()`` waits on the collectives'
    ``torch.distributed`` work handles (on the card, the current stream
    waits for NCCL's) and returns ``value``, the result tree, which holds
    the result from then on."""

    def __init__(self, value: Any) -> None:
        self._value = value
        self._pending: tuple | None = None
        # (op, nbytes, flight entry) when the launch was instrumented.
        self._record: tuple | None = None

    def wait(self) -> Any:
        if self._pending is not None:
            packed, works, post = self._pending
            record, self._record = self._record, None
            t0 = time.perf_counter() if record is not None else 0.0
            try:
                for work in works:
                    work.wait()
            except BaseException:
                if record is not None:
                    _abort_op(record[2])
                raise
            if post is not None:
                for flat in packed.flats:
                    post(flat)
            packed.finish()
            self._pending = None
            if record is not None:
                _record_op(record[0], "device", record[1], t0, record[2])
        return self._value

    @staticmethod
    def wait_all(requests: "list[Request]") -> list[Any]:
        return [r.wait() for r in requests]


def _start(op_name: str, x: Any, fn: Callable[[torch.Tensor], Any],
           post: Callable | None = None) -> tuple[Any, Request]:
    """Start ``fn(flat)`` (an ``async_op=True`` collective) on each flat
    buffer of ``x``; returns the result tree and its request, which
    records the collective as ``op_name`` at ``wait()``."""
    record = None
    instrumented = _instrumentation_on()
    if instrumented:
        nbytes = _tree_nbytes(x)
        record = (op_name, nbytes, _begin_op(op_name, "device", nbytes))
    packed = _Packed(x, _state.device)
    try:
        works = [w for w in (_run(flat, fn) for flat in packed.flats) if w is not None]
    except BaseException:
        if instrumented:
            _abort_op(record[2])
        raise
    value = pytree.tree_unflatten(packed.out, packed.spec)
    req = Request(value)
    req._pending = (packed, works, post)
    req._record = record
    return value, req


def iallreduce(x: Any, op: str = "sum", *, mesh: Any = None,
               axis_name: str | None = None) -> tuple[Any, Request]:
    """Non-blocking all-reduce: returns ``(value, request)`` at once; the
    value holds the reduction once ``request.wait()`` returns (the
    reference's ``Iallreduce!``; ``mesh``/``axis_name`` as in
    :func:`allreduce`). Under host staging it is the blocking staged
    :func:`allreduce`, complete when it returns (as the JAX package's
    ``iallreduce`` is its ``allreduce``)."""
    if _staging():
        out = allreduce(x, op, mesh=mesh, axis_name=axis_name)
        return out, Request(out)
    _require_init()
    op = _canonical_op(op)
    if faults.ARMED:
        faults.check("comm.allreduce")
    axis = _axis(mesh, axis_name)
    size = _state.world if axis is None else axis.size
    post = (lambda flat: _mean_fix(flat, size)) if op == "mean" else None
    return _start("allreduce", x,
                  lambda flat: _all_reduce(flat, op, axis, async_op=True), post)


def ibcast(x: Any, root: int = 0, *, mesh: Any = None,
           axis_name: str | None = None) -> tuple[Any, Request]:
    """Non-blocking broadcast from ``root`` (the reference's ``Ibcast!``;
    ``mesh``/``axis_name`` as in :func:`bcast`)."""
    _require_init()
    axis = _axis(mesh, axis_name)
    root = _check_root(root, None if axis is None else axis.size)
    if faults.ARMED:
        faults.check("comm.bcast")
    return _start("bcast", x,
                  lambda flat: _broadcast(flat, root, axis, async_op=True))


def barrier(tag: str = "fluxmpi_barrier") -> None:
    """Block until every worker reaches this point (device work queued
    before it included). ``tag`` names the barrier."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.barrier")

    def run():
        if _state.device.type == "cuda":
            torch.cuda.synchronize(_state.device)
        dist.barrier()

    _instrumented("barrier", "host", 0, run)


def _host_gathered(h: np.ndarray) -> np.ndarray:
    """Every process's ``h`` stacked on a new leading axis, over the gloo
    group."""
    t = torch.from_numpy(np.ascontiguousarray(h))
    parts = [torch.empty_like(t) for _ in range(_state.world)]
    try:
        dist.all_gather(parts, t, group=_state.host_group)
    except RuntimeError as exc:
        raise CollectiveError(f"host collective failed: {exc}") from exc
    return torch.stack(parts).numpy()


def host_allreduce(x: Any, op: str = "sum") -> np.ndarray:
    """Reduce a per-process host value across all processes: numpy's
    reduction (``sum``, ``prod``, ``min``, ``max``, ``mean``) over the
    gathered values, in the input's dtype (``mean`` of integers in
    numpy's float)."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_allreduce")
    op = _canonical_op(op)
    h = np.asarray(x)

    def run():
        if _state.world == 1:
            return h
        out = _NUMPY_OPS[op](_host_gathered(h), axis=0)
        return np.asarray(out if op == "mean" else out.astype(h.dtype, copy=False))

    return _instrumented("host_allreduce", "host", h.nbytes, run)


def host_allgather(x: Any) -> np.ndarray:
    """Gather a per-process host value from every process: an array with a
    leading ``process_count()`` axis (this process's value at its own
    index)."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_allgather")
    h = np.asarray(x)
    return _instrumented(
        "host_allgather", "host", h.nbytes,
        lambda: h[None] if _state.world == 1 else _host_gathered(h))


def host_bcast(x: Any, root: int = 0) -> np.ndarray:
    """Broadcast a per-process host value from the ``root`` process to
    all."""
    _require_init()
    if faults.ARMED:
        faults.check("comm.host_bcast")
    root = _check_root(root)
    h = np.asarray(x)

    def run():
        if _state.world == 1:
            return h
        t = torch.from_numpy(np.array(h, copy=True))
        try:
            dist.broadcast(t, src=root, group=_state.host_group)
        except RuntimeError as exc:
            raise CollectiveError(f"host collective failed: {exc}") from exc
        return t.numpy()

    return _instrumented("host_bcast", "host", h.nbytes, run)
