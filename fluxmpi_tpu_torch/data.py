"""Sharded datasets and the distributed batch loader.

Counterpart of :mod:`fluxmpi_tpu.data` (the reference's
``DistributedDataContainer`` inside a data loader): each worker draws its
contiguous ceil-partition shard (the remainder on the last rank), and the
loader hands out per-worker batches of ``global_batch_size / world`` in
the same order the JAX package's loader does, sample for sample: the same
``np.random.default_rng(seed + epoch)`` shuffles and the same
full-dataset permutation slice under ``global_shuffle``.

Two paths assemble a batch. The device-gather path (``device_gather=
"auto"``, the default, or ``True``) stages an array-backed dataset in
device memory once (cached across epochs), copies each epoch's
permutation once, and takes each batch as an index slice of the
permutation and a gather per leaf on the device (:func:`_gather_batch`,
the one copy of that math, which the fused training window runs too):
no per-batch host work. In a world of several workers each worker stages
on its own card what its batches read: its shard of a
:class:`DistributedDataContainer` in the per-worker view, the whole
dataset in the mesh view, under ``elastic_order=True`` and under
``global_shuffle`` (as the JAX package stages it replicated on every
device), and the permutation lists this worker's rows, batch by batch.
Otherwise batches are assembled on the host: an array-backed dataset's
whole batches by the C++ prefetcher
(:class:`fluxmpi_tpu_torch.io.NativePrefetcher`, one per array leaf,
building the next batches on its own threads; the ragged tail by
:func:`fluxmpi_tpu_torch.io.gather_rows`), any other dataset's sample by
sample with numpy; then staged in pinned memory and copied to the device
with ``non_blocking`` copies, ``prefetch`` batches ahead. Every path
yields the same batches.

``transform=`` runs a host-side hook on every assembled host batch:
``transform(batch)`` or ``transform(batch, rng)``, the ``rng``
``np.random.default_rng([seed, epoch, b, rank])`` keyed by the absolute
batch index ``b`` of the epoch, so a resumed pass draws what the
uninterrupted one drew. A transformed dataset keeps the host path.

Each batch crosses the fault site ``data.fetch`` once it is assembled
(:mod:`fluxmpi_tpu_torch.faults`), is a watchdog progress tick, and, with
telemetry on, is timed into ``data.batch_fetch_seconds`` and a
``data.fetch`` trace event (``data.prefetch_depth`` holds the queue
behind each yield), as in the JAX package.

Over a mesh (``mesh=``, ``axis_name=``, or a plan installed by
``init(parallel=)``) in a world of several workers, the loader reads the
global batch: every worker walks the same epoch order of the whole
dataset (a :class:`DistributedDataContainer` contributes its full
dataset), batch ``b`` is rows ``b * global_batch_size`` onward, and the
worker at data-axis block ``k`` of ``D`` (the batch axes: one mesh axis
or the product of a tuple, first outermost) takes its ``k``-th slice of
``global_batch_size / D`` rows, the rows the JAX package's addressable
shard at the same mesh coordinate holds. Workers that share a data block
(over ``tp``, say) read the same rows.

``elastic_order=True`` makes the order batch-major across workers in a
world of several (the same view without a mesh: worker ``r`` of ``W``
takes slice ``r`` of every global batch), so which samples batch ``b``
holds does not depend on the worker count; a state saved under another
batch geometry (:meth:`DistributedDataLoader.geometry`) remaps its cursor
through the global sample offset it denotes
(:meth:`DistributedDataLoader.load_state_dict`), the elastic resume.
"""

from __future__ import annotations

import inspect
import math
import os
import time
import warnings
from collections import deque
from typing import Any, Iterator, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import config, faults, runtime
from .io import NativePrefetcher, gather_rows
from .telemetry import get_registry as _telemetry_registry
from .telemetry import tracing as _tracing
from .telemetry.watchdog import notify_progress

__all__ = [
    "ArrayDataset",
    "DistributedDataContainer",
    "DistributedDataLoader",
    "scan_batches",
]


# device_gather="auto" staging budget: the staged dataset costs its bytes
# of device memory, so "auto" engages only below this.
_DEVICE_GATHER_DEFAULT_MAX_BYTES = 256 * 1024 * 1024


def _device_gather_budget() -> int:
    """The ``FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES`` budget; a malformed
    value falls back to the 256 MiB default with a warning."""
    raw = os.environ.get("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES")
    if not raw:
        return _DEVICE_GATHER_DEFAULT_MAX_BYTES
    try:
        return int(raw)
    except ValueError:
        warnings.warn(
            f"FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES={raw!r} is not an "
            f"integer byte count; falling back to the 256 MiB default",
            stacklevel=2,
        )
        return _DEVICE_GATHER_DEFAULT_MAX_BYTES


def _gather_batch(data: Any, perm: torch.Tensor, start: torch.Tensor,
                  lbs: int) -> Any:
    """One batch from the staged dataset: positions ``start .. start + lbs
    - 1`` of the epoch permutation ``perm`` (int32, dataset rows), then a
    take along the first axis of every leaf of ``data``. ``start`` is a
    0-d int tensor on the device, so a CUDA graph that captured this
    gathers wherever the host has set it. The one copy of the gather
    math: the loader's device-gather iteration and the fused training
    window both run it, so both consume the same batches."""
    idx = perm[start + torch.arange(lbs, device=perm.device)]
    return pytree.tree_map(lambda a: a.index_select(0, idx), data)


def _world() -> tuple[int, int]:
    """``(rank, world)`` of the runtime; one worker before :func:`init`."""
    if runtime.is_initialized():
        return runtime.process_index(), runtime.process_count()
    return 0, 1


class ArrayDataset:
    """A dataset backed by a tree (tuple, list or dict) of equal-length
    arrays; sample ``i`` is the tree of each array's row ``i``. Loaders
    recognize it and gather whole batches with one fancy index per leaf."""

    def __init__(self, arrays: Any):
        leaves, spec = pytree.tree_flatten(arrays)
        if not leaves:
            raise ValueError("ArrayDataset needs at least one array")
        n = len(leaves[0])
        for leaf in leaves:
            if len(leaf) != n:
                raise ValueError("all arrays must share the leading dimension")
        self.arrays = pytree.tree_unflatten(
            [np.ascontiguousarray(np.asarray(x)) for x in leaves], spec)
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Any:
        return pytree.tree_map(lambda a: a[i], self.arrays)


def _shard_bounds(total_size: int, rank: int, world: int) -> range:
    """Contiguous ceil-partition (the reference's ``DistributedDataContainer``
    bounds)."""
    size_per_process = math.ceil(total_size / world)
    n_partitions = math.ceil(total_size / size_per_process) if size_per_process else 0
    if rank >= n_partitions:
        raise IndexError(
            f"rank {rank} has no data shard: {total_size} samples across "
            f"{world} workers yields only {n_partitions} non-empty shards"
        )
    start = rank * size_per_process
    stop = min(start + size_per_process, total_size)
    return range(start, stop)


class DistributedDataContainer:
    """Shard any indexable dataset contiguously by worker rank. ``rank`` and
    ``world`` default to the runtime's (one worker before ``init``)."""

    def __init__(self, data: Any, *, rank: int | None = None,
                 world: int | None = None):
        if (rank is None) != (world is None):
            raise ValueError("pass rank and world together, or neither")
        if rank is None:
            rank, world = _world()
        self.data = data
        self.rank = rank
        self.world = world
        self.total_size = len(data)
        self.idxs = _shard_bounds(self.total_size, rank, world)

    def min_shard_size(self) -> int:
        """Size of the smallest shard in this container's world (the last
        rank's remainder) — what every worker can serve, which keeps the
        workers in lockstep."""
        spp = math.ceil(self.total_size / self.world)
        return max(0, self.total_size - (self.world - 1) * spp)

    def __len__(self) -> int:
        return len(self.idxs)

    def __getitem__(self, i: int) -> Any:
        return self.data[self.idxs[i]]

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]


def _transform_arity(transform: Any, with_rng: bool | None) -> int:
    """0 without a transform; else 2 when it takes ``(batch, rng)``, 1 when
    ``(batch)``: the explicit flag, then the callable's own
    ``transform_with_rng`` attribute, then its signature (two or more
    required positional parameters)."""
    if transform is None:
        if with_rng is not None:
            raise ValueError("transform_with_rng given without transform")
        return 0
    if not callable(transform):
        raise ValueError("transform must be callable")
    if with_rng is None:
        with_rng = getattr(transform, "transform_with_rng", None)
    if with_rng is not None:
        return 2 if with_rng else 1
    try:
        params = inspect.signature(transform).parameters.values()
        # Only required positional parameters decide the call shape:
        # f(batch, eps=1e-6) or f(batch, *, training=False) takes no rng.
        required = sum(1 for p in params
                       if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                       and p.default is p.empty)
    except (TypeError, ValueError):  # builtins, C callables
        warnings.warn(
            "transform signature is not inspectable; assuming "
            "transform(batch) without an rng. Pass "
            "transform_with_rng= (or set a transform_with_rng "
            "attribute on the callable) to declare its call "
            "shape explicitly.",
            stacklevel=3,
        )
        required = 1
    return 2 if required >= 2 else 1


def _lead_dims(tree: Any) -> dict[str, int | None]:
    """Each leaf's leading dimension by its path (None for a 0-d leaf)."""
    pairs, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(path): (np.shape(x)[0] if np.ndim(x) else None)
            for path, x in pairs}


def _stack_samples(samples: Sequence[Any]) -> Any:
    leaves = [pytree.tree_flatten(s)[0] for s in samples]
    spec = pytree.tree_flatten(samples[0])[1]
    return pytree.tree_unflatten(
        [np.stack([np.asarray(lv[j]) for lv in leaves]) for j in range(len(leaves[0]))],
        spec)


class DistributedDataLoader:
    """Iterate this worker's batches, on its device.

    ``data``: an indexable dataset (usually a
    :class:`DistributedDataContainer`). ``global_batch_size`` is the
    batch across all workers; each worker yields ``local_batch_size =
    global_batch_size // world`` samples per batch. ``shuffle`` reshuffles
    the local order each epoch with ``np.random.default_rng(seed +
    epoch)``; ``global_shuffle`` (a container is required; implies
    ``shuffle``) takes this worker's slice of a seeded permutation of the
    FULL dataset, the same on every worker. ``drop_last`` drops the
    trailing incomplete batch. ``prefetch`` batches are kept ahead of the
    consumer with their host→device copies in flight. ``device``: default
    the runtime's worker device, else CUDA; ``"cpu"`` only when asked.

    ``device_gather``: ``"auto"`` (default) gathers batches on the device
    when the dataset is array-backed (an :class:`ArrayDataset`, optionally
    inside a :class:`DistributedDataContainer`) and the bytes this worker
    stages on its card (its shard in the per-worker view, the whole
    dataset in the mesh view; the module docstring) fit
    ``FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES`` (default 256 MiB); ``True``
    forces it (raises for a dataset that is not array-backed); ``False``
    keeps the host path. A ragged trailing batch (``drop_last=False``) is
    always assembled on the host.

    ``transform``: an optional host-side hook applied to each assembled
    local batch (a tree of numpy arrays) before it moves to the device:
    ``transform(batch)``, or ``transform(batch, rng)`` with ``rng =
    np.random.default_rng([seed, epoch, b, rank])`` for batch ``b`` of the
    epoch (absolute, so a resumed pass reproduces the uninterrupted one).
    It must keep every leaf's leading (batch) dimension. A transform keeps
    the host path: ``device_gather="auto"`` then does not engage, and
    ``device_gather=True`` beside it raises. ``transform_with_rng``
    declares the call shape (``True``: two arguments); by default a
    ``transform_with_rng`` attribute on the callable decides, then the
    signature (two or more required positional parameters take the rng).
    """

    def __init__(self, data: Any, global_batch_size: int, *,
                 shuffle: bool = False, global_shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device=None, device_gather: bool | str = "auto",
                 elastic_order: bool = False, transform: Any = None,
                 transform_with_rng: bool | None = None,
                 mesh: Any = None, axis_name: Any = None):
        if device_gather not in (True, False, "auto"):
            raise ValueError(f"device_gather must be True, False, or 'auto', "
                             f"got {device_gather!r}")
        rank, world = _world()
        self.elastic_order = bool(elastic_order)
        if self.elastic_order and world > 1:
            if not isinstance(data, DistributedDataContainer) or (
                    data.world != world or data.rank != rank):
                raise ValueError(
                    "elastic_order needs the full-dataset view of a "
                    "default-sharded DistributedDataContainer (rank/world "
                    "matching the process world): the batch-major sample "
                    "assignment is computed from the whole dataset"
                )
            if not drop_last:
                raise ValueError(
                    "elastic_order requires drop_last=True: the trailing "
                    "total %% global_batch_size samples round down so the "
                    "epoch is a whole number of topology-invariant batches"
                )
        if global_shuffle and not isinstance(data, DistributedDataContainer):
            raise ValueError(
                "global_shuffle reshuffles the sample→worker assignment, "
                "which needs the full-dataset view of a "
                "DistributedDataContainer; wrap the dataset in one"
            )
        if global_batch_size % world != 0:
            raise ValueError(
                f"global_batch_size {global_batch_size} must divide evenly "
                f"across {world} workers"
            )
        explicit = mesh is not None or axis_name is not None
        plan = runtime.global_plan()
        if axis_name is None:
            # The plan's data axes are the default only when this loader
            # rides a mesh carrying them.
            if plan is not None and plan.covers(mesh):
                axes = plan.data_axes
                axis_name = axes[0] if len(axes) == 1 else axes
            else:
                axis_name = config.DP_AXIS_NAME
        elif isinstance(axis_name, (list, tuple)):
            axis_name = axis_name[0] if len(axis_name) == 1 else tuple(axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        mesh_for_check = mesh
        if mesh_for_check is None and runtime.is_initialized():
            mesh_for_check = runtime.global_mesh()
        # (block, blocks): this worker's slice of every global batch, when
        # the loader reads the global batch over a mesh.
        self._mesh_view: tuple[int, int] | None = None
        if mesh_for_check is not None:
            names = (axis_name,) if isinstance(axis_name, str) else axis_name
            axis_size = math.prod(mesh_for_check.shape.get(a, 1) for a in names)
            if global_batch_size % axis_size != 0:
                raise ValueError(
                    f"global_batch_size {global_batch_size} must be divisible "
                    f"by the '{axis_name}' mesh axis size {axis_size} so every "
                    f"device gets an equal slice"
                )
            if world > 1 and (explicit or plan is not None):
                present = tuple(a for a in names if a in mesh_for_check.shape)
                block = (mesh_for_check.block_index(rank, present)[0]
                         if present else 0)
                self._mesh_view = (block, axis_size)
        if self._mesh_view is None and self.elastic_order and world > 1:
            # Batch-major: worker r of W takes slice r of every global
            # batch of the full-dataset order.
            self._mesh_view = (rank, world)
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.data = data
        # A container's shard as the per-worker view stages it (made on
        # first use).
        self._shard_arrays: Any = None
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // world
        if self._mesh_view is not None:
            self.local_batch_size = global_batch_size // self._mesh_view[1]
        self.world = world
        self.shuffle = shuffle or global_shuffle
        self.global_shuffle = global_shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        if device_gather is True and transform is not None:
            raise ValueError(
                "device_gather=True is incompatible with transform= "
                "(transforms run on host numpy batches); use "
                "device_gather=False or 'auto'")
        if device_gather is True and self._array_backing() is None:
            raise ValueError(
                "device_gather=True requires an array-backed dataset "
                "(ArrayDataset, optionally inside a "
                "DistributedDataContainer)")
        self.device_gather = device_gather
        self.transform = transform
        self._transform_arity = _transform_arity(transform, transform_with_rng)
        # (arrays object, staged tensors): the stage-once half of the
        # device-gather path, keyed by identity.
        self._gather_cache: tuple[Any, Any] | None = None
        if device is None and runtime.is_initialized():
            self.device = runtime.worker_device()
        else:
            self.device = runtime.resolve_device(device)
        self._epoch = 0
        self._iter_epoch = 0
        self._cursor = 0
        self._resume_cursor = 0
        # Shard sizes can differ (ceil partition, remainder on the last
        # rank); every worker serves the common (minimum) length so all
        # yield the same number of batches.
        if self._mesh_view is not None:
            total = len(self._view_source())
            if not drop_last and total % global_batch_size:
                raise ValueError(
                    f"drop_last=False over a mesh needs whole global batches: "
                    f"{total} samples is not a multiple of {global_batch_size}")
            self._common_len = (total // global_batch_size) * self.local_batch_size
        elif isinstance(data, DistributedDataContainer):
            self._common_len = data.min_shard_size()
        elif world > 1:
            from .comm import WORLD, allreduce

            self._common_len = int(allreduce(torch.tensor(len(data)), op="min",
                                             mesh=WORLD))
        else:
            self._common_len = len(data)

    def __len__(self) -> int:
        if self.drop_last:
            return self._common_len // self.local_batch_size
        return math.ceil(self._common_len / self.local_batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch counter that keys the per-epoch shuffle."""
        self._epoch = int(epoch)
        self._iter_epoch = int(epoch)
        self._cursor = 0
        self._resume_cursor = 0

    def state_dict(self) -> dict[str, int]:
        """Iteration position: the ``epoch`` whose order the current pass
        uses, the ``cursor`` of batches handed to the consumer in it (the
        read-ahead never counts), and the ``seed``."""
        return {"epoch": self._iter_epoch, "cursor": self._cursor,
                "seed": self.seed}

    def geometry(self) -> dict[str, int]:
        """The batch geometry a cursor's meaning depends on."""
        return {"process_count": self.world,
                "global_batch_size": self.global_batch_size,
                "num_batches": len(self), "elastic_order": int(self.elastic_order)}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore a :meth:`state_dict`: the next ``iter()`` replays
        ``epoch``'s order from batch ``cursor`` (a cursor at the end of the
        epoch resumes at the next one).

        Elastic resume: when ``state`` also carries the saving loader's
        :meth:`geometry` and it differs from this loader's (another worker
        count or global batch size), the cursor is remapped through the
        global sample offset it denotes (``cursor * saved
        global_batch_size`` samples of the epoch consumed), rounding down
        to the last whole batch of the new width; the samples of a partial
        batch that are seen again are counted in a warning (none are
        skipped). The remap is sample-exact when the order is batch-major
        on both sides: one worker, a mesh view, or ``elastic_order=True``
        (a warning names the caveat otherwise). A ``state`` without
        geometry (saved before elastic resume) must fit this geometry, or
        the error names the probable topology change."""
        seed = int(state.get("seed", self.seed))
        if seed != self.seed:
            raise ValueError(
                f"loader state was captured with seed {seed} but this "
                f"loader uses seed {self.seed}: the resumed sample order "
                f"would silently diverge from the interrupted run"
            )
        epoch, cursor = int(state["epoch"]), int(state["cursor"])
        geom = self.geometry()
        saved_geom = {key: int(state[key]) for key in geom if key in state}
        have_geom = all(key in saved_geom for key in
                        ("process_count", "global_batch_size", "num_batches"))
        if have_geom and any(saved_geom[k] != geom[k] for k in saved_geom):
            cursor = self._remap_cursor(cursor, saved_geom)
        elif cursor < 0 or cursor > len(self):
            hint = (
                " — the state carries no batch geometry (a pre-elastic "
                "checkpoint), so it can only resume on the topology that "
                f"saved it; this loader spans {geom['process_count']} "
                f"process(es) at global batch {geom['global_batch_size']}, "
                "and a cursor that does not fit usually means the saving "
                "run had a different process count or batch size"
                if not have_geom else "")
            raise ValueError(f"cursor {cursor} out of range for a "
                             f"{len(self)}-batch epoch{hint}")
        if cursor >= len(self):
            epoch, cursor = epoch + 1, 0
        self._epoch = epoch
        self._iter_epoch = epoch
        self._cursor = cursor
        self._resume_cursor = cursor

    def _remap_cursor(self, cursor: int, saved: dict[str, int]) -> int:
        """N→M cursor remap: the banked cursor meant ``cursor * saved_gbs``
        samples of the epoch consumed; this loader's cursor is that offset
        rounded down to the last whole new-width batch."""
        old_gbs = saved["global_batch_size"]
        old_len = saved["num_batches"]
        if cursor < 0 or cursor > old_len:
            raise ValueError(
                f"cursor {cursor} out of range for the saved "
                f"{old_len}-batch epoch (saved geometry: "
                f"{saved['process_count']} process(es), global batch "
                f"{old_gbs})")
        if cursor >= old_len:
            # The saved pass was complete (the banked epoch count has it):
            # it stays complete under the new width.
            return len(self)
        offset = cursor * old_gbs
        new_gbs = self.global_batch_size
        new_cursor = offset // new_gbs
        reseen = 0
        if new_cursor >= len(self):
            warnings.warn(
                f"elastic resume remapped the loader cursor {cursor} "
                f"(global batch {old_gbs}) past the new geometry's "
                f"whole-batch coverage ({len(self)} × {new_gbs}): the "
                f"interrupted epoch's remaining "
                f"{old_len * old_gbs - offset} sample(s) fall into the "
                f"new width's ragged tail and are dropped — resuming at "
                f"the next epoch", stacklevel=3)
            new_cursor = len(self)
        else:
            reseen = offset - new_cursor * new_gbs
        # Sample-exactness needs a batch-major sample→batch assignment on
        # both sides.
        saved_batch_major = saved["process_count"] == 1 or bool(
            saved.get("elastic_order", 0))
        here_batch_major = self.world == 1 or self._mesh_view is not None
        if not (saved_batch_major and here_batch_major):
            warnings.warn(
                "elastic cursor remap with a multi-process side not "
                "built with elastic_order=True: fixed contiguous shards "
                "reassign samples to workers when the world resizes, so "
                "the resumed epoch is sample-exact only in expectation — "
                "construct multi-process loaders with elastic_order=True "
                "for the exact contract", stacklevel=3)
        if reseen:
            warnings.warn(
                f"elastic resume remapped the loader cursor {cursor} "
                f"(global batch {old_gbs}, {saved['process_count']} "
                f"process(es)) to {new_cursor} (global batch {new_gbs}, "
                f"{self.world} process(es)); the offset lands "
                f"mid-batch, so {reseen} already-consumed sample(s) are "
                f"re-seen (rounded down to the last whole batch — none "
                f"skipped)", stacklevel=3)
        return new_cursor

    def _view_source(self) -> Any:
        """The whole dataset the mesh view reads."""
        data = self.data
        return data.data if isinstance(data, DistributedDataContainer) else data

    def _epoch_plan(self) -> tuple[np.ndarray, Any, int | None]:
        """This epoch's order: ``(order, source, offset)`` where ``order``
        indexes ``source``; ``offset`` is the index shift into an
        array-backed dataset's arrays (None when the source is not
        array-backed)."""
        if self._mesh_view is not None:
            block, blocks = self._mesh_view
            source = self._view_source()
            total = len(source)
            rng = np.random.default_rng(self.seed + self._epoch)
            if self.global_shuffle:
                full = rng.permutation(total)
            else:
                full = np.arange(total)
                if self.shuffle:
                    rng.shuffle(full)
            gbs, lbs = self.global_batch_size, self.local_batch_size
            n = total // gbs
            order = full[:n * gbs].reshape(n, blocks, lbs)[:, block, :].reshape(-1)
            offset = 0 if isinstance(source, ArrayDataset) else None
            return order, source, offset
        if self.global_shuffle:
            cont = self.data
            rng = np.random.default_rng(self.seed + self._epoch)
            perm = rng.permutation(cont.total_size)
            order = perm[cont.idxs.start:cont.idxs.stop]
            source = cont.data
            offset = 0 if isinstance(source, ArrayDataset) else None
            return order, source, offset
        source = self.data
        order = np.arange(len(source))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        offset = None
        if isinstance(source, ArrayDataset):
            offset = 0
        elif isinstance(source, DistributedDataContainer) and isinstance(
                source.data, ArrayDataset):
            offset = source.idxs.start
        return order, source, offset

    def _array_backing(self) -> tuple[Any, int] | None:
        """``(arrays, offset)`` when this epoch's source is array-backed:
        the array tree the epoch order indexes (shifted by ``offset``)."""
        data = self.data
        if self._mesh_view is not None:
            source = self._view_source()
            return (source.arrays, 0) if isinstance(source, ArrayDataset) else None
        if self.global_shuffle:
            # The order holds indices into the full dataset.
            return (data.data.arrays, 0) if isinstance(data.data, ArrayDataset) else None
        if isinstance(data, ArrayDataset):
            return data.arrays, 0
        if isinstance(data, DistributedDataContainer) and isinstance(
                data.data, ArrayDataset):
            # The per-worker view reads this worker's shard alone: it
            # stages those rows (views of the dataset's arrays, made once),
            # and the epoch order indexes them from 0.
            if self._shard_arrays is None:
                lo, hi = data.idxs.start, data.idxs.stop
                self._shard_arrays = pytree.tree_map(lambda a: a[lo:hi],
                                                     data.data.arrays)
            return self._shard_arrays, 0
        return None

    def _device_gather_declined(self, backing: tuple[Any, int] | None) -> str | None:
        """Why this epoch does not gather on the device (policy in the
        class docstring), or None when it does."""
        if self.device_gather is False:
            return "device_gather=False"
        if backing is None:
            return "the dataset is not array-backed"
        if self.transform is not None:
            return "transform= runs on host batches"
        if self.device_gather == "auto":
            # What this worker stages on its card.
            nbytes = sum(np.asarray(leaf).nbytes
                         for leaf in pytree.tree_leaves(backing[0]))
            budget = _device_gather_budget()
            if nbytes > budget:
                return (f"this worker stages {nbytes} bytes, over "
                        f"FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES={budget}")
        return None

    def _use_device_gather(self, backing: tuple[Any, int] | None) -> bool:
        """Whether this epoch gathers on the device (policy in the class
        docstring)."""
        return self._device_gather_declined(backing) is None

    def _staged(self, arrays: Any) -> Any:
        """``arrays`` in device memory, staged once and cached across
        epochs (restaged for another dataset)."""
        cached = self._gather_cache
        if cached is not None and cached[0] is arrays:
            return cached[1]
        staged = pytree.tree_map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device),
            arrays)
        self._gather_cache = (arrays, staged)
        return staged

    def _device_perm(self, order: np.ndarray, offset: int, n: int) -> torch.Tensor:
        """The epoch order's first ``n`` entries as dataset rows (int32),
        on the device in one copy."""
        rows = np.asarray(order[:n], dtype=np.int32) + np.int32(offset)
        return torch.from_numpy(rows).to(self.device)

    def _begin_pass(self) -> tuple[np.ndarray, Any, int | None, int]:
        """Resolve this epoch's order and advance the bookkeeping a pass
        shares with :meth:`device_epoch`; returns ``(order, source,
        offset, start)``."""
        order, source, offset = self._epoch_plan()
        epoch_now = self._epoch
        self._epoch += 1
        start = self._resume_cursor
        self._resume_cursor = 0
        self._iter_epoch = epoch_now
        self._cursor = start
        return order, source, offset, start

    def _transformed(self, batch: Any, epoch: int, b: int) -> Any:
        """``batch`` (batch ``b`` of ``epoch``) through the transform, its
        leaves' leading dimensions checked."""
        if self.transform is None:
            return batch
        before = _lead_dims(batch)
        if self._transform_arity == 2:
            who = self._mesh_view[0] if self._mesh_view is not None else _world()[0]
            rng = np.random.default_rng([self.seed, epoch, b, who])
            out = self.transform(batch, rng)
        else:
            out = self.transform(batch)
        after = _lead_dims(out)
        if before != after:
            raise ValueError(
                "transform must preserve every leaf's leading (batch) "
                f"dimension; got {after} from {before}")
        return out

    def _batches(self) -> Iterator[Any]:
        """This pass's batches: device-gathered (on the device already)
        or host-assembled (numpy, transformed, moved by
        :meth:`_to_device`), tagged by ``on_device``."""
        order, source, offset, start = self._begin_pass()
        epoch = self._iter_epoch
        lbs = self.local_batch_size
        full = self._common_len // lbs
        backing = self._array_backing()
        if backing is not None and self._use_device_gather(backing):
            arrays, staged_offset = backing
            if full > start:
                staged = self._staged(arrays)
                perm = self._device_perm(order, staged_offset, full * lbs)
                for b in range(start, full):
                    at = torch.full((), b * lbs, dtype=torch.int64, device=self.device)
                    yield True, _gather_batch(staged, perm, at, lbs)
            start = max(start, full)
        if offset is not None:
            # Array-backed host path: one C++ prefetcher per leaf serves
            # the whole batches; the ragged tail (drop_last=False) is one
            # direct gather, so the epoch yields len(self) batches.
            arrays = (source.arrays if isinstance(source, ArrayDataset)
                      else source.data.arrays)
            leaves, spec = pytree.tree_flatten(arrays)
            if full > start:
                rows = order[start * lbs:full * lbs] + offset
                prefetchers = [iter(NativePrefetcher(leaf, rows, lbs)) for leaf in leaves]
                for b, parts in enumerate(zip(*prefetchers), start):
                    yield False, self._transformed(
                        pytree.tree_unflatten(list(parts), spec), epoch, b)
            if len(self) > full and start <= full:
                rows = order[full * lbs:self._common_len] + offset
                yield False, self._transformed(
                    pytree.tree_unflatten([gather_rows(leaf, rows) for leaf in leaves],
                                          spec), epoch, full)
            return
        for b in range(start, len(self)):
            idxs = order[b * lbs:min((b + 1) * lbs, self._common_len)]
            yield False, self._transformed(
                _stack_samples([source[int(i)] for i in idxs]), epoch, b)

    # -- fused-window pass (train_loop fuse="window") -------------------
    #
    # The fused-window loop runs a whole flush window (its gathers and
    # its updates) as one program, so instead of iterating it asks the
    # loader for the epoch's device-resident pieces and reports what it
    # consumed. Same epoch order, same staged arrays, same
    # state_dict/resume contract as iterating.

    def fusible(self) -> bool:
        """Can the fused-window loop run over this loader? The device-gather
        path must be active (array-backed, without ``transform=``, what
        this worker stages within the staging budget) and the epoch must be
        whole full batches (a ragged tail would need the host path
        mid-window)."""
        return self.fusible_declined() is None

    def fusible_declined(self) -> str | None:
        """Why :meth:`fusible` is False (the first failing condition), or
        None when it is True."""
        why = self._device_gather_declined(self._array_backing())
        if why is not None:
            return f"the loader's device-gather path is not active: {why}"
        if len(self) * self.local_batch_size > self._common_len:
            return "the epoch ends in a ragged batch (drop_last=False)"
        return None

    def device_epoch(self) -> tuple[Any, torch.Tensor, int]:
        """Begin one fused-window pass: resolve this epoch's order (the
        permutation iterating would use), stage the dataset (cached across
        epochs) and copy the permutation to the device once. Returns
        ``(staged, perm, start)``: the staged tree, the int32 permutation
        of dataset rows, and the batch to start from (a pending mid-epoch
        resume cursor, else 0). Advances the same epoch/cursor bookkeeping
        as ``iter()``; the caller reports consumption with
        :meth:`note_consumed`. In a world of several workers ``perm`` lists
        this worker's rows of every batch (its shard's, or its slice of the
        global batch in the mesh view), so batch ``b`` is
        ``perm[b * local_batch_size:]`` on every view."""
        why = self.fusible_declined()
        if why is not None:
            raise ValueError(
                f"device_epoch() needs the device-gather path: an "
                f"array-backed dataset without transform=, staged within "
                f"FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES, and a whole number "
                f"of full batches per epoch ({why})")
        order, _, _, start = self._begin_pass()
        arrays, offset = self._array_backing()
        staged = self._staged(arrays)
        perm = self._device_perm(order, offset, len(self) * self.local_batch_size)
        return staged, perm, start

    def note_consumed(self, n: int) -> None:
        """Advance the consumption cursor by ``n`` batches: the fused
        loop's counterpart of the per-yield increment of ``iter()``, so a
        :meth:`state_dict` taken at a window boundary names exactly the
        batches dispatched."""
        self._cursor += int(n)

    def _to_device(self, batch: Any) -> Any:
        cuda = self.device.type == "cuda"

        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
            if cuda:
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

        return pytree.tree_map(move, batch)

    @property
    def resume_cursor(self) -> int:
        """The batch the next pass starts at (set by
        :meth:`load_state_dict`; 0 once a pass has begun)."""
        return self._resume_cursor

    def __iter__(self) -> Iterator[Any]:
        # Telemetry, resolved once per pass: each batch's fetch (assembly,
        # the fault site and the copy's launch) is timed into
        # data.batch_fetch_seconds and a data.fetch trace event, keyed by
        # its position in the epoch; the queue depth behind each yield
        # lands in data.prefetch_depth. With the registry and the tracer
        # off, no clock is read. Every batch is a watchdog tick either way.
        reg = _telemetry_registry()
        timed = reg.enabled or _tracing.get_tracer().enabled
        hist = reg.histogram("data.batch_fetch_seconds") if reg.enabled else None
        depth = reg.gauge("data.prefetch_depth") if reg.enabled else None
        b = self._resume_cursor  # read before the pass consumes it
        source = self._batches()
        queue: deque = deque()
        while True:
            t0 = time.perf_counter() if timed else 0.0
            try:
                on_device, batch = next(source)
            except StopIteration:
                break
            if faults.ARMED:
                # After the fetch, so hit N is batch N of the pass.
                faults.check("data.fetch")
            queue.append(batch if on_device else self._to_device(batch))
            if timed:
                t1 = time.perf_counter()
                if hist is not None:
                    hist.observe(t1 - t0)
                _tracing.add_complete_event("data.fetch", t0, t1, batch=b)
            notify_progress()
            b += 1
            if len(queue) > self.prefetch:
                if depth is not None:
                    depth.set(len(queue) - 1)
                self._cursor += 1
                yield queue.popleft()
        while queue:
            if depth is not None:
                depth.set(len(queue) - 1)
            self._cursor += 1
            yield queue.popleft()


def scan_batches(loader: DistributedDataLoader, k: int) -> Iterator[Any]:
    """Group consecutive loader batches into ``[k]``-stacked super-batches
    for ``make_train_step(scan_steps=k)``; a ragged trailing group is
    dropped."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    group: list[Any] = []
    for batch in loader:
        group.append(batch)
        if len(group) == k:
            leaves = [pytree.tree_flatten(b)[0] for b in group]
            spec = pytree.tree_flatten(group[0])[1]
            yield pytree.tree_unflatten(
                [torch.stack([lv[j] for lv in leaves]) for j in range(len(leaves[0]))],
                spec)
            group = []
