"""Sharded datasets and the distributed batch loader.

Counterpart of :mod:`fluxmpi_tpu.data` (the reference's
``DistributedDataContainer`` inside a data loader): each worker draws its
contiguous ceil-partition shard (the remainder on the last rank), and the
loader hands out per-worker batches of ``global_batch_size / world`` in
the same order the JAX package's loader does, sample for sample: the same
``np.random.default_rng(seed + epoch)`` shuffles and the same
full-dataset permutation slice under ``global_shuffle``. Batches are
assembled on the host with numpy, staged in pinned memory and copied to
the device with ``non_blocking`` copies, ``prefetch`` batches ahead.

Each batch crosses the fault site ``data.fetch`` once the host has
assembled it (:mod:`fluxmpi_tpu_torch.faults`).

Not ported yet (each raises ``NotImplementedError`` when asked for): the
device-gather path, ``elastic_order``, ``transform=``, the elastic cursor
remap on a changed world, and the C++ prefetcher.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Iterator, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import faults, runtime

__all__ = [
    "ArrayDataset",
    "DistributedDataContainer",
    "DistributedDataLoader",
    "scan_batches",
]


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
    """

    def __init__(self, data: Any, global_batch_size: int, *,
                 shuffle: bool = False, global_shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device=None, device_gather: bool | str = "auto",
                 elastic_order: bool = False, transform: Any = None,
                 mesh: Any = None, axis_name: Any = None):
        if device_gather is True:
            raise NotImplementedError(
                "device_gather=True is not ported yet: batches are assembled "
                "on the host and copied through pinned memory")
        if device_gather not in (False, "auto"):
            raise ValueError(f"device_gather must be True, False, or 'auto', "
                             f"got {device_gather!r}")
        for name, val in (("elastic_order", elastic_order),
                          ("transform", transform), ("mesh", mesh),
                          ("axis_name", axis_name)):
            if val:
                raise NotImplementedError(f"{name}= is not ported yet")
        if global_shuffle and not isinstance(data, DistributedDataContainer):
            raise ValueError(
                "global_shuffle reshuffles the sample→worker assignment, "
                "which needs the full-dataset view of a "
                "DistributedDataContainer; wrap the dataset in one"
            )
        _, world = _world()
        if global_batch_size % world != 0:
            raise ValueError(
                f"global_batch_size {global_batch_size} must divide evenly "
                f"across {world} workers"
            )
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.data = data
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // world
        self.world = world
        self.shuffle = shuffle or global_shuffle
        self.global_shuffle = global_shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
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
        if isinstance(data, DistributedDataContainer):
            self._common_len = data.min_shard_size()
        elif world > 1:
            from .comm import allreduce

            self._common_len = int(allreduce(torch.tensor(len(data)), op="min"))
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
                "num_batches": len(self), "elastic_order": 0}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore a :meth:`state_dict`: the next ``iter()`` replays
        ``epoch``'s order from batch ``cursor`` (a cursor at the end of the
        epoch resumes at the next one). A state saved under another batch
        geometry needs the elastic cursor remap, which is not ported yet."""
        seed = int(state.get("seed", self.seed))
        if seed != self.seed:
            raise ValueError(
                f"loader state was captured with seed {seed} but this "
                f"loader uses seed {self.seed}: the resumed sample order "
                f"would silently diverge from the interrupted run"
            )
        geom = self.geometry()
        changed = [k for k in geom if k in state and int(state[k]) != geom[k]]
        if changed:
            raise NotImplementedError(
                f"the loader state was saved under another batch geometry "
                f"({', '.join(changed)}); the elastic cursor remap is not "
                f"ported yet")
        epoch, cursor = int(state["epoch"]), int(state["cursor"])
        if cursor < 0 or cursor > len(self):
            raise ValueError(f"cursor {cursor} out of range for a "
                             f"{len(self)}-batch epoch")
        if cursor >= len(self):
            epoch, cursor = epoch + 1, 0
        self._epoch = epoch
        self._iter_epoch = epoch
        self._cursor = cursor
        self._resume_cursor = cursor

    def _epoch_plan(self) -> tuple[np.ndarray, Any, int | None]:
        """This epoch's order: ``(order, source, offset)`` where ``order``
        indexes ``source``; ``offset`` is the index shift into an
        array-backed dataset's arrays (None when the source is not
        array-backed)."""
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

    def _host_batches(self) -> Iterator[Any]:
        order, source, offset = self._epoch_plan()
        epoch_now = self._epoch
        self._epoch += 1
        start = self._resume_cursor
        self._resume_cursor = 0
        self._iter_epoch = epoch_now
        self._cursor = start
        lbs = self.local_batch_size
        arrays = None
        if offset is not None:
            arrays = (source.arrays if isinstance(source, ArrayDataset)
                      else source.data.arrays)
        for b in range(start, len(self)):
            idxs = order[b * lbs:min((b + 1) * lbs, self._common_len)]
            if arrays is not None:
                rows = idxs + offset
                yield pytree.tree_map(lambda a: a[rows], arrays)
            else:
                yield _stack_samples([source[int(i)] for i in idxs])

    def _to_device(self, batch: Any) -> Any:
        cuda = self.device.type == "cuda"

        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
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
        queue: deque = deque()
        for batch in self._host_batches():
            if faults.ARMED:
                # After the fetch, so hit N is batch N of the pass.
                faults.check("data.fetch")
            queue.append(self._to_device(batch))
            if len(queue) > self.prefetch:
                self._cursor += 1
                yield queue.popleft()
        while queue:
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
