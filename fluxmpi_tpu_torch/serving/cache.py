"""Block (paged) KV cache: sequences of different lengths share one pool.

Counterpart of :mod:`fluxmpi_tpu.serving.cache`. The pools are
``[layers, blocks, block_size, heads, head_dim]`` tensors for K and for V
on the engine's device; a LIFO free list hands blocks to sequences at
admission and takes them back at eviction; each sequence carries a block
table row: logical position ``p`` lives at
``(table[p // block_size], p % block_size)``.

Block 0 is the trash block: it is never allocated, unused table entries
point at it, and padded prefill positions and idle decode slots write
into it. Attention masks everything read from it.

:meth:`BlockKVCache.fits_device` checks the pools' bytes against the
memory plane's ``bytes_limit`` (what is in use plus the pools must fit)
before any device allocation, so an engine that would exhaust the card
refuses at construction, not at its first admission.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import resolve_device

__all__ = ["BlockKVCache", "TRASH_BLOCK", "blocks_for_tokens"]

TRASH_BLOCK = 0


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` cache positions."""
    return -(-int(tokens) // int(block_size))


class BlockKVCache:
    """Paged K/V pools + free-list allocator + block-table rows.

    ``num_blocks`` includes the trash block (capacity =
    ``(num_blocks - 1) * block_size`` tokens). The pools live on
    ``device`` (default CUDA; ``"cpu"`` only when asked) and are created on
    first access of :attr:`k_pool` / :attr:`v_pool`, so the allocator is
    usable without touching a device.
    """

    def __init__(self, *, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: int, max_blocks_per_seq: int,
                 dtype: torch.dtype | None = None, device=None):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_blocks_per_seq < 1:
            raise ValueError(
                f"max_blocks_per_seq must be >= 1, got {max_blocks_per_seq}"
            )
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.dtype = torch.float32 if dtype is None else dtype
        self.device = resolve_device(device)
        # LIFO: the most recently freed block is handed out next.
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._high_watermark = 0
        self._k_pool: torch.Tensor | None = None
        self._v_pool: torch.Tensor | None = None

    # -- allocator -----------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def capacity_tokens(self) -> int:
        return (self.num_blocks - 1) * self.block_size

    @property
    def free_tokens(self) -> int:
        return len(self._free) * self.block_size

    @property
    def high_watermark_blocks(self) -> int:
        """Pool-lifetime peak of :attr:`used_blocks` (updated at every
        allocation)."""
        return self._high_watermark

    @property
    def fragmentation(self) -> float:
        """Free-list scatter in [0, 1]: ``1 - (longest contiguous free run
        / free blocks)``; 0.0 when the free space is one run (or empty).
        Allocation ignores block ids, so this never blocks an admission;
        it measures how shuffled churn has left the pool."""
        if not self._free:
            return 0.0
        ids = sorted(self._free)
        longest = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(ids)

    def blocks_for(self, tokens: int) -> int:
        return blocks_for_tokens(tokens, self.block_size)

    def can_alloc(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= len(self._free)

    def alloc(self, tokens: int) -> list[int]:
        """Reserve the blocks for ``tokens`` positions; ``RuntimeError``
        when the pool cannot cover them (admission gates on
        :meth:`can_alloc`)."""
        need = self.blocks_for(tokens)
        if need > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {need} blocks for {tokens} "
                f"tokens, {len(self._free)} free"
            )
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"{tokens} tokens need {need} blocks but block tables are "
                f"{self.max_blocks_per_seq} wide"
            )
        blocks = [self._free.pop() for _ in range(need)]
        self._high_watermark = max(self._high_watermark, self.used_blocks)
        return blocks

    def free(self, blocks: list[int]) -> None:
        """Return a sequence's blocks to the pool (eviction)."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block id {b} outside the pool")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(blocks)

    def table_row(self, blocks: list[int]) -> np.ndarray:
        """``[max_blocks_per_seq]`` int32 row; unused entries point at the
        trash block."""
        row = np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)
        row[: len(blocks)] = blocks
        return row

    # -- device pools --------------------------------------------------

    @property
    def pool_shape(self) -> tuple[int, ...]:
        return (self.num_layers, self.num_blocks, self.block_size,
                self.num_heads, self.head_dim)

    @property
    def pool_bytes(self) -> int:
        """Bytes of BOTH pools."""
        n = 1
        for d in self.pool_shape:
            n *= d
        return 2 * n * torch.empty((), dtype=self.dtype).element_size()

    def _ensure_pools(self) -> None:
        if self._k_pool is None:
            self._k_pool = torch.zeros(self.pool_shape, dtype=self.dtype,
                                       device=self.device)
            self._v_pool = torch.zeros(self.pool_shape, dtype=self.dtype,
                                       device=self.device)

    @property
    def k_pool(self) -> torch.Tensor:
        self._ensure_pools()
        return self._k_pool

    @property
    def v_pool(self) -> torch.Tensor:
        self._ensure_pools()
        return self._v_pool

    def drop_pools(self) -> None:
        self._k_pool = None
        self._v_pool = None

    def fits_device(self, device=None) -> tuple[bool, str]:
        """Would both pools fit beside what the device already holds?
        ``in_use + pool_bytes <= bytes_limit`` from the memory plane's
        :func:`~fluxmpi_tpu_torch.telemetry.memory.device_memory_stats`
        (default device: the pools'). Returns ``(fits, detail)``; a device
        without memory stats (the CPU) reports ``(True, "no device memory
        stats")``."""
        from ..telemetry import memory

        stats = memory.device_memory_stats(self.device if device is None else device)
        limit = stats.get("bytes_limit")
        if not limit:
            return True, "no device memory stats"
        in_use = stats.get("bytes_in_use", 0.0)
        need = float(self.pool_bytes)
        return in_use + need <= limit, (
            f"pool {need / 2**20:.1f} MiB + in-use {in_use / 2**20:.1f} "
            f"MiB vs limit {limit / 2**20:.1f} MiB"
        )
