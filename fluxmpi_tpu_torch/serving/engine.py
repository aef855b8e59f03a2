"""Continuous-batching inference engine over a paged KV cache.

Counterpart of :mod:`fluxmpi_tpu.serving.engine`. Each iteration:

- **admission**: queued requests take free batch slots (continuous mode:
  between any two iterations; static mode: only once every slot has
  drained). Each admission reserves its worst-case blocks and runs ONE
  causal forward over its prompt padded to a block multiple (the prefill
  bucket); the K/V land in its pool blocks (padding in the trash block)
  and the first token comes from the last real position's logits.
- **decode tick**: one batched forward advances every slot a token at
  its own position. Each slot's blocks are gathered into a
  ``[slots, max_len]`` cache, the model writes the new K/V at ``pos`` and
  attends with ``q_seg = 1`` and ``kv_seg = (arange(max_len) <= pos)`` (the
  flash kernel skips the dead tail's key tiles), and the new position is
  scattered back into the pool. Idle slots carry all-trash tables, so
  their writes land in block 0. Shapes depend only on the engine's
  geometry, never on which requests are active.
- **eviction**: finished requests (``max_new_tokens`` or ``eos``) return
  their blocks to the free list.

Greedy streams equal :func:`~fluxmpi_tpu_torch.models.generate` on the
same prompt token for token.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..errors import RequestRejectedError, refuse_unported
from .cache import TRASH_BLOCK, BlockKVCache, blocks_for_tokens

__all__ = ["InferenceEngine", "ServingRequest"]

QUEUED = "queued"
ACTIVE = "active"
FINISHED = "finished"
REJECTED = "rejected"

_request_ids = itertools.count(1)


class ServingRequest:
    """One submitted generation request: prompt in, tokens out.

    Tokens arrive through the ``on_token`` callback, the :meth:`stream`
    iterator and the :attr:`tokens` list; :attr:`ttft_s` is the time from
    submit to the first token.
    """

    def __init__(self, prompt, max_new_tokens: int, *,
                 eos_token: int | None = None,
                 on_token: Callable[[int], None] | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        refuse_unported("ServingRequest", {"clock": clock is not time.perf_counter})
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.id = next(_request_ids)
        self.eos_token = eos_token
        self.on_token = on_token
        self.tokens: list[int] = []
        self.status = QUEUED
        self.reject_reason: str | None = None
        self.submitted_t = time.perf_counter()
        self.admitted_t: float | None = None
        self.first_token_t: float | None = None
        self.finished_t: float | None = None
        self._done = threading.Event()
        self._stream: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Prompt + generated tokens once finished; raises
        :class:`~fluxmpi_tpu_torch.errors.RequestRejectedError` for a
        rejected request."""
        if not self.wait(timeout):
            raise TimeoutError("request still in flight")
        if self.status == REJECTED:
            raise RequestRejectedError(self.reject_reason)
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])

    def stream(self, timeout: float | None = None):
        """Yield tokens as they are produced (interleave with
        :meth:`InferenceEngine.step` calls)."""
        while True:
            try:
                tok = self._stream.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(f"no token within {timeout} seconds") from None
            if tok is None:
                if self.status == REJECTED:
                    raise RequestRejectedError(self.reject_reason)
                return
            yield tok

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t

    def _deliver(self, token: int) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        self.tokens.append(int(token))
        self._stream.put(int(token))
        if self.on_token is not None:
            try:
                self.on_token(int(token))
            except Exception as exc:
                warnings.warn(f"serving on_token callback raised {exc!r}; "
                              f"token delivery continues", stacklevel=2)

    def _finish(self, status: str, reason: str | None = None) -> None:
        self.status = status
        self.reject_reason = reason
        self.finished_t = time.perf_counter()
        self._stream.put(None)
        self._done.set()


class _Slot:
    __slots__ = ("req", "blocks", "table", "position", "last_token",
                 "generated")

    def __init__(self, req: ServingRequest, blocks: list[int],
                 table: np.ndarray):
        self.req = req
        self.blocks = blocks
        self.table = table
        self.position = 0  # the position the next fed token occupies
        self.last_token = 0
        self.generated = 0


class InferenceEngine:
    """Continuous-batching engine with a paged KV cache.

    Args:
      model: a :class:`~fluxmpi_tpu_torch.models.TransformerLM`; the engine
        runs on the model's device.
      slots: decode batch width (default 8).
      block_size: cache positions per pool block (default 16).
      num_blocks: pool blocks including the trash block (default
        ``1 + slots * max_len / block_size``: no oversubscription).
      max_queue: queued requests past which :meth:`submit` rejects with
        reason ``"queue_full"`` (default 64).
      continuous: True = join between any two iterations; False = static
        batching (a new group only once every slot has drained).

    Sequences are capped at the model's ``max_len`` rounded down to a
    block multiple. Construction refuses pools that cannot fit the
    device's free memory. Not ported yet (``NotImplementedError`` when
    set): ``max_len``, the SLO arguments, ``registry``, ``clock``,
    ``flush_every``, ``check_memory`` and ``attention``. (The JAX engine
    also takes the flax ``params``; a torch model holds its own.) The
    summary keeps the JAX engine's keys;
    ``preempted`` and ``slo_violations`` stay ``False`` and 0 until the
    port has preemption and SLO accounting.
    """

    def __init__(self, model, *, slots: int | None = None,
                 block_size: int | None = None, num_blocks: int | None = None,
                 max_queue: int | None = None, max_len: int | None = None,
                 continuous: bool = True, slo_ttft_s: float | None = None,
                 slo_token_s: float | None = None, registry: Any = None,
                 clock: Callable[[], float] = time.perf_counter,
                 flush_every: int = 16, check_memory: bool = True,
                 attention: str | None = None):
        refuse_unported("InferenceEngine", {
            "max_len": max_len is not None,
            "slo_ttft_s": slo_ttft_s is not None,
            "slo_token_s": slo_token_s is not None,
            "registry": registry is not None,
            "clock": clock is not time.perf_counter,
            "flush_every": flush_every != 16, "check_memory": check_memory is not True,
            "attention": attention is not None})
        self.model = model
        self.device = model.device
        self.slots = 8 if slots is None else int(slots)
        self.block_size = 16 if block_size is None else int(block_size)
        self.max_queue = 64 if max_queue is None else int(max_queue)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        self.max_len = (int(model.max_len) // self.block_size) * self.block_size
        if self.max_len < self.block_size:
            raise ValueError(f"max_len {model.max_len} is below one block "
                             f"({self.block_size})")
        self.max_blocks_per_seq = self.max_len // self.block_size
        nb = (1 + self.slots * self.max_blocks_per_seq if num_blocks is None
              else int(num_blocks))
        self.continuous = bool(continuous)
        self.cache = BlockKVCache(
            num_layers=model.num_layers, num_heads=model.num_heads,
            head_dim=model.head_dim, num_blocks=nb,
            block_size=self.block_size,
            max_blocks_per_seq=self.max_blocks_per_seq, dtype=model.dtype,
            device=self.device,
        )
        fits, detail = self.cache.fits_device()
        if not fits:
            raise RuntimeError(
                f"KV pool would exhaust device memory ({detail}); "
                f"shrink num_blocks/slots or block_size"
            )
        self._queue: deque[ServingRequest] = deque()
        self._lock = threading.Lock()
        self._slots: list[_Slot | None] = [None] * self.slots
        self._draining = False
        self._closed = False
        self._completed = 0
        self._rejected = 0
        self._drained = 0
        self._decode_steps = 0
        self._prefills = 0
        self._tokens = 0

    def _bucket(self, plen: int) -> int:
        """Prompt lengths round up to a block multiple."""
        return blocks_for_tokens(plen, self.block_size) * self.block_size

    # -- device steps --------------------------------------------------

    @torch.no_grad()
    def _prefill_step(self, tokens: np.ndarray, length: int,
                      table: np.ndarray) -> int:
        """One causal forward over the padded prompt; K/V scattered into
        the table's blocks (positions past ``length`` into the trash
        block); returns the first generated token."""
        dev = self.device
        bs = self.block_size
        toks = torch.from_numpy(tokens).to(dev).long()[None]
        logits, k, v = self.model(toks, return_kv=True)
        pos = torch.arange(tokens.shape[0], device=dev)
        tab = torch.from_numpy(table).to(dev).long()
        blk = torch.where(pos < length, tab[pos // bs],
                          torch.full_like(pos, TRASH_BLOCK))
        off = pos % bs
        pool_k, pool_v = self.cache.k_pool, self.cache.v_pool
        pool_k[:, blk, off] = k[:, 0].to(pool_k.dtype)
        pool_v[:, blk, off] = v[:, 0].to(pool_v.dtype)
        self._prefills += 1
        return int(logits[0, length - 1].argmax())

    @torch.no_grad()
    def _decode_step(self, tables: np.ndarray, positions: np.ndarray,
                     tokens: np.ndarray) -> np.ndarray:
        """Advance every slot one token: gather, one batched forward at
        per-slot positions, scatter the new K/V back, argmax."""
        dev = self.device
        bs = self.block_size
        tab = torch.from_numpy(tables).to(dev).long()        # [slots, MB]
        pos = torch.from_numpy(positions).to(dev).long()     # [slots]
        tok = torch.from_numpy(tokens).to(dev).long()[:, None]
        pool_k, pool_v = self.cache.k_pool, self.cache.v_pool
        n_l, _, _, h, hd = pool_k.shape
        shape = (n_l, self.slots, self.max_len, h, hd)
        k_g = pool_k[:, tab].reshape(shape)
        v_g = pool_v[:, tab].reshape(shape)
        logits = self.model(tok, pos_offset=pos, kv_cache=(k_g, v_g))
        rows = torch.arange(self.slots, device=dev)
        blk = tab[rows, pos // bs]
        off = pos % bs
        pool_k[:, blk, off] = k_g[:, rows, pos]
        pool_v[:, blk, off] = v_g[:, rows, pos]
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def warmup(self, prompt_lengths: tuple[int, ...] = ()) -> None:
        """Run the prefill buckets covering ``prompt_lengths`` and one
        decode step before traffic arrives (kernel builds, library
        handles). Every write lands in the trash block."""
        buckets = {self._bucket(max(1, int(p))) for p in prompt_lengths}
        buckets.add(self.block_size)
        trash = np.zeros((self.max_blocks_per_seq,), np.int32)
        for bucket in sorted(buckets):
            self._prefill_step(np.zeros((bucket,), np.int32), 1, trash)
        self._decode_step(
            np.zeros((self.slots, self.max_blocks_per_seq), np.int32),
            np.zeros((self.slots,), np.int32), np.zeros((self.slots,), np.int32),
        )
        self._prefills = 0

    # -- admission -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_token: int | None = None,
               on_token: Callable[[int], None] | None = None) -> ServingRequest:
        """Queue a request; returns its handle at once. A request that can
        never fit raises ``ValueError``; a full queue, a drain or a closed
        engine rejects (the handle is finished with ``status ==
        "rejected"``)."""
        req = ServingRequest(prompt, max_new_tokens, eos_token=eos_token,
                             on_token=on_token)
        plen = int(req.prompt.shape[0])
        if plen < 1:
            raise ValueError("prompt must hold at least one token")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        total = plen + req.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the engine's "
                f"max_len {self.max_len}")
        if req.eos_token is not None and not (
                0 <= int(req.eos_token) < int(self.model.vocab_size)):
            raise ValueError(
                f"eos_token {req.eos_token} outside the vocabulary "
                f"[0, {self.model.vocab_size})")
        if self.cache.blocks_for(total) > self.cache.num_blocks - 1:
            raise ValueError(
                f"request needs {self.cache.blocks_for(total)} blocks but "
                f"the pool only holds {self.cache.num_blocks - 1}")
        with self._lock:
            if self._draining or self._closed:
                self._reject(req, "draining" if self._draining else "shutdown")
                return req
            if len(self._queue) >= self.max_queue:
                self._reject(req, "queue_full")
                return req
            self._queue.append(req)
        return req

    def _reject(self, req: ServingRequest, reason: str) -> None:
        self._rejected += 1
        req._finish(REJECTED, reason)

    def _admit_phase(self) -> int:
        if not self.continuous and any(s is not None for s in self._slots):
            return 0
        admitted = 0
        while True:
            free_ix = next(
                (i for i, s in enumerate(self._slots) if s is None), None)
            if free_ix is None:
                break
            with self._lock:
                if not self._queue:
                    break
                head = self._queue[0]
                total = int(head.prompt.shape[0]) + head.max_new_tokens
                if not self.cache.can_alloc(total):
                    break  # FIFO: the head waits for blocks
                self._queue.popleft()
            self._admit(head, free_ix, total)
            admitted += 1
        return admitted

    def _admit(self, req: ServingRequest, slot_ix: int, total: int) -> None:
        req.admitted_t = time.perf_counter()
        req.status = ACTIVE
        blocks = self.cache.alloc(total)
        slot = _Slot(req, blocks, self.cache.table_row(blocks))
        plen = int(req.prompt.shape[0])
        padded = np.zeros((self._bucket(plen),), np.int32)
        padded[:plen] = req.prompt
        slot.last_token = self._prefill_step(padded, plen, slot.table)
        slot.position = plen
        slot.generated = 1
        self._slots[slot_ix] = slot
        req._deliver(slot.last_token)
        self._tokens += 1
        if self._finished(slot):
            self._evict(slot_ix)

    @staticmethod
    def _finished(slot: _Slot) -> bool:
        eos = slot.req.eos_token
        return slot.generated >= slot.req.max_new_tokens or (
            eos is not None and slot.last_token == int(eos))

    # -- decode --------------------------------------------------------

    def _decode_tick(self) -> None:
        mb = self.max_blocks_per_seq
        tables = np.zeros((self.slots, mb), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        tokens = np.zeros((self.slots,), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                tables[i] = slot.table
                positions[i] = slot.position
                tokens[i] = slot.last_token
        nxt = self._decode_step(tables, positions, tokens)
        self._decode_steps += 1
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.position += 1
            slot.generated += 1
            slot.last_token = int(nxt[i])
            slot.req._deliver(slot.last_token)
            self._tokens += 1
            if self._finished(slot):
                self._evict(i)

    def _evict(self, slot_ix: int) -> None:
        slot = self._slots[slot_ix]
        self._slots[slot_ix] = None
        self.cache.free(slot.blocks)
        slot.req._finish(FINISHED)
        self._completed += 1

    # -- the loop ------------------------------------------------------

    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def prefills(self) -> int:
        """Prefill forwards run for admitted requests."""
        return self._prefills

    def drain(self) -> None:
        """Stop admitting: queued requests are rejected (``"draining"``),
        active slots decode to completion on the next iterations."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            dropped = list(self._queue)
            self._queue.clear()
        self._drained += self.active_count
        for req in dropped:
            self._reject(req, "draining")

    def step(self) -> bool:
        """One scheduler iteration (admissions, then a decode tick);
        returns whether any work happened."""
        admitted = self._admit_phase()
        ticked = False
        if any(s is not None for s in self._slots):
            self._decode_tick()
            ticked = True
        return bool(admitted) or ticked

    def run(self) -> dict[str, Any]:
        """Drive the engine until queue and slots are empty; returns the
        run summary."""
        t0 = time.perf_counter()
        tokens0 = self._tokens
        while True:
            worked = self.step()
            if not worked and self.active_count == 0 and (
                    self.queue_depth == 0 or self._draining):
                break
        wall = time.perf_counter() - t0
        return {
            "completed": self._completed,
            "rejected": self._rejected,
            "drained": self._drained,
            "preempted": False,
            "decode_steps": self._decode_steps,
            "tokens": self._tokens,
            "slo_violations": 0,
            "wall_seconds": wall,
            "tokens_per_sec": (self._tokens - tokens0) / wall if wall > 0 else 0.0,
        }

    def close(self) -> None:
        """Teardown: reject everything pending (``"shutdown"``), release
        every block and drop the pools."""
        self._closed = True
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            self._reject(req, "shutdown")
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                self.cache.free(slot.blocks)
                self._reject(slot.req, "shutdown")
        self.cache.drop_pools()
