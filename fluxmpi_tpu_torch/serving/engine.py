"""Continuous-batching inference engine over a paged KV cache.

Counterpart of :mod:`fluxmpi_tpu.serving.engine`. Each iteration:

- **preemption poll**: once ``runtime.request_preemption()`` (or the
  SIGTERM handler) set the flag, the engine drains: queued requests are
  rejected (``"preempted"``), active ones decode to completion.
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
  geometry, never on which requests are active, so a row's arithmetic
  does not depend on its slot or its neighbours.
- **eviction**: finished requests (``max_new_tokens`` or ``eos``) return
  their blocks to the free list; their SLO verdicts, the ``serving.*``
  histograms and counters and the request observer's terminal record are
  booked here.

The loop is host-driven: one forward and one small device-to-host token
copy per iteration, with admission, delivery, eviction and the
preemption poll between iterations. :meth:`InferenceEngine.run` drives it
inline; :meth:`InferenceEngine.start` on a background thread. The
registry, the request observer and the live exporter are resolved once per
run: with all off, an iteration reads a few booleans. At each flush the
engine posts its board to the exporter's ``/status`` ``serving`` section
and feeds the request observer's multi-window SLO burn rate to the anomaly
detector's ``slo_burn`` rule. The decode step and each prefill bucket are
tracked by the compile monitor (eager callables: untracked, so only the
kernel builds they set off count). The ``serving.admit`` and
``serving.decode`` fault sites sit in :meth:`InferenceEngine.submit` and
the decode tick.

Wiring follows the package convention: ``init(serving=...)`` /
``FLUXMPI_TPU_SERVING`` (+ ``_SLOTS`` / ``_BLOCK_SIZE`` / ``_BLOCKS`` /
``_QUEUE`` / ``_ATTENTION``) set fleet defaults through :func:`configure`;
``telemetry.shutdown()`` resets the plane (engine stopped, pools
dropped).

Greedy streams equal :func:`~fluxmpi_tpu_torch.models.generate` on the
same prompt token for token.
"""

from __future__ import annotations

import inspect
import os
import queue as queue_mod
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..config import env_int
from ..errors import RequestRejectedError
from ..telemetry.registry import MetricsRegistry, get_registry
from . import observe as _observe_mod
from .cache import TRASH_BLOCK, BlockKVCache, blocks_for_tokens

__all__ = [
    "InferenceEngine",
    "ServingRequest",
    "ServingConfig",
    "get_engine",
    "set_engine",
    "configure",
    "shutdown",
    "enabled",
]

_ENV_ON = "FLUXMPI_TPU_SERVING"
_ENV_SLOTS = "FLUXMPI_TPU_SERVING_SLOTS"
_ENV_BLOCK_SIZE = "FLUXMPI_TPU_SERVING_BLOCK_SIZE"
_ENV_BLOCKS = "FLUXMPI_TPU_SERVING_BLOCKS"
_ENV_QUEUE = "FLUXMPI_TPU_SERVING_QUEUE"
_ENV_ATTENTION = "FLUXMPI_TPU_SERVING_ATTENTION"

_DEFAULT_SLOTS = 8
_DEFAULT_BLOCK_SIZE = 16
_DEFAULT_MAX_QUEUE = 64


class ServingConfig:
    """Fleet defaults for engine geometry (``init(serving=...)`` /
    ``FLUXMPI_TPU_SERVING_*``). ``None`` fields defer to the environment
    variable, then the built-in default, at engine construction."""

    def __init__(self, *, slots: int | None = None,
                 block_size: int | None = None,
                 num_blocks: int | None = None,
                 max_queue: int | None = None,
                 attention: str | None = None):
        self.slots = slots
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_queue = max_queue
        self.attention = attention


_config: ServingConfig | None = None
_active_engine: "InferenceEngine | None" = None
_active_lock = threading.Lock()


def get_engine() -> "InferenceEngine | None":
    """The registered engine, if any (the last one constructed)."""
    return _active_engine


def set_engine(engine: "InferenceEngine | None") -> "InferenceEngine | None":
    """Register (or, with None, remove) the process engine; returns the
    previous one."""
    global _active_engine
    with _active_lock:
        prev, _active_engine = _active_engine, engine
    return prev


def enabled() -> bool:
    """Whether ``init(serving=...)`` / ``FLUXMPI_TPU_SERVING`` set fleet
    defaults (engine construction never requires it)."""
    return _config is not None


def configure(spec: Any = None) -> ServingConfig | None:
    """Wire serving fleet defaults from a one-value spec:

    - ``None`` — read ``FLUXMPI_TPU_SERVING`` (no-op when unset/empty);
    - ``False`` / ``"0"`` — reset the plane (stop and deregister any
      engine, drop the defaults);
    - ``True`` / ``"1"`` — enable with geometry from the environment
      (``FLUXMPI_TPU_SERVING_SLOTS`` / ``_BLOCK_SIZE`` / ``_BLOCKS`` /
      ``_QUEUE`` / ``_ATTENTION``);
    - a dict — enable with those overrides (the keys of
      :class:`ServingConfig`);
    - a :class:`ServingConfig` — install it.

    Called by ``fluxmpi_tpu_torch.init(serving=...)``, repeated calls
    included. A malformed environment value warns and leaves the defaults
    unset; the same mistake made in code raises.
    """
    global _config
    from_env = spec is None
    if spec is None:
        spec = os.environ.get(_ENV_ON)
        if spec is None or spec == "":
            return _config
    if spec is False or spec == "0":
        shutdown()
        return None
    if isinstance(spec, ServingConfig):
        _config = spec
        return _config
    if spec is True or spec == "1":
        _config = ServingConfig()
        return _config
    if isinstance(spec, dict):
        unknown = set(spec) - {"slots", "block_size", "num_blocks", "max_queue",
                               "attention"}
        if unknown:
            raise ValueError(
                f"unknown serving config keys {sorted(unknown)}; expected "
                f"slots/block_size/num_blocks/max_queue/attention"
            )
        _config = ServingConfig(**spec)
        return _config
    message = (f"serving spec must be a bool, '0'/'1', a dict, or a "
               f"ServingConfig; got {spec!r}")
    if from_env:
        warnings.warn(f"ignoring {_ENV_ON}={spec!r}: {message} — the serving "
                      f"plane defaults stay unset", stacklevel=2)
        return _config
    raise ValueError(message)


def shutdown() -> None:
    """Reset the serving plane: stop and deregister the engine (serve
    thread joined, pending requests rejected, KV pools dropped) and clear
    the configured defaults. ``telemetry.shutdown()`` calls this before it
    tears down the planes the engine posts into."""
    global _config
    engine = set_engine(None)
    if engine is not None:
        try:
            engine.close()
        except Exception:
            pass
    _config = None


def _resolve(explicit: int | None, configured: int | None, env_name: str,
             default: int) -> int:
    """Explicit argument, then the configured default, then the
    environment (a malformed value warns), then the built-in default."""
    if explicit is not None:
        return int(explicit)
    if configured is not None:
        return int(configured)
    env = env_int(env_name)
    return default if env is None else env


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

QUEUED = "queued"
ACTIVE = "active"
FINISHED = "finished"
REJECTED = "rejected"


class ServingRequest:
    """One submitted generation request: prompt in, tokens out.

    Tokens arrive through the ``on_token`` callback (called on the thread
    that drives the engine: keep it cheap), the :meth:`stream` iterator
    (drained from any thread) and the :attr:`tokens` list. Latency rides
    the handle: :attr:`queue_wait_s` (submit to admission), :attr:`ttft_s`
    (submit to first token) and :attr:`per_token_s` (mean time between
    tokens after the first), on ``clock``.
    """

    def __init__(self, prompt, max_new_tokens: int, *,
                 eos_token: int | None = None,
                 on_token: Callable[[int], None] | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        # Process-unique: the request plane's track and record key.
        self.id = _observe_mod.next_request_id()
        self.eos_token = eos_token
        self.on_token = on_token
        self.tokens: list[int] = []
        self.status = QUEUED
        self.reject_reason: str | None = None
        self._clock = clock
        self.submitted_t = clock()
        self.admitted_t: float | None = None
        self.first_token_t: float | None = None
        self.finished_t: float | None = None
        self._done = threading.Event()
        self._stream: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the request finishes (or is rejected)."""
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
        """Yield tokens as they are produced (ends at completion; raises
        :class:`~fluxmpi_tpu_torch.errors.RequestRejectedError` on
        rejection and ``TimeoutError`` when ``timeout`` seconds pass
        without a token). Drive the engine from another thread
        (:meth:`InferenceEngine.start`) or interleave with
        :meth:`InferenceEngine.step` calls."""
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
    def queue_wait_s(self) -> float | None:
        if self.admitted_t is None:
            return None
        return self.admitted_t - self.submitted_t

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t

    @property
    def per_token_s(self) -> float | None:
        """Mean time between tokens after the first (None until finished
        or with a single generated token)."""
        if self.finished_t is None or self.first_token_t is None:
            return None
        n = len(self.tokens)
        if n < 2:
            return None
        return (self.finished_t - self.first_token_t) / (n - 1)

    def _deliver(self, token: int) -> None:
        if self.first_token_t is None:
            self.first_token_t = self._clock()
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
        self.finished_t = self._clock()
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


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class InferenceEngine:
    """Continuous-batching engine with a paged KV cache.

    Args:
      model: a :class:`~fluxmpi_tpu_torch.models.TransformerLM`; the engine
        runs on the model's device. (The JAX engine also takes the flax
        ``params``; a torch model holds its own.)
      slots: decode batch width (default: ``init(serving=)`` /
        ``FLUXMPI_TPU_SERVING_SLOTS`` / 8). The decode step's shapes are
        fixed by it.
      block_size: cache positions per pool block (default ... / 16).
      num_blocks: pool blocks including the trash block (default ... /
        ``1 + slots * max_len / block_size``: no oversubscription; size it
        down to make admission control bite).
      max_queue: queued requests past which :meth:`submit` rejects with
        reason ``"queue_full"`` (default ... / 64).
      max_len: per-sequence cap on ``prompt + max_new_tokens`` (default and
        upper bound the model's ``max_len``), rounded down to a block
        multiple.
      continuous: True = join between any two iterations; False = static
        batching (a new group only once every slot has drained).
      slo_ttft_s / slo_token_s: latency objectives; completions that break
        them count in ``serving.slo_violations{kind=}`` and the summary.
      registry: metrics registry (default: the process registry, resolved
        once per run).
      clock: time source for the latency accounting (injectable).
      flush_every: decode steps between gauge and counter updates (every
        admission updates them too).
      check_memory: refuse at construction (``RuntimeError``) a pool that
        would not fit beside what the device holds, by the memory plane's
        ``bytes_limit``.
      attention: ``"flash"`` / ``"naive"`` / ``"auto"`` for prefill and
        the paged decode step, passed to the model's own ``attention``
        switch on every call (default: ``init(serving=)`` /
        ``FLUXMPI_TPU_SERVING_ATTENTION`` / the model's).

    The engine registers itself as the process engine
    (:func:`get_engine`), which ``telemetry.shutdown()`` closes.
    """

    def __init__(self, model, *, slots: int | None = None,
                 block_size: int | None = None, num_blocks: int | None = None,
                 max_queue: int | None = None, max_len: int | None = None,
                 continuous: bool = True, slo_ttft_s: float | None = None,
                 slo_token_s: float | None = None,
                 registry: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 flush_every: int = 16, check_memory: bool = True,
                 attention: str | None = None):
        cfg = _config or ServingConfig()
        mode = attention if attention is not None else (
            cfg.attention if cfg.attention is not None
            else os.environ.get(_ENV_ATTENTION) or None)
        if mode is not None:
            if mode not in ("naive", "flash", "auto"):
                raise ValueError(f"attention must be 'naive', 'flash', or 'auto'; "
                                 f"got {mode!r}")
            if "attention" not in inspect.signature(model.forward).parameters:
                raise ValueError(
                    f"attention={mode!r} requires a model with the attention "
                    f"switch (TransformerLM-style); {type(model).__name__} has "
                    f"no such argument")
        self.attention = mode
        self.model = model
        self.device = model.device
        self.slots = _resolve(slots, cfg.slots, _ENV_SLOTS, _DEFAULT_SLOTS)
        self.block_size = _resolve(block_size, cfg.block_size, _ENV_BLOCK_SIZE,
                                   _DEFAULT_BLOCK_SIZE)
        self.max_queue = _resolve(max_queue, cfg.max_queue, _ENV_QUEUE,
                                  _DEFAULT_MAX_QUEUE)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        cap = int(max_len) if max_len is not None else int(model.max_len)
        cap = min(cap, int(model.max_len))
        self.max_len = (cap // self.block_size) * self.block_size
        if self.max_len < self.block_size:
            raise ValueError(f"max_len {cap} is below one block ({self.block_size})")
        self.max_blocks_per_seq = self.max_len // self.block_size
        nb = _resolve(num_blocks, cfg.num_blocks, _ENV_BLOCKS,
                      1 + self.slots * self.max_blocks_per_seq)
        self.continuous = bool(continuous)
        self.slo_ttft_s = slo_ttft_s
        self.slo_token_s = slo_token_s
        self.flush_every = max(1, int(flush_every))
        self._registry = registry
        self._clock = clock
        if not getattr(model, "batched_prefill_safe", False):
            warnings.warn(
                "model does not declare batched_prefill_safe: the engine's "
                "batched prefill can differ from generate()'s one-token "
                "ticks, so continuations may differ", stacklevel=2)
        self.cache = BlockKVCache(
            num_layers=model.num_layers, num_heads=model.num_heads,
            head_dim=model.head_dim, num_blocks=nb,
            block_size=self.block_size,
            max_blocks_per_seq=self.max_blocks_per_seq, dtype=model.dtype,
            device=self.device,
        )
        if check_memory:
            fits, detail = self.cache.fits_device()
            if not fits:
                raise RuntimeError(
                    f"KV pool would exhaust device memory ({detail}); "
                    f"shrink num_blocks/slots or block_size")

        self._queue: deque[ServingRequest] = deque()
        self._lock = threading.Lock()
        self._slots: list[_Slot | None] = [None] * self.slots
        self._draining = False
        self._closed = False
        self._preempted = False
        self._stop = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # The serve thread's exception, if it died (its pending requests
        # are rejected with reason "error").
        self.serve_error: BaseException | None = None

        self._completed = 0
        self._rejected = 0
        self._drained = 0
        self._decode_steps = 0
        self._prefills = 0
        self._tokens = 0
        self._slo_violations = 0
        # Engine-lifetime baselines of the registry counters' deltas.
        self._counted_steps = 0
        self._counted_tokens = 0
        self._counted_records = 0
        self._buckets: set[int] = set()
        mon = self._compile_monitor()
        if mon is not None:
            mon.track("serving.decode_step", self._decode_step)
        self._resolve_run()
        set_engine(self)

    @staticmethod
    def _compile_monitor():
        from ..telemetry.compileplane import get_compile_monitor

        return get_compile_monitor()

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
        if tokens.shape[0] not in self._buckets:
            self._buckets.add(tokens.shape[0])
            mon = self._compile_monitor()
            if mon is not None:
                mon.track(f"serving.prefill_{tokens.shape[0]}", self._prefill_step)
        toks = torch.from_numpy(tokens).to(dev).long()[None]
        logits, k, v = self.model(toks, train=False, return_kv=True,
                                  attention=self.attention)
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
        logits = self.model(tok, pos_offset=pos, kv_cache=(k_g, v_g),
                            attention=self.attention)
        rows = torch.arange(self.slots, device=dev)
        blk = tab[rows, pos // bs]
        off = pos % bs
        pool_k[:, blk, off] = k_g[:, rows, pos]
        pool_v[:, blk, off] = v_g[:, rows, pos]
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def warmup(self, prompt_lengths: tuple[int, ...] = ()) -> None:
        """Run the prefill buckets covering ``prompt_lengths`` and one
        decode step before traffic arrives (kernel builds, library
        handles). Every write lands in the trash block, so the allocator
        is untouched; the writes still race a serving thread, so call it
        before :meth:`start` or after :meth:`stop`."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "engine is serving on its background thread; warmup writes "
                "the KV pools and would race it — stop() first (new prefill "
                "buckets also run on demand at admission)")
        buckets = {self._bucket(max(1, int(p))) for p in prompt_lengths}
        buckets.add(self.block_size)
        trash = np.zeros((self.max_blocks_per_seq,), np.int32)
        prefills = self._prefills
        for bucket in sorted(buckets):
            self._prefill_step(np.zeros((bucket,), np.int32), 1, trash)
        self._decode_step(
            np.zeros((self.slots, self.max_blocks_per_seq), np.int32),
            np.zeros((self.slots,), np.int32), np.zeros((self.slots,), np.int32),
        )
        self._prefills = prefills

    # -- admission -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_token: int | None = None,
               on_token: Callable[[int], None] | None = None) -> ServingRequest:
        """Queue a request; returns its handle at once.

        A request whose worst-case KV footprint can never fit the pool
        raises ``ValueError`` (a sizing error, not load); a full queue, a
        drain or a closed engine rejects: the handle is already finished
        with ``status == "rejected"`` and ``serving.admission_rejects``
        counts it. Otherwise the request waits for a free slot and free
        blocks and joins the decode batch between iterations.
        """
        from .. import faults

        if faults.ARMED:
            faults.check("serving.admit")
        req = ServingRequest(prompt, max_new_tokens, eos_token=eos_token,
                             on_token=on_token, clock=self._clock)
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
            # A stopped engine (between stop() and the next run()/start())
            # queues: the next run() or start() serves it. Only a drain or
            # a teardown sheds.
            if self._draining or self._closed:
                self._reject(req, "draining" if self._draining else "shutdown")
                return req
            if len(self._queue) >= self.max_queue:
                self._reject(req, "queue_full")
                return req
            self._queue.append(req)
        self._wake.set()
        return req

    def _reject(self, req: ServingRequest, reason: str, *,
                kv_blocks: int = 0) -> None:
        self._rejected += 1
        req._finish(REJECTED, reason)
        reg = self._live_registry()
        if getattr(reg, "enabled", True):
            reg.counter("serving.admission_rejects", reason=reason).inc()
        # Looked up live, not per run: submit() rejects before any run
        # resolved the plane, and every rejected request must be logged.
        obs = _observe_mod.get_request_observer()
        if obs is not None and obs.enabled:
            obs.observe_terminal(req, kv_blocks=kv_blocks)
            if reason == "queue_full":
                # The first load-shed writes the pool census.
                obs.maybe_write_bundle(self, "queue_full")

    def _live_registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def _admit_phase(self) -> int:
        """Move queued requests into free slots, FIFO (a head request
        waiting for blocks holds the line), prefilling each."""
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
                    break
                self._queue.popleft()
            self._admit(head, free_ix, total)
            admitted += 1
        return admitted

    def _admit(self, req: ServingRequest, slot_ix: int, total: int) -> None:
        req.admitted_t = self._clock()
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
        if self._record and req.queue_wait_s is not None:
            self._reg.histogram("serving.queue_wait_seconds").observe(req.queue_wait_s)
        if self._finished(slot):
            self._evict(slot_ix)

    @staticmethod
    def _finished(slot: _Slot) -> bool:
        eos = slot.req.eos_token
        return slot.generated >= slot.req.max_new_tokens or (
            eos is not None and slot.last_token == int(eos))

    # -- decode --------------------------------------------------------

    def _decode_tick(self) -> None:
        """One iteration's decode: a single forward over every slot, then
        delivery and eviction on the host."""
        from .. import faults

        if faults.ARMED:
            faults.check("serving.decode")
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
        """Finish a slot's request and return its blocks to the pool."""
        slot = self._slots[slot_ix]
        self._slots[slot_ix] = None
        self.cache.free(slot.blocks)
        req = slot.req
        req._finish(FINISHED)
        self._completed += 1
        violations = []
        if self.slo_ttft_s is not None and (
                req.ttft_s is not None and req.ttft_s > self.slo_ttft_s):
            violations.append("ttft")
        if self.slo_token_s is not None and (
                req.per_token_s is not None and req.per_token_s > self.slo_token_s):
            violations.append("per_token")
        self._slo_violations += len(violations)
        if self._record:
            reg = self._reg
            if req.ttft_s is not None:
                reg.histogram("serving.ttft_seconds").observe(req.ttft_s)
            if req.per_token_s is not None:
                reg.histogram("serving.token_seconds").observe(req.per_token_s)
            # The served mix: completions only (a rejected request's sizes
            # are in its log record).
            reg.histogram("serving.prompt_tokens").observe(int(req.prompt.shape[0]))
            reg.histogram("serving.output_tokens").observe(len(req.tokens))
            reg.counter("serving.requests_completed").inc()
            for kind in violations:
                reg.counter("serving.slo_violations", kind=kind).inc()
        if self._observer is not None:
            self._observer.observe_terminal(req, kv_blocks=len(slot.blocks),
                                            violations=tuple(violations))

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

    def _begin_drain(self, *, preempted: bool) -> None:
        """Stop admitting: queued requests are rejected, active slots
        decode to completion."""
        with self._lock:
            self._draining = True
            self._preempted = self._preempted or preempted
            dropped = list(self._queue)
            self._queue.clear()
        self._drained += self.active_count
        for req in dropped:
            self._reject(req, "preempted" if preempted else "draining")

    def _iteration(self) -> bool:
        """Preemption poll, admissions, a decode tick, then liveness and
        metrics. Returns whether any work happened."""
        from ..runtime import preemption_requested
        from ..telemetry.watchdog import notify_progress

        if preemption_requested() and not self._draining:
            self._begin_drain(preempted=True)
        admitted = self._admit_phase()
        ticked = False
        if any(s is not None for s in self._slots):
            self._decode_tick()
            ticked = True
        if admitted or ticked:
            # Progress only when work happened: an idle serve thread must
            # not hide a co-resident training loop's stall.
            notify_progress(1)
        if admitted or (ticked and self._decode_steps % self.flush_every == 0):
            self._observe(phase="running")
        return bool(admitted) or ticked

    def _observe(self, phase: str) -> None:
        """Refresh the gauges, add the counters' deltas, feed the anomaly
        plane and post the exporter's board (resolved once per run:
        nothing on the fully-off path)."""
        obs = self._observer
        if self._record:
            reg = self._reg
            reg.gauge("serving.queue_depth").set(self.queue_depth)
            reg.gauge("serving.active_sequences").set(self.active_count)
            reg.gauge("serving.kv_blocks_in_use").set(self.cache.used_blocks)
            reg.gauge("serving.kv_blocks_free").set(self.cache.free_blocks)
            reg.gauge("serving.kv_high_watermark_blocks").set(
                self.cache.high_watermark_blocks)
            reg.gauge("serving.kv_fragmentation").set(self.cache.fragmentation)
            reg.counter("serving.decode_steps").inc(
                self._decode_steps - self._counted_steps)
            reg.counter("serving.tokens_generated").inc(
                self._tokens - self._counted_tokens)
            self._counted_steps = self._decode_steps
            self._counted_tokens = self._tokens
            if obs is not None:
                for w, rate in obs.burn.burn_rates().items():
                    reg.gauge("serving.slo_burn_rate", window=f"{w:g}").set(rate)
                reg.counter("serving.requests_logged").inc(
                    obs.records - self._counted_records)
                self._counted_records = obs.records
        if obs is not None:
            # The multi-window alert rate (both windows burning) feeds the
            # anomaly plane; the slo_burn rule owns the threshold and the
            # policy.
            rate = obs.burn.alert_rate()
            if rate is not None:
                from ..telemetry.anomaly import get_anomaly_detector

                det = get_anomaly_detector()
                if det is not None and det.enabled:
                    det.observe(slo_burn=rate, step=self._decode_steps)
        if self._exporter is not None:
            total = self.cache.num_blocks - 1
            board: dict[str, Any] = dict(
                phase=phase,
                continuous=self.continuous,
                slots=self.slots,
                active=self.active_count,
                queued=self.queue_depth,
                completed=self._completed,
                rejected=self._rejected,
                drained=self._drained,
                decode_steps=self._decode_steps,
                tokens=self._tokens,
                kv_blocks_in_use=self.cache.used_blocks,
                kv_blocks_total=total,
                kv_util=(self.cache.used_blocks / total) if total else 0.0,
                kv_high_watermark=self.cache.high_watermark_blocks,
                kv_fragmentation=self.cache.fragmentation,
                slo_violations=self._slo_violations,
            )
            if obs is not None:
                board.update(obs.board())
            self._exporter.note_serving(**board)

    def _resolve_run(self) -> None:
        """Resolve, once per run, every observability surface the loop
        touches. The ``_counted_*`` baselines live for the engine's
        lifetime, so ticks between the last update and a switch from
        start() to run() still reach the registry at the next one."""
        from ..telemetry.export import get_exporter

        self._reg = self._live_registry()
        self._record = bool(getattr(self._reg, "enabled", True))
        exp = get_exporter()
        self._exporter = exp if (exp is not None and exp.enabled) else None
        obs = _observe_mod.get_request_observer()
        self._observer = obs if (obs is not None and obs.enabled) else None

    def drain(self) -> None:
        """Wind down without a signal: stop admitting (queued requests are
        rejected, ``"draining"``), active slots decode to completion on the
        next iterations."""
        if not self._draining:
            self._begin_drain(preempted=False)

    def step(self) -> bool:
        """Run ONE scheduler iteration inline; returns whether any work
        happened."""
        return self._iteration()

    def run(self) -> dict[str, Any]:
        """Drive the engine until queue and slots drain (or a preemption
        drain completes); returns the run summary."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "engine is already serving on its background thread; stop() "
                "it before driving run() inline")
        self._stop = False
        self._resolve_run()
        t0 = self._clock()
        tokens0 = self._tokens
        self._observe(phase="running")
        while True:
            worked = self._iteration()
            if not worked and self.active_count == 0 and (
                    self.queue_depth == 0 or self._draining):
                break
        return self._finish_run(t0, tokens0)

    def _finish_run(self, t0: float, tokens0: int) -> dict[str, Any]:
        wall = self._clock() - t0
        self._observe(phase="preempted" if self._preempted else "finished")
        if self._record and self._reg.sinks:
            self._reg.flush()
        return {
            "completed": self._completed,
            "rejected": self._rejected,
            "drained": self._drained,
            "preempted": self._preempted,
            "decode_steps": self._decode_steps,
            "tokens": self._tokens,
            "slo_violations": self._slo_violations,
            "wall_seconds": wall,
            # This run's tokens over this run's wall (the other counts are
            # engine-lifetime totals).
            "tokens_per_sec": (self._tokens - tokens0) / wall if wall > 0 else 0.0,
        }

    # -- background serving --------------------------------------------

    def _fail_pending(self, reason: str, *, include_active: bool) -> None:
        """Reject everything still pending through :meth:`_reject`'s
        accounting; evicted slots return their blocks."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            self._reject(req, reason)
        if include_active:
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    self._slots[i] = None
                    self.cache.free(slot.blocks)
                    self._reject(slot.req, reason, kv_blocks=len(slot.blocks))

    def start(self) -> "InferenceEngine":
        """Serve on a background thread until :meth:`stop`: the loop sleeps
        on an event when idle and wakes on :meth:`submit`. Consume with
        ``req.stream()`` / ``req.wait()`` on any thread. If an iteration
        raises, the thread banks the exception in :attr:`serve_error`,
        rejects every pending request (reason ``"error"``) and exits."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = False
        self.serve_error = None
        self._resolve_run()

        def serve() -> None:
            # The current CUDA device is per thread; the steps run under
            # torch.no_grad() (also per thread) by their decorators.
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop:
                try:
                    worked = self._iteration()
                except BaseException as exc:
                    self.serve_error = exc
                    warnings.warn(f"serving loop failed: {exc!r}; pending "
                                  f"requests rejected (reason='error')",
                                  stacklevel=2)
                    self._fail_pending("error", include_active=True)
                    return
                if not worked and self.active_count == 0:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()

        self._thread = threading.Thread(target=serve, name="fluxmpi-serving",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the background thread (idempotent); returns whether it
        stopped. Queued and active requests are NOT completed (a
        preemption drain winds down gracefully). A thread that outlives
        ``timeout`` keeps its reference, so a later :meth:`stop` or
        :meth:`close` retries and teardown never frees state it still
        touches."""
        self._stop = True
        self._wake.set()
        thread = self._thread
        if thread is None:
            return True
        thread.join(timeout=timeout)
        if thread.is_alive():
            warnings.warn(f"serving thread still running after {timeout}s "
                          f"(stuck in a step?); its state is left untouched",
                          stacklevel=2)
            return False
        self._thread = None
        return True

    def close(self) -> None:
        """Teardown: stop the serve thread, reject everything pending
        (``"shutdown"``), release every block, drop the pools and
        deregister. If the thread cannot be joined, its active slots and
        the pools stay (a leak rather than a double free)."""
        self._closed = True  # submits from here on reject ("shutdown")
        stopped = self.stop()
        self._fail_pending("shutdown", include_active=stopped)
        if stopped:
            self.cache.drop_pools()
        if get_engine() is self:
            set_engine(None)
