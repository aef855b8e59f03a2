"""Autoregressive generation with a KV cache for
:class:`~fluxmpi_tpu_torch.models.TransformerLM`: greedy and sampled
:func:`generate` and :func:`beam_search`.

Counterpart of :mod:`fluxmpi_tpu.models.generate`. Decoding runs the
model's decode twin (:func:`_decode_twin`: the same configuration with
``decode=True``, sharing the model's parameters) on flax's cache
collection, a flat dict keyed by flax path (:func:`cache_template`,
:func:`_sized_cache`, :func:`prefill_cache`;
:mod:`~fluxmpi_tpu_torch.models.transformer` describes it): one
``twin(tok, pos_offset=pos, cache=cache)`` per tick, as the JAX package
applies the twin with ``mutable=["cache"]``. With ``prefill="batched"``
the prompt fills the cache through ONE causal forward (:func:`prefill_kv`,
:func:`prefill_cache`) and the ticks start at the last prompt token; with
``prefill="scan"`` every prompt token is fed through the twin one tick at a
time from position 0, teacher-forced. Each tick feeds one token per row.
The arithmetic of a row does not depend on the cache length, so
:class:`~fluxmpi_tpu_torch.serving.InferenceEngine` (caches ``max_len``
long, ``forward(kv_cache=)``, the same code) produces the same greedy
tokens.

Sampling draws Gumbel noise for the whole ``[batch, vocab]`` row on every
tick, teacher-forced prompt ticks included, from the caller's
``torch.Generator``: a batched prefill advances the generator by the
``plen - 1`` draws the scan's prompt ticks make, so both paths draw the
same noise for every generated token, as the JAX package replays one rng
split per prompt tick. The filters and the draw run in float32.

The ticks are the JAX package's scan bodies (:func:`_generate_tick`,
:func:`_beam_tick`): the carry lives in device tensors (the cache, the
tokens, the position, ``done``), the teacher-forced token is picked on
the device, and nothing is read on the host between ticks. On the CPU
the ticks loop eagerly. On the card, as the JAX package jits its scan into
one program, a decode loop is cached on the model per static key (rows,
length, the sampling options, ``eos_token``; the prompt length and the
caller's generator are data) and its tick is ONE CUDA graph replayed per
tick (:class:`~fluxmpi_tpu_torch.utils._step_graph.StepGraph`: the first
tick of a new loop runs eagerly, the second captures); the host reads the
tokens once, after the last tick. A sampling loop registers a generator
of its own with the graph and moves the caller's generator state in and
out around the ticks, so the draws are the eager ones.
"""

from __future__ import annotations

import copy
import functools
import re
import threading
import weakref
from collections import OrderedDict
from types import SimpleNamespace
from typing import Callable

import torch

from ..utils._step_graph import StepGraph
from .transformer import (EncoderBlock, TransformerEncoder, TransformerLM,
                          _resolve_attention_mode)

__all__ = ["generate", "beam_search", "prefill_kv", "prefill_cache"]


def _share(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module``'s tree of modules holding the same parameter
    and buffer tensors (no storage copied)."""
    twin = copy.copy(module)
    twin._parameters = dict(module._parameters)
    twin._buffers = dict(module._buffers)
    twin._modules = {name: None if child is None else _share(child)
                     for name, child in module._modules.items()}
    return twin


def _decode_twin(model):
    """The same model configured for cached single-position decoding:
    ``decode=True``, ``attention_fn=None``, ``dropout=0.0``, the same class
    and every other field, sharing the model's parameter tensors (training
    the model moves the twin)."""
    twin = _share(model)
    for m in twin.modules():
        if isinstance(m, (EncoderBlock, TransformerEncoder, TransformerLM)):
            m.decode, m.attention_fn, m.dropout = True, None, 0.0
        if isinstance(m, EncoderBlock):
            m.mode = _resolve_attention_mode(m.attention, m.device)
            m.attn.dropout_rate = 0.0
    return twin


def _validate_lengths(model, plen: int, max_new_tokens: int) -> int:
    total = plen + int(max_new_tokens)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if total > model.max_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds the model's "
            f"max_len {model.max_len}"
        )
    return total


def _validate_eos(model, eos_token: int | None) -> None:
    if eos_token is not None and not 0 <= eos_token < model.vocab_size:
        raise ValueError(
            f"eos_token {eos_token} is outside the model's vocabulary "
            f"[0, {model.vocab_size})"
        )


def cache_template(twin, rows: int, total: int) -> dict:
    """The skeleton of the decode twin's cache for ``rows`` sequences of
    length ``total``: ``meta`` tensors (shapes and dtypes, no storage, no
    forward), keyed by flax path joined with ``.``: per attention
    ``cache_index`` (int32 scalar), ``cached_key`` and ``cached_value``
    (``[rows, total, heads, head_dim]`` in the model's dtype)."""
    out = {}
    for name, m in twin.named_modules():
        if isinstance(m, EncoderBlock):
            path = f"{name}.attn." if name else "attn."
            kv = (rows, total, m.num_heads, m.d_model // m.num_heads)
            out[path + "cache_index"] = torch.empty((), dtype=torch.int32, device="meta")
            for leaf in ("cached_key", "cached_value"):
                out[path + leaf] = torch.empty(kv, dtype=m.dtype, device="meta")
    return out


def _sized_cache(twin, rows: int, total: int) -> dict:
    """Zero caches for ``rows`` sequences of length ``total`` on the
    twin's device (flax's decode caches initialize to zeros)."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=twin.device)
            for k, t in cache_template(twin, rows, total).items()}


_BLOCK_RE = re.compile(r"block_(\d+)$")


def layer_index(path) -> int:
    """Encoder-layer index of a cache or parameter path: a dotted key
    (``"encoder.block_10.attn.cached_key"``) or a tuple of keys (or of
    JAX-style entries with a ``.key``). Sorting by it puts ``block_10``
    after ``block_2``."""
    keys = path.split(".") if isinstance(path, str) else [getattr(e, "key", e)
                                                           for e in path]
    for key in keys:
        if isinstance(key, str) and (m := _BLOCK_RE.match(key)):
            return int(m.group(1))
    where = "".join(f"[{k!r}]" for k in keys)
    raise ValueError(
        f"no block_<i> component in cache path {where!r}"
        " — the model's encoder layers are not TransformerLM-shaped"
    )


@torch.no_grad()
def prefill_kv(model, tokens):
    """K/V for every position of ``tokens [b, plen]`` from one causal
    forward (of the training configuration, a twin's too). Returns ``(k,
    v, logits)``: ``k``/``v`` are ``[layers, b, plen, heads, head_dim]`` in
    layer order, ``logits`` ``[b, plen, vocab]``. Right-padding is safe: the
    causal mask keeps a row's first positions independent of what follows
    them."""
    logits, k, v = model(tokens, train=False, return_kv=True)
    return k, v, logits


def _fill_cache(cache: dict, k=None, v=None, n: int = 0, repeat: int = 1) -> None:
    """Reset the twin's ``cache`` in place to the state ``n`` one-token
    ticks reach: ``k``/``v`` (``[layers, rows, n, heads, head_dim]``, each
    row repeated ``repeat`` times along the cache's rows) at positions
    ``0..n-1``, zeros past them, every ``cache_index`` at ``n``."""
    for key, leaf in cache.items():
        name = key.rsplit(".", 1)[1]
        if name == "cache_index":
            leaf.fill_(n)
            continue
        leaf.zero_()
        if n:
            src = (k if name == "cached_key" else v)[layer_index(key)]
            leaf[:, :n] = src.repeat_interleave(repeat, dim=0) if repeat > 1 else src


@torch.no_grad()
def prefill_cache(model, prompt, total: int):
    """Batched prefill into a fresh decode cache: one causal forward
    (:func:`prefill_kv`) writes the prompt's K/V at positions ``0..plen-1``
    of zero caches sized for ``total`` positions (the decode twin's layout,
    :func:`cache_template`), with every ``cache_index`` at ``plen``: the
    state ``plen`` one-token ticks reach, in one pass. Returns ``(cache,
    last_logits)``, ``last_logits [b, vocab]`` the distribution after the
    prompt."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    k, v, logits = prefill_kv(model, prompt)
    cache = _sized_cache(_decode_twin(model), b, total)
    _fill_cache(cache, k, v, plen)
    return cache, logits[:, plen - 1].clone()  # not a view holding every position


def _filter_logits(logits, temperature: float, top_k: int | None,
                   top_p: float | None):
    """The sampling distribution's logits in float32: the k-filter on the
    raw logits first, then the temperature, then the nucleus on the scaled
    logits (the kept set is the prefix of the descending sort whose
    EXCLUSIVE cumulative probability is ``< top_p``, so the argmax always
    survives). Masked entries are ``-inf``."""
    logits = logits.float()
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / temperature
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        thresh = thresh.min(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    return scaled


def _gumbel(rows: int, vocab: int, rng: torch.Generator, device):
    """One tick's Gumbel noise ``[rows, vocab]``: a fixed count of uniform
    draws from ``rng``, whatever the tick does with them."""
    u = torch.rand((rows, vocab), generator=rng, device=device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _graphed(model) -> bool:
    """Whether the model's decode loops run as CUDA graphs (on the card)."""
    return torch.device(model.device).type == "cuda"


def _generate_state(twin, rows: int, total: int) -> SimpleNamespace:
    """:func:`generate`'s carry as static device tensors: the twin's
    ``cache``, ``seq [rows, total]`` (the prompt, then each tick's token
    at its position), the tick's position ``pos``, the prompt length
    ``plen`` and ``done [rows]`` (int64 scalars, bools)."""
    dev = twin.device
    return SimpleNamespace(
        cache=_sized_cache(twin, rows, total),
        seq=torch.zeros((rows, total), dtype=torch.long, device=dev),
        pos=torch.zeros((), dtype=torch.long, device=dev),
        plen=torch.zeros((), dtype=torch.long, device=dev),
        done=torch.zeros((rows,), dtype=torch.bool, device=dev))


def _generate_load(model, st: SimpleNamespace, prompt, prefill: str) -> int:
    """Load ``prompt [b, plen]`` into ``st`` for ``prefill`` (the batched
    prefill's one causal forward writes positions ``0..plen-2``; the scan
    starts from zeros at position 0); returns the ticks to run."""
    plen = prompt.shape[1]
    if prefill == "batched" and plen > 1:
        k, v, _ = prefill_kv(model, prompt[:, :plen - 1])
        _fill_cache(st.cache, k, v, plen - 1)
        start = plen - 1
    else:
        _fill_cache(st.cache)
        start = 0
    st.seq.zero_()
    st.seq[:, :plen] = prompt
    st.pos.fill_(start)
    st.plen.fill_(plen)
    st.done.zero_()
    return st.seq.shape[1] - 1 - start


def _generate_tick(twin, st: SimpleNamespace, *, temperature: float, top_k, top_p,
                   eos_token, rng) -> None:
    """One tick of :func:`generate`, the JAX package's scan body, on the
    device with no host read: the twin decodes ``seq[:, pos]`` at ``pos``;
    the next token is the prompt's while ``pos + 1 < plen`` (teacher
    forcing), else the argmax or the Gumbel-max draw (a fixed count of
    draws every tick); ``eos`` then pads a finished row and finishes rows
    only outside the prompt; the token lands at ``seq[:, pos + 1]`` and
    ``pos`` advances. Every argument is the same on every tick."""
    rows, total = st.seq.shape
    at = st.pos.reshape(1)
    logits = twin(st.seq.index_select(1, at), train=False, pos_offset=st.pos,
                  cache=st.cache)[0][:, -1]
    if temperature > 0:
        noise = _gumbel(rows, logits.shape[-1], rng, logits.device)
        nxt = (_filter_logits(logits, temperature, top_k, top_p) + noise).argmax(dim=-1)
    else:
        nxt = logits.argmax(dim=-1)
    after = (at + 1).clamp(max=total - 1)
    in_prompt = st.pos + 1 < st.plen
    nxt = torch.where(in_prompt, st.seq.index_select(1, after)[:, 0], nxt)
    if eos_token is not None:
        nxt = torch.where(st.done, torch.full_like(nxt, eos_token), nxt)
        st.done.logical_or_((nxt == eos_token) & ~in_prompt)
    st.seq.index_copy_(1, after, nxt[:, None])
    st.pos.add_(1)


class _Ticks:
    """A decode loop of one model at one static key: its carry as static
    device tensors (``state``, made by ``make_state(twin)``) and its tick
    (``tick(twin, state, rng=..., **options)``, the same arguments every
    tick) as a :class:`~fluxmpi_tpu_torch.utils._step_graph.StepGraph`
    named ``name``. A sampling loop draws from a generator of its own,
    registered with the graph: a call moves the caller's generator state
    in before the ticks and out after, so any generator gets the draws the
    eager ticks make from it."""

    def __init__(self, name: str, model, make_state: Callable, tick: Callable,
                 options: dict, sample: bool):
        twin = _decode_twin(model)
        self.state = make_state(twin)
        self.rng = torch.Generator(device=model.device) if sample else None
        self.lock = threading.Lock()
        body = functools.partial(tick, twin, self.state, rng=self.rng, **options)
        self.graph = StepGraph(name, body, model.device,
                               generators=[self.rng] if sample else [])

    def run(self, ticks: int, rng: torch.Generator | None = None) -> None:
        if self.rng is not None:
            self.rng.set_state(rng.get_state())
        for _ in range(ticks):
            self.graph()
        if self.rng is not None:
            rng.set_state(self.rng.get_state())

    def release_graph(self) -> None:
        self.graph.release_graph()


# Per model, its decode loops by static key, the most recently used last.
_loops: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_loops_lock = threading.Lock()
_LOOPS_KEPT = 4


def _loop(model, key: tuple, make: Callable[[], _Ticks]) -> _Ticks:
    """The model's cached decode loop at ``key`` (with the model's dtype
    and attention mode), made by ``make()`` on a miss or when the model's parameter tensors are other tensors than the
    loop's graph reads; at most ``_LOOPS_KEPT`` loops a model (the least
    recently used one's graph is released)."""
    bound = tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))
    key = (*key, model.dtype, getattr(model, "attention", None))
    with _loops_lock:
        loops = _loops.setdefault(model, OrderedDict())
        held = loops.pop(key, None)
        if held is not None and held[0] != bound:
            held[1].release_graph()
            held = None
        if held is None:
            held = (bound, make())
        loops[key] = held
        while len(loops) > _LOOPS_KEPT:
            loops.popitem(last=False)[1][1].release_graph()
    return held[1]


def _generate_loop(model, rows: int, total: int, options: dict, sample: bool) -> _Ticks:
    """The model's cached :func:`generate` loop for ``rows`` sequences of
    ``total`` positions under the tick's ``options``."""
    return _loop(model, ("generate", rows, total, *options.values()),
                 lambda: _Ticks("generate tick", model,
                                lambda twin: _generate_state(twin, rows, total),
                                _generate_tick, options, sample))


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, eos_token: int | None = None,
             rng: torch.Generator | None = None, prefill: str = "auto"):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (int
    ``[b, plen]``, ``plen >= 1``).

    ``temperature``: 0 = greedy argmax; > 0 = softmax sampling at that
    temperature (Gumbel-max), which needs ``rng``, a ``torch.Generator`` on
    the model's device. ``top_k``: with sampling, keep the k highest logits
    (ties at the k-th kept). ``top_p``: with sampling, nucleus filtering on
    the scaled logits (the most probable token always survives); composes
    with ``top_k`` (k-filter first). ``eos_token``: once a row emits it,
    every later position of that row is ``eos_token``. ``prefill``:
    ``"batched"`` fills the cache with one causal forward over the prompt;
    ``"scan"`` teacher-forces the prompt one tick at a time from position
    0; ``"auto"`` picks batched for models that declare
    ``batched_prefill_safe`` and the scan for the rest. Both paths draw
    the same noise for every generated token (the module docstring).

    On the card the ticks run as one CUDA graph replayed per tick (the
    module docstring). Returns int64 ``[b, plen + max_new_tokens]`` on the
    model's device."""
    return _generate(model, prompt, max_new_tokens, graphed=_graphed(model),
                     temperature=temperature, top_k=top_k, top_p=top_p,
                     eos_token=eos_token, rng=rng, prefill=prefill)


@torch.no_grad()
def _generate(model, prompt, max_new_tokens: int, *, graphed: bool,
              temperature: float = 0.0, top_k: int | None = None,
              top_p: float | None = None, eos_token: int | None = None,
              rng: torch.Generator | None = None, prefill: str = "auto"):
    """:func:`generate`; ``graphed=False`` loops the tick eagerly (the CPU's
    path, and the card's eager reference)."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    total = _validate_lengths(model, plen, max_new_tokens)
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and rng is None:
        raise ValueError("temperature > 0 requires an rng key")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    _validate_eos(model, eos_token)
    if prefill not in ("auto", "batched", "scan"):
        raise ValueError(f"prefill must be 'auto', 'batched', or 'scan', "
                         f"got {prefill!r}")
    if prefill == "auto":
        prefill = "batched" if getattr(model, "batched_prefill_safe", False) else "scan"
    sample = temperature > 0
    if sample and graphed and rng.device.type != torch.device(model.device).type:
        raise ValueError(f"rng must be a torch.Generator on the model's device "
                         f"({model.device}), got one on {rng.device}")
    options = dict(temperature=float(temperature) if sample else 0.0,
                   top_k=top_k if sample else None, top_p=top_p if sample else None,
                   eos_token=None if eos_token is None else int(eos_token))
    if graphed:
        loop = _generate_loop(model, b, total, options, sample)
        with loop.lock:
            ticks = _generate_load(model, loop.state, prompt, prefill)
            _burn_prompt_draws(prefill, plen, b, model, rng, sample)
            loop.run(ticks, rng)
            return loop.state.seq.clone()
    twin = _decode_twin(model)
    st = _generate_state(twin, b, total)
    ticks = _generate_load(model, st, prompt, prefill)
    _burn_prompt_draws(prefill, plen, b, model, rng, sample)
    for _ in range(ticks):
        _generate_tick(twin, st, rng=rng, **options)
    return st.seq


def _burn_prompt_draws(prefill: str, plen: int, rows: int, model, rng, sample: bool) -> None:
    """A batched prefill skips the scan's ``plen - 1`` prompt ticks: their
    draws, so every generated token gets the scan's noise."""
    if sample and prefill == "batched" and plen > 1:
        for _ in range(plen - 1):
            _gumbel(rows, model.vocab_size, rng, model.device)


def _length_penalty(length, alpha: float):
    """GNMT's ``((5 + L) / 6) ** alpha``, in float32."""
    return ((5.0 + length.float()) / 6.0) ** alpha


def _beam_state(twin, b: int, beam: int, total: int, vocab: int,
                eos_token: int | None) -> SimpleNamespace:
    """:func:`beam_search`'s carry as static device tensors: the twin's
    ``cache`` over ``b * beam`` rows (beams contiguous per batch row),
    ``toks [b, beam, total]``, ``cum`` and ``flen`` and ``done [b, beam]``,
    ``pos`` and ``plen`` (int64 scalars); constants ``base`` (each batch
    row's first cache row) and ``eos_row`` (``eos`` at 0, the rest at
    ``-inf``)."""
    dev = twin.device
    eos_row = torch.full((vocab,), float("-inf"), device=dev)
    if eos_token is not None:
        eos_row[int(eos_token)] = 0.0
    return SimpleNamespace(
        cache=_sized_cache(twin, b * beam, total),
        toks=torch.zeros((b, beam, total), dtype=torch.long, device=dev),
        cum=torch.zeros((b, beam), dtype=torch.float32, device=dev),
        done=torch.zeros((b, beam), dtype=torch.bool, device=dev),
        flen=torch.zeros((b, beam), dtype=torch.long, device=dev),
        pos=torch.zeros((), dtype=torch.long, device=dev),
        plen=torch.zeros((), dtype=torch.long, device=dev),
        base=(torch.arange(b, device=dev) * beam)[:, None], eos_row=eos_row)


def _beam_tick(twin, st: SimpleNamespace, *, alpha: float, eos_token, rng) -> None:
    """One tick of :func:`beam_search`, the JAX package's beam scan body,
    on the device with no host read: one forward of every beam, the
    candidates ranked by the penalised score, the best ``beam`` kept, the
    tokens, scores, ``done`` and finish lengths gathered from the parents
    and every cache tensor with a rows dim reordered in place (the graph
    reads fixed addresses); ``pos`` advances."""
    del rng  # beam search draws nothing
    b, beam, total = st.toks.shape
    rows = b * beam
    at = st.pos.reshape(1)
    tok = st.toks.reshape(rows, total).index_select(1, at)
    logits = twin(tok, train=False, pos_offset=st.pos, cache=st.cache)[0][:, -1]
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, beam, vocab)
    if eos_token is not None:
        logp = torch.where(st.done[:, :, None], st.eos_row, logp)
    raw = (st.cum[:, :, None] + logp).reshape(b, beam * vocab)
    gen_count = st.pos + 2 - st.plen  # generated tokens, this tick's included
    if alpha != 0.0:
        pen = _length_penalty(torch.where(st.done, st.flen, gen_count), alpha)
        rank = (raw.reshape(b, beam, vocab) / pen[:, :, None]).reshape(b, -1)
    else:
        rank = raw
    top_idx = torch.topk(rank, beam, dim=1).indices
    parent = top_idx // vocab
    token = top_idx % vocab
    st.cum.copy_(torch.gather(raw, 1, top_idx))
    toks = torch.gather(st.toks, 1, parent[:, :, None].expand(-1, -1, total))
    toks.index_copy_(2, at + 1, token[:, :, None])
    done = torch.gather(st.done, 1, parent)
    flen = torch.gather(st.flen, 1, parent)
    if eos_token is not None:
        ends_now = (token == eos_token) & ~done
        flen = torch.where(ends_now, gen_count, flen)
        done = done | (token == eos_token)
    st.toks.copy_(toks)
    st.done.copy_(done)
    st.flen.copy_(flen)
    flat = (parent + st.base).reshape(rows)
    for c in st.cache.values():
        if c.ndim:
            c.copy_(c.index_select(0, flat))
    st.pos.add_(1)


def _scan_prefill(model, prompt, total: int, graphed: bool) -> dict:
    """The cache of ``prompt [b, plen]``'s rows after teacher-forcing
    positions ``0..plen-2`` one tick at a time (generate's greedy ticks;
    the JAX package's beam-search prefill scan)."""
    b, plen = prompt.shape
    options = dict(temperature=0.0, top_k=None, top_p=None, eos_token=None)
    if graphed:
        loop = _generate_loop(model, b, total, options, False)
        with loop.lock:
            _generate_load(model, loop.state, prompt, "scan")
            loop.run(plen - 1)
            return {k: t.clone() for k, t in loop.state.cache.items()}
    twin = _decode_twin(model)
    st = _generate_state(twin, b, total)
    _generate_load(model, st, prompt, "scan")
    for _ in range(plen - 1):
        _generate_tick(twin, st, rng=None, **options)
    return st.cache


def _beam_load(model, st: SimpleNamespace, prompt, max_new_tokens: int,
               graphed: bool) -> None:
    """Load ``prompt [b, plen]`` into ``st``: the prompt's cache on ``b``
    rows (one causal forward for a model that declares
    ``batched_prefill_safe``, else the scan), repeated into every beam;
    only beam 0 live."""
    b, beam, _ = st.toks.shape
    plen = prompt.shape[1]
    if plen == 1:
        _fill_cache(st.cache)
    elif getattr(model, "batched_prefill_safe", False):
        k, v, _ = prefill_kv(model, prompt[:, :plen - 1])
        _fill_cache(st.cache, k, v, plen - 1, repeat=beam)
    else:
        rows = _scan_prefill(model, prompt, st.toks.shape[2], graphed)
        for key, c in st.cache.items():
            c.copy_(rows[key].repeat_interleave(beam, dim=0) if c.ndim else rows[key])
    st.toks.zero_()
    st.toks[:, :, :plen] = prompt[:, None, :]
    # Only beam 0 is live: identical hypotheses must not fill the beam.
    st.cum.fill_(float("-inf"))
    st.cum[:, 0] = 0.0
    st.done.zero_()
    st.flen.fill_(max_new_tokens)
    st.pos.fill_(plen - 1)
    st.plen.fill_(plen)


@torch.no_grad()
def beam_search(model, prompt, max_new_tokens: int, *, beam_size: int,
                length_penalty: float = 0.0, eos_token: int | None = None):
    """Beam-search decoding: the highest-scoring continuation under the
    model's log-likelihood, ``beam_size`` hypotheses at a time.

    The prompt fills the cache on ``b`` rows (one causal forward for a
    model that declares ``batched_prefill_safe``, else teacher-forced one
    tick at a time, as the JAX package always does), which then repeats
    into ``b * beam_size`` rows, beams contiguous per batch row; only beam
    0 is live at the start. Every tick is ONE batched forward of the decode
    twin over all beams; the tokens, scores and every cache tensor with a
    leading rows dim are reordered by the selected parents (a gather along
    the rows; ``cache_index`` passes through). A beam that emits
    ``eos_token`` is absorbed: its only continuation is ``eos`` at zero
    added log-probability, so its score freezes. Candidates are ranked by
    the GNMT-penalised score ``cum_logp / ((5 + L) / 6) ** length_penalty``
    both when pruning (``L`` the frozen finish length of a finished beam,
    the tokens so far of a live one) and at the final selection;
    ``length_penalty=0`` ranks by the summed log-probability. On the card
    the ticks run as one CUDA graph replayed per tick.

    Returns ``(tokens, scores)``: int64 ``[b, plen + max_new_tokens]``, the
    best sequence per row (``eos`` after a hypothesis' ``eos``), and
    float32 ``[b]``, its penalised score."""
    return _beam_search(model, prompt, max_new_tokens, graphed=_graphed(model),
                        beam_size=beam_size, length_penalty=length_penalty,
                        eos_token=eos_token)


@torch.no_grad()
def _beam_search(model, prompt, max_new_tokens: int, *, graphed: bool,
                 beam_size: int, length_penalty: float = 0.0,
                 eos_token: int | None = None):
    """:func:`beam_search`; ``graphed=False`` loops the tick eagerly (the
    CPU's path, and the card's eager reference)."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    total = _validate_lengths(model, plen, max_new_tokens)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    _validate_eos(model, eos_token)
    beam = int(beam_size)
    vocab = model.vocab_size
    options = dict(alpha=float(length_penalty),
                   eos_token=None if eos_token is None else int(eos_token))

    def make_state(twin):
        return _beam_state(twin, b, beam, total, vocab, options["eos_token"])

    if graphed:
        loop = _loop(model, ("beam_search", b, beam, total, *options.values()),
                     lambda: _Ticks("beam_search tick", model, make_state, _beam_tick,
                                    options, False))
        with loop.lock:
            st = loop.state
            _beam_load(model, st, prompt, max_new_tokens, graphed)
            loop.run(max_new_tokens)
            return _beam_best(st, options["alpha"])
    twin = _decode_twin(model)
    st = make_state(twin)
    _beam_load(model, st, prompt, max_new_tokens, graphed)
    for _ in range(max_new_tokens):
        _beam_tick(twin, st, rng=None, **options)
    return _beam_best(st, options["alpha"])


def _beam_best(st: SimpleNamespace, alpha: float):
    """Each batch row's best hypothesis and its penalised score."""
    scored = st.cum / _length_penalty(st.flen, alpha)
    best = scored.argmax(dim=1)
    rows = torch.arange(st.toks.shape[0], device=best.device)
    return st.toks[rows, best], scored[rows, best]
