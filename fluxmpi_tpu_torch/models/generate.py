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
"""

from __future__ import annotations

import copy
import re

import torch

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
    for key, leaf in cache.items():
        name = key.rsplit(".", 1)[1]
        if name == "cache_index":
            leaf.fill_(plen)
        else:
            leaf[:, :plen] = (k if name == "cached_key" else v)[layer_index(key)]
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
    Returns int64 ``[b, plen + max_new_tokens]`` on the model's device."""
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
    vocab = model.vocab_size
    twin = _decode_twin(model)
    if prefill == "batched" and plen > 1:
        cache, _ = prefill_cache(model, prompt[:, : plen - 1], total)
        if sample:
            for _ in range(plen - 1):  # the scan's prompt ticks' draws
                _gumbel(b, vocab, rng, model.device)
        start = plen - 1
    else:
        cache = _sized_cache(twin, b, total)
        start = 0
    tok = prompt[:, start:start + 1]
    done = torch.zeros((b,), dtype=torch.bool, device=model.device)
    out = []
    for p in range(start, total - 1):
        logits, cache = twin(tok, train=False, pos_offset=p, cache=cache)
        logits = logits[:, -1]
        noise = _gumbel(b, vocab, rng, model.device) if sample else None
        if p + 1 < plen:  # still inside the prompt: teacher-force it
            nxt = prompt[:, p + 1]
        else:
            if sample:
                nxt = (_filter_logits(logits, temperature, top_k, top_p)
                       + noise).argmax(dim=-1)
            else:
                nxt = logits.argmax(dim=-1)
            if eos_token is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
                done = done | (nxt == eos_token)
        out.append(nxt)
        tok = nxt[:, None]
    gen = torch.stack(out, dim=1)[:, plen - 1 - start:]
    return torch.cat([prompt, gen], dim=1)


@torch.no_grad()
def beam_search(model, prompt, max_new_tokens: int, *, beam_size: int,
                length_penalty: float = 0.0, eos_token: int | None = None):
    """Beam-search decoding: the highest-scoring continuation under the
    model's log-likelihood, ``beam_size`` hypotheses at a time.

    The prompt fills the cache on ``b`` rows (one causal forward), which
    then repeats into ``b * beam_size`` rows, beams contiguous per batch
    row; only beam 0 is live at the start. Every tick is ONE batched
    forward of the decode twin over all beams; the tokens, scores and every
    cache tensor with a leading rows dim are reordered by the selected
    parents (a gather along the rows; ``cache_index`` passes through). A beam
    that emits ``eos_token`` is absorbed: its only continuation is ``eos``
    at zero added log-probability, so its score freezes. Candidates are
    ranked by the GNMT-penalised score ``cum_logp / ((5 + L) / 6) **
    length_penalty`` both when pruning (``L`` the frozen finish length of a
    finished beam, the tokens so far of a live one) and at the final
    selection; ``length_penalty=0`` ranks by the summed log-probability.

    Returns ``(tokens, scores)``: int64 ``[b, plen + max_new_tokens]``, the
    best sequence per row (``eos`` after a hypothesis' ``eos``), and
    float32 ``[b]``, its penalised score."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    total = _validate_lengths(model, plen, max_new_tokens)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    _validate_eos(model, eos_token)
    beam = int(beam_size)
    rows = b * beam
    vocab = model.vocab_size
    alpha = float(length_penalty)
    dev = model.device

    def lp(length):
        return ((5.0 + length.float()) / 6.0) ** alpha

    twin = _decode_twin(model)
    if plen > 1:
        cache, _ = prefill_cache(model, prompt[:, : plen - 1], total)
    else:
        cache = _sized_cache(twin, b, total)
    cache = {k: c.repeat_interleave(beam, dim=0) if c.ndim else c
             for k, c in cache.items()}
    toks = torch.zeros((b, beam, total), dtype=torch.long, device=dev)
    toks[:, :, :plen] = prompt[:, None, :]
    # Only beam 0 is live: identical hypotheses must not fill the beam.
    cum = torch.full((b, beam), float("-inf"), device=dev)
    cum[:, 0] = 0.0
    done = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    flen = torch.full((b, beam), max_new_tokens, dtype=torch.long, device=dev)
    base = (torch.arange(b, device=dev) * beam)[:, None]
    if eos_token is not None:
        eos_row = torch.full((vocab,), float("-inf"), device=dev)
        eos_row[int(eos_token)] = 0.0
    for pos in range(plen - 1, total - 1):
        tok = toks.reshape(rows, total)[:, pos:pos + 1]
        logits, cache = twin(tok, train=False, pos_offset=pos, cache=cache)
        logits = logits[:, -1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, beam, vocab)
        if eos_token is not None:
            logp = torch.where(done[:, :, None], eos_row, logp)
        raw = (cum[:, :, None] + logp).reshape(b, beam * vocab)
        gen_count = pos + 2 - plen  # generated tokens, this tick's included
        if alpha != 0.0:
            pen = lp(torch.where(done, flen, torch.full_like(flen, gen_count)))
            rank = (raw.reshape(b, beam, vocab) / pen[:, :, None]).reshape(b, -1)
        else:
            rank = raw
        top_idx = torch.topk(rank, beam, dim=1).indices
        cum = torch.gather(raw, 1, top_idx)
        parent = top_idx // vocab
        token = top_idx % vocab
        toks = torch.gather(toks, 1, parent[:, :, None].expand(-1, -1, total))
        toks[:, :, pos + 1] = token
        done = torch.gather(done, 1, parent)
        flen = torch.gather(flen, 1, parent)
        if eos_token is not None:
            ends_now = (token == eos_token) & ~done
            flen = torch.where(ends_now, torch.full_like(flen, gen_count), flen)
            done = done | (token == eos_token)
        flat = (parent + base).reshape(rows)
        cache = {k: c.index_select(0, flat) if c.ndim else c for k, c in cache.items()}
    scored = cum / lp(flen)
    best = scored.argmax(dim=1)
    out = toks[torch.arange(b, device=dev), best]
    return out, scored[torch.arange(b, device=dev), best]
