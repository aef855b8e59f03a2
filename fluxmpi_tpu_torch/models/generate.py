"""Greedy autoregressive generation with a KV cache for
:class:`~fluxmpi_tpu_torch.models.TransformerLM`.

Counterpart of :mod:`fluxmpi_tpu.models.generate`: the prompt fills the
cache through ONE batched causal forward (:func:`prefill_kv`,
:func:`prefill_cache`), then each tick feeds one token per row through
the cached decode path. The arithmetic of a row does not depend on the
cache length, so :class:`~fluxmpi_tpu_torch.serving.InferenceEngine`
(caches ``max_len`` long) produces the same tokens.
"""

from __future__ import annotations

import torch

from ..errors import refuse_unported

__all__ = ["generate", "prefill_kv", "prefill_cache"]


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


@torch.no_grad()
def prefill_kv(model, tokens):
    """K/V for every position of ``tokens [b, plen]`` from one causal
    forward. Returns ``(k, v, logits)``: ``k``/``v`` are
    ``[layers, b, plen, heads, head_dim]``, ``logits`` ``[b, plen, vocab]``.
    Right-padding is safe: the causal mask keeps a row's first positions
    independent of what follows them."""
    logits, k, v = model(tokens, return_kv=True)
    return k, v, logits


@torch.no_grad()
def prefill_cache(model, prompt, total: int):
    """Zero caches sized for ``total`` positions with the prompt's K/V
    written at ``0..plen-1``. Returns ``((k_cache, v_cache), last_logits)``
    with ``last_logits [b, vocab]`` the distribution after the prompt."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    k, v, logits = prefill_kv(model, prompt)
    shape = model.cache_shape(b, total)
    k_cache = torch.zeros(shape, dtype=model.dtype, device=model.device)
    v_cache = torch.zeros(shape, dtype=model.dtype, device=model.device)
    k_cache[:, :, :plen] = k
    v_cache[:, :, :plen] = v
    return (k_cache, v_cache), logits[:, plen - 1]


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, eos_token: int | None = None,
             rng=None, prefill: str = "auto"):
    """Greedy continuation of ``prompt`` (int ``[b, plen]``, ``plen >= 1``).

    Positions ``0..plen-2`` fill the cache in one causal forward; the last
    prompt token starts the decode ticks. ``eos_token``: once a row emits
    it, every later position of that row is ``eos_token``. Returns int64
    ``[b, plen + max_new_tokens]`` on the model's device.

    Sampling (``temperature > 0``, ``top_k``, ``top_p``) is not ported
    yet and raises ``NotImplementedError``; ``rng`` feeds only sampling.
    ``prefill``: ``"auto"`` and ``"batched"`` run the batched prefill
    above (the dense LM is token-exact with one-token decoding, so it is
    what the JAX package's ``"auto"`` picks for it); ``"scan"`` is not
    ported."""
    refuse_unported("generate", {"temperature": temperature != 0.0,
                                 "top_k": top_k is not None,
                                 "top_p": top_p is not None,
                                 "prefill": prefill == "scan"})
    if prefill not in ("auto", "batched", "scan"):
        raise ValueError(f"prefill must be 'auto', 'batched' or 'scan', "
                         f"got {prefill!r}")
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, plen = prompt.shape
    total = _validate_lengths(model, plen, max_new_tokens)
    _validate_eos(model, eos_token)
    if plen > 1:
        cache, _ = prefill_cache(model, prompt[:, : plen - 1], total)
    else:
        shape = model.cache_shape(b, total)
        cache = (torch.zeros(shape, dtype=model.dtype, device=model.device),
                 torch.zeros(shape, dtype=model.dtype, device=model.device))
    tok = prompt[:, plen - 1:]
    pos = torch.full((b,), plen - 1, dtype=torch.long, device=model.device)
    done = torch.zeros((b,), dtype=torch.bool, device=model.device)
    out = []
    for _ in range(max_new_tokens):
        logits = model(tok, pos_offset=pos, kv_cache=cache)
        nxt = logits[:, -1].argmax(dim=-1)
        if eos_token is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
            done = done | (nxt == eos_token)
        out.append(nxt)
        tok = nxt[:, None]
        pos = pos + 1
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
