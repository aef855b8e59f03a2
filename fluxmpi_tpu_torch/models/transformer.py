"""Pre-LN Transformer encoder and language model.

Counterpart of :mod:`fluxmpi_tpu.models.transformer`. The parameters keep
flax's names and layouts, so loading a JAX checkpoint is a copy
(:mod:`fluxmpi_tpu_torch.models.convert`): Dense kernels are ``[in, out]``,
the attention query/key/value kernels ``[d_model, heads, head_dim]`` and
the attention out kernel ``[heads, head_dim, d_model]``; the state-dict
key of every leaf is its flax path with ``/`` replaced by ``.``.

``attention="naive"|"flash"|"auto"``: ``"flash"`` routes every attend, the
causal forward and the cached decode step, through
:func:`fluxmpi_tpu_torch.ops.flash_attention`; ``"auto"`` picks flash on
CUDA and the dense attend on the CPU.

Training: :meth:`TransformerLM.forward` with ``targets=`` returns the
per-token cross-entropy through the chunked fused head
(:func:`fluxmpi_tpu_torch.ops.unembed_cross_entropy`), differentiable in
every parameter; with ``attention="flash"`` the attention forward and
backward run in the CUDA kernels.

Tensor parallelism: inside a layout step over a plan with ``tp > 1``
(:mod:`fluxmpi_tpu_torch._tensor_parallel`), a block whose Q/K/V/out or
ff1/ff2 weights arrive as this worker's blocks computes on its own heads
and columns and sums the row-parallel products over the tp group, and an
LM whose table arrives as its vocab rows looks tokens up in them and
takes the vocab-parallel cross-entropy.

Sequence parallelism: inside a layout step over a plan with ``sp > 1``
(:mod:`fluxmpi_tpu_torch._sequence_parallel`), the LM's tokens are this
worker's block of each sequence: the positions are global, and each
block's attention is a ring over the sp axis
(:func:`~fluxmpi_tpu_torch.parallel.ring.ring_attention`, through the
flash kernels under ``attention="flash"``), or its ``attention_fn``, which
must itself be sequence-parallel (``ring_attention_fn``,
``ulysses_attention_fn``). The dense ring's dropout drops, at each tick,
the slice of the mask the unsharded dense attend draws from the same
generator; a feed-forward sublayer gets the block (the MoE layers route
each group whole themselves).

Cached decoding, two spellings of one implementation (both run
:meth:`TransformerEncoder.run` with each layer's cache passed by
reference; nothing copies or stacks a cache per position):

- the JAX package's decode twin: a module built with ``decode=True``
  (``EncoderBlock``, ``TransformerEncoder``, ``TransformerLM`` and the MoE
  models; :func:`~fluxmpi_tpu_torch.models.generate._decode_twin` makes one
  that shares a trained model's parameters) takes ``forward(..., cache=)``
  and returns ``(out, cache)``, as flax's ``apply(..., mutable=["cache"])``
  returns ``(out, {"cache": ...})``. ``cache`` is flax's cache collection
  as a flat dict keyed by flax path joined with ``.``
  (``"encoder.block_0.attn.cached_key"``): per attention,
  ``cached_key``/``cached_value`` ``[batch, total, heads, head_dim]`` in the
  model's dtype and ``cache_index``, an int32 scalar on the device. Each
  call feeds one position: the token's K/V are written at ``cache_index``
  (clamped to the cache, as flax's ``dynamic_update_slice``), it attends to
  the positions ``<= cache_index``, and ``cache_index`` goes up by one, all
  in place on the device (flax's MHA decode);
- :meth:`TransformerLM.forward` with ``kv_cache=(k, v)``
  (``[layers, batch, max_len, heads, head_dim]`` each) feeds one token per
  row at that row's own position ``pos_offset`` (``[batch]``), writes the
  new K/V into the cache in place, and attends to positions
  ``<= pos_offset`` of its row (the serving engine's paged pool).

At decode ``attention="flash"`` attends through the kernels with the
valid prefix as segment ids (no mask check); an ``attention_fn`` is
ignored, as in JAX. Decoding runs without autograd. A ``decode=True``
module called with ``train=True`` and ``dropout > 0`` drops as flax's
decode does (its attention's ``deterministic=not train``): the dense
attend drops, at each layer and position, what the training forward
drops there with the same ``dropout_rng`` draws (one seed per layer,
:func:`~fluxmpi_tpu_torch.models._layers.dense_dropout_keep` keyed by
the cache position), and the flash attend does not drop, as in training.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .. import _batch_parallel
from .. import _sequence_parallel as _sp
from .. import _tensor_parallel as _tp
from ..ops.flash_attention import flash_attention, flash_attention_fn
from ..ops.fused_ce import _FusedCETP, _mm_f32, unembed_cross_entropy
from ..runtime import resolve_device
from ._layers import (Dense, LayerNorm, MultiHeadDotProductAttention, _Init,
                      dot_product_attention)

__all__ = ["EncoderBlock", "TransformerEncoder", "TransformerLM"]


def _resolve_attention_mode(mode: str, device: torch.device) -> str:
    if mode == "auto":
        return "flash" if device.type == "cuda" else "naive"
    if mode not in ("naive", "flash"):
        raise ValueError(
            f"attention must be 'naive', 'flash', or 'auto'; got {mode!r}"
        )
    return mode


_CACHE_LEAVES = ("cache_index", "cached_key", "cached_value")


def _cache_layers(cache: dict, prefixes: list[str], x: torch.Tensor):
    """flax's decode caches of the attentions under ``prefixes`` (each
    ``"<path>."``, ``""`` for a block's own) as :meth:`EncoderBlock.run`
    takes a layer's cache, ``(k, v, pos, segments)``, for one position of
    ``x [b, 1, ...]``: each layer writes at its own ``cache_index``
    (clamped to the cache) and attends to positions ``<= cache_index``.
    Returns ``(layers, indices)``, the indices to advance after the run.
    A few launches for all the layers together, and no host read."""
    missing = [p + "attn." + n for p in prefixes for n in _CACHE_LEAVES
               if p + "attn." + n not in cache]
    if missing:
        raise ValueError(f"the decode cache lacks {missing[:3]} (make it with "
                         f"cache_template, _sized_cache or prefill_cache)")
    ks = [cache[p + "attn.cached_key"] for p in prefixes]
    vs = [cache[p + "attn.cached_value"] for p in prefixes]
    idx = [cache[p + "attn.cache_index"] for p in prefixes]
    b = x.shape[0]
    want = (b, 1, *ks[0].shape[2:])
    if (x.shape[1], ks[0].shape[0]) != (1, b):
        raise ValueError(f"Autoregressive cache shape error, expected query shape "
                         f"{want} instead got {(*x.shape[:2], *ks[0].shape[2:])}.")
    total = ks[0].shape[1]
    at = torch.stack(idx)
    pos = at.clamp(max=total - 1).long()[:, None].expand(-1, b)
    valid = (torch.arange(total, device=at.device) <= at[:, None]).to(torch.int32)
    valid = valid[:, None].expand(-1, b, -1).contiguous()
    q_seg = torch.ones((b, 1), dtype=torch.int32, device=at.device)
    return [(k, v, pos[i], (q_seg, valid[i]))
            for i, (k, v) in enumerate(zip(ks, vs))], idx


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + ff2(gelu(ff1(ln2(x))))``
    (:class:`fluxmpi_tpu.models.transformer.EncoderBlock`, the same fields).

    The attention: ``attention="flash"`` (or ``"auto"`` on CUDA) is
    :func:`~fluxmpi_tpu_torch.ops.flash_attention_fn` with
    ``causal=attention_causal`` (an ``attention_fn`` beside it raises);
    else ``attention_fn`` if given; else flax's dense attend, which
    ``attention_causal`` does not touch (as in JAX, only the mask makes it
    causal). ``make_ff()`` is the hook for another feed-forward sublayer,
    registered under its ``flax_name`` (flax's module name, default
    ``"ff"``) and called as ``ff(h, train=train)``, or with
    ``losses=`` (its sub-dict of the sowed-losses collection, see
    :meth:`TransformerLM.forward`) when the caller collects them.
    ``decode=True``: ``forward(x, cache=)`` feeds one position ``x [b, 1,
    d_model]`` through flax's cache of ``attn`` (keys ``attn.cached_key``,
    ``attn.cached_value``, ``attn.cache_index``; the module docstring) and
    returns ``(y, cache)``. Weights from the CPU ``generator`` (default
    seeded with 0) on ``device`` (default CUDA)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, attention_fn: Callable | None = None,
                 decode: bool = False, attention: str = "naive",
                 attention_causal: bool = False, ln_eps: float = 1e-6, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        self.decode, self.attention = bool(decode), attention
        self.mode = _resolve_attention_mode(attention, self.device)
        if self.mode == "flash" and attention_fn is not None:
            raise ValueError("attention='flash' conflicts with an explicit "
                             "attention_fn — pass one or the other")
        if attention_fn is not None:
            self.mode = "fn"
        self.d_model, self.num_heads, self.d_ff = d_model, num_heads, d_ff
        self.dropout = float(dropout)
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.attention_causal = bool(attention_causal)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.ln1 = LayerNorm(d_model, ln_eps, init)
        self.attn = MultiHeadDotProductAttention(num_heads, d_model, init=init,
                                                 dtype=dtype, dropout_rate=self.dropout)
        self.ln2 = LayerNorm(d_model, ln_eps, init)
        self._init = init
        ff = self.make_ff()
        del self._init
        self.ff_name = None
        if ff is None:
            self.ff1 = Dense((d_model, d_ff), (d_ff,), init, d_model)
            self.ff2 = Dense((d_ff, d_model), (d_model,), init, d_ff)
        else:
            self.ff_name = getattr(ff, "flax_name", "ff")
            self.add_module(self.ff_name, ff)

    def _sequence_parallel_attend(self, seq, mode, q, k, v, mask, train, dropout_rng):
        """The attention of this worker's sequence block under a
        sequence-parallel step: a ring over the step's sp axis (``"flash"``
        through the kernels, ``"naive"`` dense), or the block's
        ``attention_fn``, which must itself be sequence-parallel."""
        if mode == "fn":
            before = seq.entered
            o = self.attn.attend(self.attention_fn, q, k, v, mask=mask,
                                 deterministic=not train, dropout_rng=dropout_rng)
            if seq.entered == before:
                raise ValueError(
                    f"under a plan with sp the attention runs on this worker's "
                    f"sequence block, but this block's attention_fn is not "
                    f"sequence-parallel over '{seq.sp}' (use ring_attention_fn "
                    f"or ulysses_attention_fn)")
            return o
        if mask is not None:
            raise ValueError(
                "under a plan with sp the attention mask comes from the ring's "
                "global positions; an explicit mask is not sequence-parallel")
        from ..parallel.ring import _dense_dropout_ring, ring_attention

        if mode == "naive" and train and self.dropout > 0 and dropout_rng is not None:
            # The dense attend's draw (one seed per layer, from the same
            # generator), each tick dropping its slice of the whole mask.
            from ..ops.flash_attention import _draw_dropout_seed

            return _dense_dropout_ring(
                q, k, v, axis_name=seq.sp, causal=self.attention_causal,
                dropout_rate=self.dropout,
                dropout_seed=_draw_dropout_seed(dropout_rng).to(q.device))
        return ring_attention(q, k, v, axis_name=seq.sp, causal=self.attention_causal,
                              use_flash=mode == "flash")

    def make_ff(self) -> nn.Module | None:
        """Hook: a module for the feed-forward sublayer, or ``None`` for
        the dense MLP (its weights may draw from ``self._init``, the
        block's initializer, while it is built)."""
        return None

    def forward(self, x, *, train: bool = True, mask=None, dropout_rng=None,
                losses=None, cache=None):
        if self.decode:
            layers, idx = _cache_layers(cache or {}, [""], x)
            with torch.no_grad():
                y = self.run(x, train=train, cache=layers[0], dropout_rng=dropout_rng)[0]
                torch._foreach_add_(idx, 1)
            return y, cache
        if cache is not None:
            raise ValueError("cache= is the decode=True block's")
        return self.run(x, train=train, mask=mask, dropout_rng=dropout_rng,
                        losses=losses)[0]

    @_tp.owning
    def run(self, x, *, train=True, mask=None, mode=None, cache=None,
            dropout_rng=None, losses=None):
        """The block with the attention ``mode`` (default the block's own:
        ``"flash"``, ``"fn"`` for its ``attention_fn``, ``"naive"``).
        With ``cache = (k, v, pos, segments)`` (this layer's K/V cache
        ``[b, T, h, hd]``), one decode position per row at ``pos [b]``,
        written into the cache in place, attending where ``segments =
        (q_seg [b, 1], kv_seg [b, T])`` allow (an ``attention_fn`` is
        ignored there). Returns ``(y, k, v)`` with the new K/V.

        Attention dropout in training (``dropout > 0``, ``train=True``)
        draws from the ``torch.Generator`` ``dropout_rng`` (flax's
        ``rngs={"dropout": key}``): the dense attend drops its weights
        (:func:`~fluxmpi_tpu_torch.models._layers.dot_product_attention`),
        an ``attention_fn`` gets ``dropout_rng``/``dropout_rate``/
        ``deterministic`` when its signature names them, and ``"flash"``
        gets the mask alone (flax's keyword filter), so it never drops."""
        mode = mode or self.mode
        tp = _tp.current()
        attn = self.attn
        if tp is not None:
            tp.claim([(attn.query.kernel, 1), (attn.query.bias, 0), (attn.key.kernel, 1),
                      (attn.key.bias, 0), (attn.value.kernel, 1), (attn.value.bias, 0),
                      (attn.out.kernel, 0)])
        h = self.ln1(x, self.dtype)
        # This worker's heads of a tensor-parallel layout: column-parallel
        # Q/K/V, the row-parallel out projection summed over the tp group.
        heads_split = attn.query.kernel.shape[1] != self.num_heads
        if heads_split:
            tp = _tp.require("the attention's query kernel")
            h = tp.enter(h)
        q, k, v = attn.project(h)
        if cache is not None:
            kc, vc, pos, segments = cache
            rows = torch.arange(x.shape[0], device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            if mode == "flash":
                o = flash_attention(q, kc, vc, segment_ids=segments)
            else:  # the row's valid cache prefix; drops at the row's position
                drop = train and self.dropout > 0
                o = dot_product_attention(
                    q, kc, vc, mask=(segments[1] != 0)[:, None, None, :],
                    dropout_rng=dropout_rng, dropout_rate=self.dropout if drop else 0.0,
                    deterministic=not drop, dropout_positions=pos)
        elif (seq := _sp.current()) is not None and seq.sp is not None:
            o = self._sequence_parallel_attend(seq, mode, q, k, v, mask, train, dropout_rng)
        elif mode == "flash":
            o = flash_attention_fn(causal=self.attention_causal)(q, k, v, mask=mask)
        else:
            fn = self.attention_fn if mode == "fn" else dot_product_attention
            # A head block's dropout keys the whole batch's heads.
            with (_batch_parallel.heads(tp.index * q.shape[2], self.num_heads)
                  if heads_split else contextlib.nullcontext()):
                o = self.attn.attend(fn, q, k, v, mask=mask, deterministic=not train,
                                     dropout_rng=dropout_rng)
        if heads_split:
            x = x + (tp.reduce(attn.out(o, self.dtype, bias=False))
                     + attn.out.bias.to(self.dtype))
        else:
            x = x + attn.out(o, self.dtype)
        h = self.ln2(x, self.dtype)
        if self.ff_name is not None:
            # Under sp the sublayer gets this worker's sequence block (the
            # MoE layers route each group as a whole themselves).
            ff = getattr(self, self.ff_name)
            if losses is None:
                return x + ff(h, train=train), k, v
            return x + ff(h, train=train,
                          losses=losses.setdefault(self.ff_name, {})), k, v
        if tp is not None:
            tp.claim([(self.ff1.kernel, 1), (self.ff1.bias, 0), (self.ff2.kernel, 0)])
        if self.ff1.kernel.shape[1] != self.d_ff:
            # Column-parallel ff1, row-parallel ff2 summed over the tp group.
            tp = _tp.require("ff1's kernel")
            h = F.gelu(self.ff1(tp.enter(h), self.dtype), approximate="tanh")
            return x + (tp.reduce(self.ff2(h, self.dtype, bias=False))
                        + self.ff2.bias.to(self.dtype)), k, v
        h = F.gelu(self.ff1(h, self.dtype), approximate="tanh")  # flax nn.gelu: tanh
        return x + self.ff2(h, self.dtype), k, v


class TransformerEncoder(nn.Module):
    """Pre-LN encoder stack over embedded inputs ``[b, s, d_model]``
    (:class:`fluxmpi_tpu.models.transformer.TransformerEncoder`, the same
    fields): ``forward(x, *, train=True, mask=None, dropout_rng=None)``
    casts ``x`` to ``dtype``, runs the blocks (``mask``: a flax boolean mask
    broadcastable to ``[b, heads, s, s]``; ``dropout_rng`` as
    :meth:`EncoderBlock.run` takes it) and returns the final LayerNorm in
    f32.
    ``decode=True``: ``forward(x, cache=)`` feeds one position through
    flax's caches (keys ``block_<i>.attn.*``) and returns ``(hidden,
    cache)``, as :class:`EncoderBlock`.
    ``make_block(i)`` is the hook for another block type. Weights from the
    CPU ``generator`` (default seeded with 0) on ``device`` (default
    CUDA)."""

    def __init__(self, num_layers: int = 4, d_model: int = 128, num_heads: int = 4,
                 d_ff: int = 512, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None, decode: bool = False,
                 attention: str = "naive", attention_causal: bool = False,
                 ln_eps: float = 1e-6, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        self.decode = bool(decode)
        self.num_layers, self.d_model, self.num_heads = num_layers, d_model, num_heads
        self.d_ff, self.dropout, self.dtype = d_ff, float(dropout), dtype
        self.attention_fn, self.attention = attention_fn, attention
        self.attention_causal, self.ln_eps = bool(attention_causal), ln_eps
        # One generator draws every block's weights in turn (held only
        # while the blocks are built).
        self._generator = generator or torch.Generator().manual_seed(0)
        for i in range(num_layers):
            self.add_module(f"block_{i}", self.make_block(i))
        self.ln_out = LayerNorm(d_model, ln_eps, _Init(self.device, self._generator))
        del self._generator

    def make_block(self, i: int) -> nn.Module:
        """Hook: build encoder block ``i``."""
        return EncoderBlock(self.d_model, self.num_heads, self.d_ff, self.dropout,
                            self.dtype, self.attention_fn, self.decode, self.attention,
                            self.attention_causal, self.ln_eps, device=self.device,
                            generator=self._generator)

    def forward(self, x, *, train: bool = True, mask=None, dropout_rng=None,
                losses=None, cache=None):
        if self.decode:
            layers, idx = _cache_layers(
                cache or {}, [f"block_{i}." for i in range(self.num_layers)], x)
            with torch.no_grad():
                h = self.run(x.to(self.dtype), train=train, cache=layers,
                             dropout_rng=dropout_rng)[0]
                torch._foreach_add_(idx, 1)
            return h, cache
        if cache is not None:
            raise ValueError("cache= is the decode=True encoder's")
        return self.run(x.to(self.dtype), train=train, mask=mask,
                        dropout_rng=dropout_rng, losses=losses)[0]

    def run(self, x, *, train=True, mask=None, mode=None, cache=None,
            dropout_rng=None, losses=None):
        """The stack (arguments as :meth:`EncoderBlock.run`, ``cache`` every
        layer's ``(k, v, pos, segments)``, ``losses`` the stack's sub-dict
        of the sowed-losses collection). Returns ``(hidden, ks, vs)``: the
        final-LN output (f32) and each layer's new K/V."""
        ks, vs = [], []
        for i in range(self.num_layers):
            x, k, v = getattr(self, f"block_{i}").run(
                x, train=train, mask=mask, mode=mode,
                cache=None if cache is None else cache[i], dropout_rng=dropout_rng,
                losses=None if losses is None else losses.setdefault(f"block_{i}", {}))
            ks.append(k)
            vs.append(v)
        return self.ln_out(x, torch.float32), ks, vs


class TransformerLM(nn.Module):
    """Token embedding + learned positions + encoder + weight-tied head.

    Weights are drawn from the CPU ``generator`` (default: a fresh
    ``torch.Generator`` seeded with 0) and live on ``device``
    (default CUDA; ``"cpu"`` only when asked). ``dropout`` is the
    attention dropout rate of the JAX module; training with it takes a
    ``dropout_rng`` (see :meth:`forward`). ``attention_fn`` (e.g.
    :func:`~fluxmpi_tpu_torch.ops.flash_attention_fn` with ``causal=True``)
    takes the training forward's attention under flax's causal mask, as in
    JAX; cached decoding bypasses it, and ``attention="flash"`` beside it
    raises. ``decode=True`` makes the decode twin (the module docstring;
    :meth:`forward`'s ``cache=``)."""

    # A batched causal forward over a prompt computes the same per-token
    # function as one-position decoding (the gate generate() and the
    # engine's batched prefill rely on).
    batched_prefill_safe = True

    def __init__(self, vocab_size: int = 1024, max_len: int = 512,
                 num_layers: int = 4, d_model: int = 128, num_heads: int = 4,
                 d_ff: int = 512, *, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, attention_fn=None,
                 decode: bool = False, attention: str = "naive",
                 ln_eps: float = 1e-6, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads "
                             f"{num_heads}")
        self.device = resolve_device(device)
        _resolve_attention_mode(attention, self.device)  # validate early
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.d_ff = d_ff
        self.dropout = float(dropout)
        self.attention = attention
        self.attention_fn = attention_fn
        self.decode = bool(decode)
        self.ln_eps = ln_eps
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = _Init(self.device, generator)
        self.embed = nn.Module()
        self.embed.embedding = init.normal((vocab_size, d_model),
                                           1.0 / math.sqrt(d_model))
        self.pos_embed = init.normal((max_len, d_model), 0.02)
        self._generator = generator
        self.encoder = self.make_encoder()
        del self._generator

    def make_encoder(self) -> nn.Module:
        """Hook: build the encoder stack (subclasses swap the block type;
        weights from ``self._generator`` while the LM is built)."""
        # The LM applies its own causal mask in training, so the flash
        # kernels fold causality in (attention_causal=True).
        return TransformerEncoder(
            self.num_layers, self.d_model, self.num_heads, self.d_ff, self.dropout,
            self.dtype, self.attention_fn, self.decode, attention=self.attention,
            attention_causal=True, ln_eps=self.ln_eps, device=self.device,
            generator=self._generator)

    def attention_mode(self, override: str | None = None) -> str:
        return _resolve_attention_mode(override or self.attention, self.device)

    @_tp.owning
    def forward(self, tokens, *, train: bool = True, targets=None,
                loss_chunk: int = 8192, hidden: bool = False,
                pos_offset=None, kv_cache=None, attention: str | None = None,
                return_kv: bool = False, dropout_rng=None, losses=None, cache=None):
        """Logits ``[b, s, vocab]`` for int tokens ``[b, s]``: f32, or bf16
        in a bf16 model (bf16 operands, f32 accumulation, bf16 logits, as
        flax's ``Embed.attend`` gives them).

        Without ``kv_cache``: the causal forward over positions ``0..s-1``,
        differentiable. With ``targets`` (int labels of ``tokens``' shape)
        it returns the per-token cross-entropy losses ``[b, s]`` (f32)
        through the chunked fused head instead, never materializing the
        logits (``loss_chunk`` tiles the vocab). ``hidden=True`` returns
        ``(hidden_states, embedding)``: the final-LN activations and the
        tied ``[vocab, d_model]`` table. With ``return_kv`` it also returns
        each layer's K/V stacked as ``[layers, b, s, heads, head_dim]``
        (what the decode cache banks).

        ``train=True`` with ``dropout > 0`` needs ``dropout_rng``, a
        ``torch.Generator`` on the model's device (the JAX LM's
        ``rngs={"dropout": key}``; without it a ``ValueError``, as flax
        raises without the rng), and drops as the JAX LM does:
        ``attention="naive"`` in flax's dense attend (one ``[s, s]`` keep
        mask per layer shared across batch and heads; equal to JAX in law,
        not bit for bit, since flax's random stream cannot be reproduced);
        ``attention="flash"`` not at all, because flax's keyword filter
        hands ``flash_attention_fn`` no rate (the loss and gradients equal
        a ``dropout=0.0`` model's); an ``attention_fn`` whose signature
        names ``dropout_rng``, ``dropout_rate`` and ``deterministic`` gets
        them, and may drop in the kernels
        (``flash_attention(dropout_rate=, dropout_seed=)``).

        With ``kv_cache=(k, v)``: cached decoding, ``s == 1``; row ``i``'s
        token sits at position ``pos_offset[i]``, its K/V are written there
        in place, and it attends to cache positions ``<= pos_offset[i]``.
        ``attention`` overrides the model's switch for this call.

        ``decode=True`` (the decode twin): ``forward(tokens [b, 1], pos_offset=p,
        cache=cache)`` returns ``(logits, cache)``: ``pos_offset`` (an int or
        a 0-d tensor, default 0; clamped into the table as flax's
        ``dynamic_slice``) picks the position embedding, and every layer
        writes, attends and advances at its own ``cache_index`` (the module
        docstring); ``hidden=True`` gives ``((hidden, embedding), cache)``;
        ``targets`` raises, as in JAX. ``return_kv=True`` runs the causal
        forward over ``tokens`` instead, as the JAX package's ``prefill_kv``
        runs the training configuration.

        ``losses``: a dict that collects what the layers sow (flax's
        ``mutable=["losses"]``), nested as flax nests the collection:
        ``losses["encoder"]["block_0"]["moe"]["moe_aux_loss"] = (x,)``
        (the MoE models; see
        :func:`~fluxmpi_tpu_torch.models.collect_moe_losses`)."""
        if train and self.dropout > 0 and dropout_rng is None and kv_cache is None:
            raise ValueError(
                "training TransformerLM with dropout > 0 needs dropout_rng (a "
                "torch.Generator on the model's device), as the JAX LM needs "
                "rngs={'dropout': key}; or call with train=False")
        if self.decode and not return_kv:
            if targets is not None:
                raise ValueError("targets (fused loss) is a training path; "
                                 "decode=True is inference")
            with torch.no_grad():
                h = self._decode(tokens, pos_offset, attention, cache=cache or {},
                                 train=train, dropout_rng=dropout_rng)
                return ((h, self.embed.embedding) if hidden else self._head(h)), cache
        if cache is not None:
            raise ValueError("cache= is the decode=True model's (kv_cache= decodes "
                             "a training model)")
        if kv_cache is not None:
            if targets is not None or hidden:
                raise ValueError("targets/hidden are training paths; "
                                 "kv_cache is inference")
            with torch.no_grad():
                return self._head(self._decode(tokens, pos_offset, attention,
                                               kv_cache=kv_cache))
        if hidden and targets is not None:
            raise ValueError("pass either targets or hidden, not both")
        mode = self.attention_mode(attention)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"sequence length {s} exceeds max_len "
                             f"{self.max_len}")
        table = self.embed.embedding
        tp = _tp.current()
        vocab_split = table.shape[0] != self.vocab_size
        if vocab_split:
            # This worker's rows of a vocab-parallel table: a masked lookup
            # summed over the tp group, and the vocab-parallel head.
            tp = _tp.require("the embedding table")
            if targets is None:
                raise ValueError(
                    "a vocab-parallel embedding block computes the training "
                    "loss (targets=) only; logits and hidden=True need the "
                    "whole table")
            local = tokens - tp.index * table.shape[0]
            inside = (local >= 0) & (local < table.shape[0])
            rows = table[local.clamp(0, table.shape[0] - 1)] * inside[..., None]
            x = tp.reduce(rows).to(self.dtype)
        else:
            x = table[tokens].to(self.dtype)
        seq = _sp.current()
        if seq is not None and seq.sp is not None:
            # This worker's block of a sequence sharded over sp: global
            # positions, and the blocks' attention is the ring's.
            axis = seq.axis(seq.sp)
            if s * axis.size > self.max_len:
                raise ValueError(f"sequence length {s * axis.size} exceeds max_len "
                                 f"{self.max_len}")
            start = axis.index * s
            x = x + self.pos_embed[start:start + s][None].to(self.dtype)
            if mode == "naive" and self.attention_fn is not None:
                mode = "fn"
            h, ks, vs = self.encoder.run(
                x, train=train, mode=mode, dropout_rng=dropout_rng,
                losses=None if losses is None else losses.setdefault("encoder", {}))
            return self._outputs(h, hidden, targets, tp, vocab_split, loss_chunk,
                                 return_kv, ks, vs)
        x = x + self.pos_embed[:s][None].to(self.dtype)
        mask = None
        if mode == "naive":
            # flax's nn.make_causal_mask(tokens); the flash kernels take
            # causality from attention_causal instead.
            mask = torch.ones((s, s), dtype=torch.bool, device=self.device).tril()
            mask = mask.expand(b, 1, s, s)
            if self.attention_fn is not None:
                mode = "fn"
        h, ks, vs = self.encoder.run(
            x, train=train, mask=mask, mode=mode, dropout_rng=dropout_rng,
            losses=None if losses is None else losses.setdefault("encoder", {}))
        return self._outputs(h, hidden, targets, tp, vocab_split, loss_chunk,
                             return_kv, ks, vs)

    def _outputs(self, h, hidden, targets, tp, vocab_split, loss_chunk, return_kv, ks, vs):
        """The training forward's result from the final-LN activations."""
        table = self.embed.embedding
        if hidden:
            return h, self.embed.embedding
        if targets is not None:
            targets = torch.as_tensor(targets, device=self.device)
            if tp is not None:
                tp.claim([(table, 0)])
            if vocab_split:
                d = table.shape[1]
                return _FusedCETP.apply(
                    h.to(self.dtype).reshape(-1, d), table, targets.reshape(-1).long(),
                    min(loss_chunk, table.shape[0]), 0.0, tp.group, tp.size, tp.index,
                    None, False).reshape(targets.shape)
            return unembed_cross_entropy(h.to(self.dtype), table, targets,
                                         chunk=loss_chunk)
        logits = self._head(h)
        if return_kv:
            return logits, torch.stack(ks), torch.stack(vs)
        return logits

    def _decode(self, tokens, pos_offset, attention, kv_cache=None, cache=None,
                train=False, dropout_rng=None):
        """One cached position through the stack: the final-LN output.
        ``cache``: flax's caches (the decode twin), read and advanced at
        each layer's ``cache_index`` (``train``/``dropout_rng`` as the
        training forward takes them); else ``kv_cache=(k, v)`` at each
        row's ``pos_offset``."""
        mode = self.attention_mode(attention)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        x = self.embed.embedding[tokens].to(self.dtype)
        if cache is not None:
            if isinstance(pos_offset, torch.Tensor):
                at = pos_offset.to(self.device).long().clamp(0, self.max_len - s)
                table = self.pos_embed[at + torch.arange(s, device=self.device)]
            else:
                at = min(max(int(pos_offset or 0), 0), self.max_len - s)
                table = self.pos_embed[at:at + s]
            x = x + table[None].to(self.dtype)
            layers, idx = _cache_layers(
                cache, [f"encoder.block_{i}." for i in range(self.num_layers)], x)
            h = self.encoder.run(x, train=train, mode=mode, cache=layers,
                                 dropout_rng=dropout_rng)[0]
            torch._foreach_add_(idx, 1)
            return h
        if s != 1:
            raise ValueError(f"cached decoding feeds one token per row, "
                             f"got {s}")
        pos = torch.as_tensor(pos_offset, device=self.device).long()
        pos = pos.expand(b) if pos.ndim == 0 else pos
        x = x + self.pos_embed[pos][:, None].to(self.dtype)
        t_total = kv_cache[0].shape[2]
        # The valid prefix as segment ids: the query is segment 1, cache
        # positions past pos (stale or trash rows) are padding.
        segments = (
            torch.ones((b, 1), dtype=torch.int32, device=self.device),
            (torch.arange(t_total, device=self.device)[None, :]
             <= pos[:, None]).to(torch.int32),
        )
        layers = [(kv_cache[0][i], kv_cache[1][i], pos, segments)
                  for i in range(self.num_layers)]
        return self.encoder.run(x, train=False, mode=mode, cache=layers)[0]

    def _head(self, h):
        """The tied head's logits from the final-LN activations (f32)."""
        table = self.embed.embedding
        if self.dtype == torch.float32:
            return h @ table.t()
        # bf16 operands summed in f32, then one rounding of the logits to
        # the model's dtype.
        h2 = h.to(self.dtype).reshape(-1, h.shape[-1])
        logits = _mm_f32(h2, table.to(self.dtype).t()).to(self.dtype)
        return logits.reshape(*h.shape[:-1], -1)

    def cache_shape(self, batch: int, total: int) -> tuple[int, ...]:
        return (self.num_layers, batch, total, self.num_heads, self.head_dim)
