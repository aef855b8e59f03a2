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

Cached decoding: :meth:`TransformerLM.forward` with ``kv_cache=(k, v)``
(``[layers, batch, max_len, heads, head_dim]`` each) feeds one token per
row at that row's own position ``pos_offset`` (``[batch]``), writes the
new K/V into the cache in place, and attends to positions
``<= pos_offset`` of its row. Decoding is inference: it runs without
autograd.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .. import _tensor_parallel as _tp
from ..errors import refuse_unported
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


def _refuse_decode(name: str, decode: bool) -> None:
    refuse_unported(name, {"decode": bool(decode)},
                    "cached decoding is TransformerLM.forward(kv_cache=...)")


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
    ``decode=True`` is refused: the
    port decodes through :meth:`TransformerLM.forward`'s ``kv_cache=``.
    Weights from the CPU ``generator`` (default seeded with 0) on
    ``device`` (default CUDA)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, attention_fn: Callable | None = None,
                 decode: bool = False, attention: str = "naive",
                 attention_causal: bool = False, ln_eps: float = 1e-6, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        _refuse_decode("EncoderBlock", decode)
        self.device = resolve_device(device)
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

    def make_ff(self) -> nn.Module | None:
        """Hook: a module for the feed-forward sublayer, or ``None`` for
        the dense MLP (its weights may draw from ``self._init``, the
        block's initializer, while it is built)."""
        return None

    def forward(self, x, *, train: bool = True, mask=None, dropout_rng=None,
                losses=None):
        return self.run(x, train=train, mask=mask, dropout_rng=dropout_rng,
                        losses=losses)[0]

    def run(self, x, *, train=True, mask=None, mode=None, cache=None, pos=None,
            segments=None, dropout_rng=None, losses=None):
        """The block with the attention ``mode`` (default the block's own:
        ``"flash"``, ``"fn"`` for its ``attention_fn``, ``"naive"``).
        With ``cache`` (this layer's ``(k, v)`` ``[b, T, h, hd]``), one
        decode position per row at ``pos [b]``, written into the cache in
        place, attending where ``segments = (q_seg [b, 1], kv_seg [b, T])``
        allow. Returns ``(y, k, v)`` with the new K/V.

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
            kc, vc = cache
            rows = torch.arange(x.shape[0], device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            if mode == "flash":
                o = flash_attention(q, kc, vc, segment_ids=segments)
            else:  # the row's valid cache prefix
                o = dot_product_attention(q, kc, vc, mask=(segments[1] != 0)[:, None, None, :])
        elif mode == "flash":
            o = flash_attention_fn(causal=self.attention_causal)(q, k, v, mask=mask)
        else:
            fn = self.attention_fn if mode == "fn" else dot_product_attention
            o = self.attn.attend(fn, q, k, v, mask=mask, deterministic=not train,
                                 dropout_rng=dropout_rng)
        if heads_split:
            x = x + (tp.reduce(attn.out(o, self.dtype, bias=False))
                     + attn.out.bias.to(self.dtype))
        else:
            x = x + attn.out(o, self.dtype)
        h = self.ln2(x, self.dtype)
        if self.ff_name is not None:
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
        _refuse_decode("TransformerEncoder", decode)
        self.device = resolve_device(device)
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
                            self.dtype, self.attention_fn, False, self.attention,
                            self.attention_causal, self.ln_eps, device=self.device,
                            generator=self._generator)

    def forward(self, x, *, train: bool = True, mask=None, dropout_rng=None,
                losses=None):
        return self.run(x.to(self.dtype), train=train, mask=mask,
                        dropout_rng=dropout_rng, losses=losses)[0]

    def run(self, x, *, train=True, mask=None, mode=None, cache=None, pos=None,
            segments=None, dropout_rng=None, losses=None):
        """The stack (arguments as :meth:`EncoderBlock.run`, ``cache`` the
        ``(k, v)`` of every layer, ``losses`` the stack's sub-dict of the
        sowed-losses collection). Returns ``(hidden, ks, vs)``: the
        final-LN output (f32) and each layer's new K/V."""
        ks, vs = [], []
        for i in range(self.num_layers):
            layer_cache = None if cache is None else (cache[0][i], cache[1][i])
            x, k, v = getattr(self, f"block_{i}").run(
                x, train=train, mask=mask, mode=mode, cache=layer_cache, pos=pos,
                segments=segments, dropout_rng=dropout_rng,
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
    raises."""

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
        _refuse_decode("TransformerLM", decode)
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
            self.dtype, self.attention_fn, attention=self.attention,
            attention_causal=True, ln_eps=self.ln_eps, device=self.device,
            generator=self._generator)

    def attention_mode(self, override: str | None = None) -> str:
        return _resolve_attention_mode(override or self.attention, self.device)

    def forward(self, tokens, *, train: bool = True, targets=None,
                loss_chunk: int = 8192, hidden: bool = False,
                pos_offset=None, kv_cache=None, attention: str | None = None,
                return_kv: bool = False, dropout_rng=None, losses=None):
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

        ``losses``: a dict that collects what the layers sow (flax's
        ``mutable=["losses"]``), nested as flax nests the collection:
        ``losses["encoder"]["block_0"]["moe"]["moe_aux_loss"] = (x,)``
        (the MoE models; see
        :func:`~fluxmpi_tpu_torch.models.collect_moe_losses`)."""
        if kv_cache is not None:
            if targets is not None or hidden:
                raise ValueError("targets/hidden are training paths; "
                                 "kv_cache is inference")
            with torch.no_grad():
                return self._decode(tokens, pos_offset, kv_cache, attention)
        if train and self.dropout > 0 and dropout_rng is None:
            raise ValueError(
                "training TransformerLM with dropout > 0 needs dropout_rng (a "
                "torch.Generator on the model's device), as the JAX LM needs "
                "rngs={'dropout': key}; or call with train=False")
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

    def _decode(self, tokens, pos_offset, kv_cache, attention):
        mode = self.attention_mode(attention)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        if s != 1:
            raise ValueError(f"cached decoding feeds one token per row, "
                             f"got {s}")
        x = self.embed.embedding[tokens].to(self.dtype)
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
        h, _, _ = self.encoder.run(x, train=False, mode=mode, cache=kv_cache,
                                   pos=pos, segments=segments)
        return self._head(h)

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
