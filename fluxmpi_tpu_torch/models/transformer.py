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

Cached decoding: :meth:`TransformerLM.forward` with ``kv_cache=(k, v)``
(``[layers, batch, max_len, heads, head_dim]`` each) feeds one token per
row at that row's own position ``pos_offset`` (``[batch]``), writes the
new K/V into the cache in place, and attends to positions
``<= pos_offset`` of its row. Decoding is inference: it runs without
autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..errors import refuse_unported
from ..ops.flash_attention import flash_attention
from ..ops.fused_ce import _mm_f32, unembed_cross_entropy
from ..runtime import resolve_device

# EncoderBlock and TransformerEncoder are the LM's building blocks (they
# take the LM's initializer); the JAX package's standalone encoder model is
# not ported.
__all__ = ["TransformerLM"]


def _resolve_attention_mode(mode: str, device: torch.device) -> str:
    if mode == "auto":
        return "flash" if device.type == "cuda" else "naive"
    if mode not in ("naive", "flash"):
        raise ValueError(
            f"attention must be 'naive', 'flash', or 'auto'; got {mode!r}"
        )
    return mode


class _Init:
    """Explicit-generator initializers (flax's defaults in kind: normal
    kernels scaled by ``1/sqrt(fan_in)``, zero biases, unit LN scales).
    Draws on the CPU generator and copies to the device, so one seed gives
    the same weights on every device."""

    def __init__(self, device, generator):
        self.device = device
        self.generator = generator

    def normal(self, shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.generator)
        return nn.Parameter(t.to(self.device))

    def fill(self, shape, value):
        return nn.Parameter(
            torch.full(shape, value, dtype=torch.float32, device=self.device)
        )


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` of shape ``[in, *out]`` or
    ``[*in, out]``; ``in_dims`` counts the trailing input axes contracted."""

    def __init__(self, kernel_shape, bias_shape, init: _Init, fan_in: int,
                 in_dims: int = 1):
        super().__init__()
        self.kernel = init.normal(kernel_shape, 1.0 / math.sqrt(fan_in))
        self.bias = init.fill(bias_shape, 0.0)
        self.in_dims = in_dims

    def forward(self, x, dtype):
        lead = x.shape[: x.ndim - self.in_dims]
        n_in = math.prod(self.kernel.shape[: self.in_dims])
        w = self.kernel.to(dtype).reshape(n_in, -1)
        y = x.to(dtype).reshape(-1, n_in) @ w + self.bias.to(dtype).reshape(-1)
        return y.reshape(*lead, *self.kernel.shape[self.in_dims:])


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, init: _Init):
        super().__init__()
        self.scale = init.fill((d,), 1.0)
        self.bias = init.fill((d,), 0.0)
        self.eps = eps

    def forward(self, x, dtype):
        # In f32 whatever the parameters' dtype (flax promotes the stats,
        # scale and bias to f32), then cast.
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, init: _Init):
        super().__init__()
        hd = d_model // num_heads
        self.num_heads = num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, Dense((d_model, num_heads, hd),
                                        (num_heads, hd), init, d_model))
        self.out = Dense((num_heads, hd, d_model), (d_model,), init, d_model,
                         in_dims=2)

    def forward(self, x, *, mode, dtype, cache=None, pos=None, segments=None):
        """Causal self-attention over ``x [b, s, d]``; or, with ``cache``
        (this layer's ``(k, v)`` ``[b, T, h, hd]``), one decode position per
        row at ``pos [b]`` attending where ``segments = (q_seg [b, 1],
        kv_seg [b, T])`` allow. Returns ``(y, k, v)`` with the new K/V."""
        q = self.query(x, dtype)
        k = self.key(x, dtype)
        v = self.value(x, dtype)
        if cache is not None:
            kc, vc = cache
            rows = torch.arange(x.shape[0], device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            k_all, v_all = kc, vc
        else:
            k_all, v_all = k, v
        if mode == "flash":
            o = flash_attention(q, k_all, v_all, causal=cache is None,
                                segment_ids=segments)
        else:
            o = _dense_attention(q, k_all, v_all,
                                 None if segments is None else segments[1])
        return self.out(o, dtype), k, v


def _dense_attention(q, k, v, kv_seg=None):
    """flax's ``dot_product_attention`` under a causal mask (``kv_seg is
    None``) or a per-row valid-key mask (decode)."""
    dtype = q.dtype
    q = q / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.to(dtype))
    if kv_seg is None:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    else:
        mask = (kv_seg != 0)[:, None, None, :]
    s = torch.where(mask, s, torch.finfo(dtype).min)
    w = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(dtype))


class EncoderBlock(nn.Module):
    def __init__(self, d_model, num_heads, d_ff, *, ln_eps, init: _Init):
        super().__init__()
        self.ln1 = LayerNorm(d_model, ln_eps, init)
        self.attn = MultiHeadAttention(d_model, num_heads, init)
        self.ln2 = LayerNorm(d_model, ln_eps, init)
        self.ff1 = Dense((d_model, d_ff), (d_ff,), init, d_model)
        self.ff2 = Dense((d_ff, d_model), (d_model,), init, d_ff)

    def forward(self, x, *, mode, dtype, cache=None, pos=None, segments=None):
        h, k, v = self.attn(self.ln1(x, dtype), mode=mode, dtype=dtype,
                            cache=cache, pos=pos, segments=segments)
        x = x + h
        h = self.ff1(self.ln2(x, dtype), dtype)
        h = F.gelu(h, approximate="tanh")  # flax nn.gelu is the tanh form
        return x + self.ff2(h, dtype), k, v


class TransformerEncoder(nn.Module):
    """Pre-LN encoder stack over embedded inputs ``[b, s, d_model]``."""

    def __init__(self, num_layers, d_model, num_heads, d_ff, *, ln_eps,
                 init: _Init):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", EncoderBlock(
                d_model, num_heads, d_ff, ln_eps=ln_eps, init=init))
        self.ln_out = LayerNorm(d_model, ln_eps, init)

    def forward(self, x, *, mode, dtype, cache=None, pos=None, segments=None):
        """Returns ``(hidden, ks, vs)``: the final-LN output (f32) and each
        layer's new K/V."""
        ks, vs = [], []
        for i in range(self.num_layers):
            layer_cache = None
            if cache is not None:
                layer_cache = (cache[0][i], cache[1][i])
            x, k, v = getattr(self, f"block_{i}")(
                x, mode=mode, dtype=dtype, cache=layer_cache, pos=pos,
                segments=segments)
            ks.append(k)
            vs.append(v)
        return self.ln_out(x, torch.float32), ks, vs


class TransformerLM(nn.Module):
    """Token embedding + learned positions + encoder + weight-tied head.

    Weights are drawn from the CPU ``generator`` (default: a fresh
    ``torch.Generator`` seeded with 0) and live on ``device``
    (default CUDA; ``"cpu"`` only when asked). ``dropout`` is the
    attention dropout rate of the JAX module; training with it is not
    ported (see :meth:`forward`)."""

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
        refuse_unported("TransformerLM", {"attention_fn": attention_fn is not None,
                                          "decode": bool(decode)},
                        "pick the attention with attention=; cached decoding "
                        "is forward(kv_cache=...)")
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
        self.ln_eps = ln_eps
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = _Init(self.device, generator)
        self.embed = nn.Module()
        self.embed.embedding = init.normal((vocab_size, d_model),
                                           1.0 / math.sqrt(d_model))
        self.pos_embed = init.normal((max_len, d_model), 0.02)
        self.encoder = TransformerEncoder(num_layers, d_model, num_heads,
                                          d_ff, ln_eps=ln_eps, init=init)

    def attention_mode(self, override: str | None = None) -> str:
        return _resolve_attention_mode(override or self.attention, self.device)

    def forward(self, tokens, *, train: bool = True, targets=None,
                loss_chunk: int = 8192, hidden: bool = False,
                pos_offset=None, kv_cache=None, attention: str | None = None,
                return_kv: bool = False):
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

        ``train=True`` with ``dropout > 0`` raises: the JAX LM trains with
        attention dropout through flax's dense fallback and flax's random
        stream (``flash_attention_fn(dropout_impl="dense")``), which no
        port can reproduce.

        With ``kv_cache=(k, v)``: cached decoding, ``s == 1``; row ``i``'s
        token sits at position ``pos_offset[i]``, its K/V are written there
        in place, and it attends to cache positions ``<= pos_offset[i]``.
        ``attention`` overrides the model's switch for this call."""
        if kv_cache is not None:
            if targets is not None or hidden:
                raise ValueError("targets/hidden are training paths; "
                                 "kv_cache is inference")
            with torch.no_grad():
                return self._decode(tokens, pos_offset, kv_cache, attention)
        if train and self.dropout > 0:
            raise NotImplementedError(
                "training TransformerLM with dropout > 0 is not ported: the "
                "JAX LM then takes flax's dense attention fallback with "
                "flax's random stream (flash_attention_fn dropout_impl="
                "'dense'), which the port cannot reproduce; train with "
                "dropout=0.0, or call with train=False")
        if hidden and targets is not None:
            raise ValueError("pass either targets or hidden, not both")
        mode = self.attention_mode(attention)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"sequence length {s} exceeds max_len "
                             f"{self.max_len}")
        x = self.embed.embedding[tokens].to(self.dtype)
        x = x + self.pos_embed[:s][None].to(self.dtype)
        h, ks, vs = self.encoder(x, mode=mode, dtype=self.dtype)
        if hidden:
            return h, self.embed.embedding
        if targets is not None:
            targets = torch.as_tensor(targets, device=self.device)
            return unembed_cross_entropy(h.to(self.dtype), self.embed.embedding,
                                         targets, chunk=loss_chunk)
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
        h, _, _ = self.encoder(x, mode=mode, dtype=self.dtype, cache=kv_cache,
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
