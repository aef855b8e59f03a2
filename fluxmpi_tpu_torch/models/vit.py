"""Vision Transformer: patch-embedded images through the encoder stack.

Counterpart of :mod:`fluxmpi_tpu.models.vit`: the patches are one strided
``"VALID"`` convolution with a bias (``patch x patch``, stride ``patch``),
a zero-initialised ``cls`` token is prepended, learned position
embeddings (normal, 0.02) are added, the
:class:`~fluxmpi_tpu_torch.models.TransformerEncoder` runs (its
``attention_fn`` hook takes
:func:`~fluxmpi_tpu_torch.ops.flash_attention_fn`), and an f32 ``head``
reads the CLS token. ``dtype=torch.bfloat16`` computes in bf16 with f32
parameters. Names and layouts are flax's (``patch_embed.kernel`` HWIO,
``encoder.block_0.attn.query.kernel``, ``cls``, ``pos_embed``,
``head.kernel``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .. import _batch_parallel
from ..runtime import note_graph_generator, resolve_device
from ._layers import Conv, Dense, _Init
from .transformer import TransformerEncoder

__all__ = ["ViT"]


def _dropout(x: torch.Tensor, rate: float, rng: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` in training: each element kept with
    probability ``1 - rate`` (an independent draw from ``rng``, a
    ``torch.Generator`` on ``x``'s device) and divided by it, the rest
    zero. The generator is noted for CUDA-graph windows. Under the step's
    batch axes the draw is the global batch's, and this worker keeps its
    rows (:func:`~fluxmpi_tpu_torch._batch_parallel.draw`)."""
    note_graph_generator(rng)
    keep_prob = 1.0 - rate
    keep = _batch_parallel.draw(
        lambda s: torch.rand(s, generator=rng, device=x.device), x.shape) < keep_prob
    # Device fills, not host copies: a CUDA-graph capture takes no copy.
    return torch.where(keep, x / torch.full((), keep_prob, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class ViT(nn.Module):
    """ViT classifier over NHWC images (defaults: ViT-S/16 widths).

    A torch module is built with its shapes, where flax infers them at the
    first call: ``in_features`` (image channels) and ``image_size`` (the
    side of the square images, which sets the position table's length,
    ``(image_size / patch)**2 + 1``). ``forward(x, *, train=True)`` returns
    f32 logits ``[b, num_classes]``. ``dropout > 0`` in training needs
    ``dropout_rng``, a ``torch.Generator`` on the model's device (flax's
    ``rngs={"dropout": key}``), and drops as flax does: the embeddings
    (``nn.Dropout``: every element kept with probability ``1 - dropout``
    and scaled by its inverse) and, in the encoder's dense attend, the
    attention weights (:func:`~fluxmpi_tpu_torch.models._layers.dot_product_attention`;
    an ``attention_fn`` such as ``flash_attention_fn`` gets the mask alone
    under flax's keyword filter and does not drop). Equal to flax in law,
    not bit for bit: flax's random stream cannot be reproduced. A CUDA
    generator is noted for CUDA-graph windows, so each replay draws fresh
    masks. Weights from the CPU ``generator`` (default seeded with 0) on
    ``device`` (default CUDA; ``"cpu"`` only when asked)."""

    def __init__(self, num_classes: int = 1000, patch: int = 16, num_layers: int = 12,
                 d_model: int = 384, num_heads: int = 6, d_ff: int = 1536,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None, *, in_features: int = 3,
                 image_size: int = 224, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"patch size {patch} must divide the image size "
                             f"{(image_size, image_size)}")
        self.device = resolve_device(device)
        generator = generator or torch.Generator().manual_seed(0)
        init = _Init(self.device, generator)
        self.patch, self.d_model, self.dtype = patch, d_model, dtype
        self.dropout, self.image_size = float(dropout), image_size
        self.patch_embed = Conv(in_features, d_model, (patch, patch), (patch, patch),
                                init=init, dtype=dtype, padding="VALID", use_bias=True)
        self.cls = init.fill((1, 1, d_model), 0.0)
        tokens = (image_size // patch) ** 2 + 1
        self.pos_embed = init.normal((1, tokens, d_model), 0.02)
        self.encoder = TransformerEncoder(num_layers, d_model, num_heads, d_ff, dropout,
                                          dtype, attention_fn, device=self.device,
                                          generator=generator)
        self.head = Dense((d_model, num_classes), (num_classes,), init, d_model)

    def forward(self, x, *, train: bool = True,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        b, h, w, _ = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"this ViT was built for {self.image_size}x"
                             f"{self.image_size} images, got {h}x{w}")
        drop = train and self.dropout > 0
        if drop and dropout_rng is None:
            raise ValueError(
                "training ViT with dropout > 0 needs dropout_rng (a "
                "torch.Generator on the model's device), as the JAX ViT needs "
                "rngs={'dropout': key}; or call with train=False")
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.d_model)  # [b, tokens, d]
        cls = self.cls.expand(b, 1, self.d_model).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        if drop:
            x = _dropout(x, self.dropout, dropout_rng)
        x = self.encoder(x, train=train, dropout_rng=dropout_rng)
        # CLS-token head in f32.
        return self.head(x[:, 0], torch.float32)
