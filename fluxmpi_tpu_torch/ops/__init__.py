"""Kernels of the port and their plain PyTorch versions."""

from .flash_attention import (
    device_launches,
    dropout_keep_reference,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_fn,
    flash_attention_reference,
    flash_attention_with_lse,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    padding_to_segment_ids,
)
from .fused_ce import (tp_unembed_cross_entropy, unembed_cross_entropy,
                       unembed_cross_entropy_reference)

__all__ = ["device_launches", "dropout_keep_reference", "flash_attention",
           "flash_attention_bwd_reference", "flash_attention_fn",
           "flash_attention_reference",
           "flash_attention_with_lse", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fwd", "padding_to_segment_ids", "tp_unembed_cross_entropy",
           "unembed_cross_entropy",
           "unembed_cross_entropy_reference"]
