"""Kernels of the port and their plain PyTorch versions."""

from .flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
    flash_fwd,
    padding_to_segment_ids,
)

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_with_lse", "flash_fwd", "padding_to_segment_ids"]
