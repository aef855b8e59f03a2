"""Serving: paged KV cache and the continuous-batching engine."""

from .cache import TRASH_BLOCK, BlockKVCache, blocks_for_tokens
from .engine import InferenceEngine, ServingRequest

__all__ = ["BlockKVCache", "InferenceEngine", "ServingRequest", "TRASH_BLOCK",
           "blocks_for_tokens"]
