"""Models of the port."""

from .convert import load_flax_params, to_flax_params
from .generate import generate, prefill_cache, prefill_kv
from .mlp import MLP
from .transformer import TransformerLM

__all__ = ["MLP", "TransformerLM", "generate", "load_flax_params", "prefill_cache", "prefill_kv",
           "to_flax_params"]
