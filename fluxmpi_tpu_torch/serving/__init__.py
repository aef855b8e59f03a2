"""Serving: the paged KV cache, the continuous-batching engine with its
plane (fleet defaults, background serving, preemption drain, SLOs) and
the request-observability plane (counterpart of
:mod:`fluxmpi_tpu.serving`)."""

from .cache import TRASH_BLOCK, BlockKVCache, blocks_for_tokens
from .engine import (InferenceEngine, ServingConfig, ServingRequest, configure,
                     enabled, get_engine, set_engine, shutdown)
from .observe import (RequestLog, RequestObserver, SLOBurnTracker,
                      get_request_observer, set_request_observer)

__all__ = [
    "BlockKVCache",
    "blocks_for_tokens",
    "InferenceEngine",
    "ServingConfig",
    "ServingRequest",
    "RequestLog",
    "RequestObserver",
    "SLOBurnTracker",
    "TRASH_BLOCK",
    "configure",
    "enabled",
    "get_engine",
    "get_request_observer",
    "set_engine",
    "set_request_observer",
    "shutdown",
]
