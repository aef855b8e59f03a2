"""Native input-pipeline runtime (C++ thread-pool gather + prefetch).

Counterpart of :mod:`fluxmpi_tpu.io`, with its own copy of the C++
source."""

from .native import NativePrefetcher, gather_rows, native_available

__all__ = ["NativePrefetcher", "gather_rows", "native_available"]
