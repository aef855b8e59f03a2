"""Rank-aware, timestamped printing.

Counterpart of :mod:`fluxmpi_tpu.logging` (the reference's
``fluxmpi_print``/``fluxmpi_println``): before :func:`init`, a
timestamp-only prefix; a single worker prints plainly; in a larger world
each line carries the timestamp and ``[rank / size]``, and the ranks print
in turn with a barrier between turns. Host IO only.
"""

from __future__ import annotations

import datetime
import sys
from typing import Any

import torch.distributed as dist

from .runtime import is_initialized, process_count, process_index

__all__ = ["fluxmpi_print", "fluxmpi_println"]


def _now() -> str:
    return datetime.datetime.now().isoformat(sep=" ", timespec="milliseconds")


def _rank_print(*args: Any, end: str, **kwargs: Any) -> None:
    if not is_initialized():
        print(f"{_now()} ", *args, end=end, **kwargs)
        return
    rank, size = process_index(), process_count()
    if size == 1:
        print(*args, end=end, **kwargs)
        return
    for r in range(size):
        if r == rank:
            print(f"{_now()} [{rank} / {size}] ", *args, end=end, **kwargs)
            sys.stdout.flush()
        dist.barrier()


def fluxmpi_print(*args: Any, **kwargs: Any) -> None:
    """Print with a timestamp and ``[rank / size]`` prefix, serialized
    across processes."""
    _rank_print(*args, end=kwargs.pop("end", ""), **kwargs)


def fluxmpi_println(*args: Any, **kwargs: Any) -> None:
    """:func:`fluxmpi_print` with a trailing newline."""
    _rank_print(*args, end=kwargs.pop("end", "\n"), **kwargs)
