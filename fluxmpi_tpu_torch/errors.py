"""Exceptions raised by the port (the subset of ``fluxmpi_tpu.errors``
that serving raises)."""

from __future__ import annotations

__all__ = ["RequestRejectedError"]


class RequestRejectedError(RuntimeError):
    """A serving request the engine refused or abandoned: a full queue, a
    drain, or a shutdown. ``reject_reason`` carries the engine's reason
    string."""

    def __init__(self, reason: str | None):
        self.reject_reason = reason
        super().__init__(f"request rejected: {reason}")
