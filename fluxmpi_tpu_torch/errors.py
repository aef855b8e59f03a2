"""Exceptions raised by the port (the subset of ``fluxmpi_tpu.errors``
that the ported modules raise)."""

from __future__ import annotations

__all__ = ["CollectiveError", "FluxMPINotInitializedError",
           "RequestRejectedError"]


class FluxMPINotInitializedError(RuntimeError):
    """A rank/world query or a collective before
    :func:`fluxmpi_tpu_torch.init`: the runtime must be brought up first."""

    def __init__(self, message: str | None = None) -> None:
        super().__init__(
            message
            or "fluxmpi_tpu_torch has not been initialized. Call "
            "`fluxmpi_tpu_torch.init()` before querying `local_rank()` / "
            "`total_workers()` or using collectives."
        )


class CollectiveError(RuntimeError):
    """A collective that could not be run: an unsupported leaf, or a
    failure inside ``torch.distributed``."""


class RequestRejectedError(RuntimeError):
    """A serving request the engine refused or abandoned: a full queue, a
    drain, or a shutdown. ``reject_reason`` carries the engine's reason
    string."""

    def __init__(self, reason: str | None):
        self.reject_reason = reason
        super().__init__(f"request rejected: {reason}")
