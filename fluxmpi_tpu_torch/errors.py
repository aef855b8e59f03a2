"""Exceptions raised by the port (the subset of ``fluxmpi_tpu.errors``
that the ported modules raise)."""

from __future__ import annotations

__all__ = ["CheckpointDesyncError", "CheckpointTimeoutError",
           "CollectiveError", "FaultInjectedError",
           "FluxMPINotInitializedError", "RequestRejectedError",
           "TopologyMismatchError"]


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

    def __init__(self, reject_reason: str | None) -> None:
        self.reject_reason = reject_reason
        super().__init__(f"request rejected ({reject_reason})")


def refuse_unported(fn: str, passed: dict, why: str = "") -> None:
    """Raise ``NotImplementedError`` naming the arguments in ``passed``
    (name -> whether the caller set it) that ``fn`` takes in the JAX
    package but the port does not implement yet."""
    names = sorted(name for name, given in passed.items() if given)
    if names:
        raise NotImplementedError(
            f"{fn}({', '.join(names)}=...) is not ported yet"
            + (f": {why}" if why else ""))


class FaultInjectedError(RuntimeError):
    """Raised by :mod:`fluxmpi_tpu_torch.faults` when an armed fault
    schedule fires at a named site: the synthetic analogue of a transient
    I/O error or a killed fetch. Checkpoint write retries treat it like an
    ``OSError``, so chaos tests exercise the production path."""

    def __init__(self, site: str, hit: int, spec: str = "") -> None:
        self.site = site
        self.hit = hit
        super().__init__(
            f"fault injected at site {site!r} (hit {hit})"
            + (f" by schedule entry {spec!r}" if spec else "")
        )


class CheckpointTimeoutError(RuntimeError):
    """A wait on a background checkpoint save outlived the hard deadline
    set by ``FLUXMPI_TPU_CKPT_TIMEOUT``."""


class CheckpointDesyncError(RuntimeError):
    """The workers disagree on the step being checkpointed: banking the
    save would mix states from different steps, so it is aborted."""


class TopologyMismatchError(ValueError):
    """Raised when an elastic restore cannot lay a checkpointed leaf out
    over the current world: a partition axis named by the saved (or
    supplied) partition spec is absent, or the leaf dimension it shards
    is not divisible by the new axis size. The message names the leaf
    path, the offending dimension or axis, and both topologies."""
