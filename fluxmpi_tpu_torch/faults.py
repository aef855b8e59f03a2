"""Deterministic fault injection: chaos testing with named sites.

Counterpart of :mod:`fluxmpi_tpu.faults`, with the same site names and
schedule grammar, so a schedule means the same thing in both packages. A
schedule of :class:`FaultSpec` entries is armed against **named sites**
woven into the port's code paths:

====================  =====================================================
site                  where it fires in the port
====================  =====================================================
``data.fetch``        each :class:`~fluxmpi_tpu_torch.DistributedDataLoader`
                      batch, after the host assembles it (hit N is batch
                      N of the pass with ``prefetch=0``)
``ckpt.write``        each checkpoint write **attempt** (inside the retry
                      loop: ``times=2`` exercises two retries, then success)
``ckpt.manifest``     between the checkpoint rename and the manifest write
``ckpt.commit``       between the manifest write and the commit marker
``ckpt.read``         :func:`~fluxmpi_tpu_torch.utils.restore_checkpoint`
``ckpt.snapshot``     the host copy a checkpoint save takes on the caller's
                      thread
``ckpt.async_write``  each background-writer save
``comm.*``            each collective of :mod:`~fluxmpi_tpu_torch.comm`
                      (``allreduce``, ``bcast``, ``reduce``, ``barrier``,
                      ``host_allreduce``, ``host_allgather``,
                      ``host_bcast``; ``iallreduce`` and ``ibcast`` hit
                      ``comm.allreduce`` and ``comm.bcast``), before it runs
====================  =====================================================

The other names of :data:`KNOWN_SITES` are the JAX package's sites
(elastic resize, serving); the port does not weave them yet, and a
schedule naming them never fires.

A firing site raises :class:`~fluxmpi_tpu_torch.errors.FaultInjectedError`,
or, for a ``delay=`` entry, sleeps that many seconds and continues.

**Schedule grammar** (via :func:`install` / :func:`configure` or the
``FLUXMPI_TPU_FAULTS`` environment variable); comma-separated entries::

    entry := site[@step=N][:key=value]*
    keys  := step   fire at the Nth hit of the site (1-based; ``@step=N``
                    is sugar for ``:step=N``)
             p      fire each hit with probability p (seeded; see seed)
             seed   RNG seed for ``p`` draws (default 0; the stream is
                    seeded (seed, process_index))
             times  cap on injections for this entry (default 1 for
                    step/bare entries, unlimited for ``p`` entries)
             proc   only fire on this process index
             delay  stall ``delay`` seconds instead of raising

**Determinism**: every site keeps a monotonic hit counter; the same
schedule and the same execution give the same injections. :func:`clear`
resets schedule and counters. Call sites guard on :data:`ARMED`, one
attribute read, so with nothing armed a site costs nothing else.

Each injection is counted in ``fault.injected{site}`` in the default
telemetry registry and lands as a ``fault.injected`` trace instant.
"""

from __future__ import annotations

import difflib
import os
import time
import warnings
from typing import Any, Iterable

import numpy as np

from . import runtime as _runtime
from .errors import FaultInjectedError
from .telemetry import get_registry as _telemetry_registry
from .telemetry import tracing as _tracing

__all__ = [
    "ARMED",
    "FaultInjectedError",
    "FaultSpec",
    "KNOWN_SITES",
    "active",
    "check",
    "clear",
    "configure",
    "injected_count",
    "install",
    "parse_spec",
    "register_site",
    "registered_sites",
    "scope",
]

_ENV_VAR = "FLUXMPI_TPU_FAULTS"

# The JAX package's site registry, copied as it is so that names keep
# their meaning across the two packages.
KNOWN_SITES = frozenset(
    {
        "comm.allreduce",
        "comm.bcast",
        "comm.reduce",
        "comm.barrier",
        "comm.host_allreduce",
        "comm.host_allgather",
        "comm.host_bcast",
        "data.fetch",
        "ckpt.write",
        "ckpt.manifest",
        "ckpt.commit",
        "ckpt.read",
        "ckpt.snapshot",
        "ckpt.async_write",
        "elastic.restore",
        "resize.drain",
        "resize.reshard",
        "serving.admit",
        "serving.decode",
    }
)

_extra_sites: set[str] = set()


def _process_index() -> int:
    return _runtime.process_index() if _runtime.is_initialized() else 0


def register_site(site: str) -> str:
    """Register a user-woven fault site so schedules naming it pass
    validation. Returns the site."""
    if not site or not isinstance(site, str):
        raise ValueError(f"fault site must be a non-empty string, got {site!r}")
    _extra_sites.add(site)
    return site


def registered_sites() -> frozenset[str]:
    """Every valid schedule site: :data:`KNOWN_SITES` plus
    :func:`register_site` additions."""
    return KNOWN_SITES | _extra_sites


def _validate_sites(specs: "list[FaultSpec]", *, strict: bool) -> None:
    """Reject (``strict``) or warn about entries naming unregistered
    sites, which could never fire."""
    sites = registered_sites()
    for spec in specs:
        if spec.site in sites:
            continue
        close = difflib.get_close_matches(spec.site, sites, n=1)
        hint = f"; nearest registered site: {close[0]!r}" if close else ""
        message = (
            f"unknown fault site {spec.site!r} in schedule entry "
            f"{spec!s}{hint} — the entry can never fire; see "
            f"faults.KNOWN_SITES, or faults.register_site() for "
            f"user-woven sites"
        )
        if strict:
            raise ValueError(message)
        warnings.warn(message, stacklevel=3)


# True iff a schedule is installed: the one attribute a woven site reads.
ARMED = False


class FaultSpec:
    """One schedule entry: a site and its firing condition. Carries its
    own injection count and RNG stream."""

    def __init__(
        self,
        site: str,
        *,
        step: int | None = None,
        p: float | None = None,
        seed: int = 0,
        times: int | None = None,
        proc: int | None = None,
        delay: float | None = None,
    ):
        if not site or not isinstance(site, str):
            raise ValueError(f"fault site must be a non-empty string, got {site!r}")
        if step is not None and step < 1:
            raise ValueError(f"step must be >= 1 (1-based hit index), got {step}")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        if step is not None and p is not None:
            raise ValueError("step= and p= are mutually exclusive triggers")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        if delay is not None and delay <= 0:
            raise ValueError(f"delay must be > 0 seconds, got {delay}")
        self.site = site
        self.step = step
        self.p = p
        self.seed = int(seed)
        self.delay = float(delay) if delay is not None else None
        # Bare/step entries default to one injection (a crash),
        # probability entries to unlimited (a flaky medium).
        self.times = times if times is not None else (None if p is not None else 1)
        self.proc = proc
        self.injected = 0
        self._rng = (
            np.random.default_rng([self.seed, _process_index()])
            if p is not None
            else None
        )

    def should_fire(self, hit: int) -> bool:
        if self.proc is not None and _process_index() != self.proc:
            return False
        if self.times is not None and self.injected >= self.times:
            return False
        if self.step is not None:
            return hit >= self.step
        if self.p is not None:
            return float(self._rng.random()) < self.p
        return True

    def __str__(self) -> str:
        parts = [self.site]
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.p is not None:
            parts.append(f"p={self.p}")
            parts.append(f"seed={self.seed}")
        if self.times is not None:
            parts.append(f"times={self.times}")
        if self.proc is not None:
            parts.append(f"proc={self.proc}")
        if self.delay is not None:
            parts.append(f"delay={self.delay:g}")
        return ":".join(parts)

    __repr__ = __str__


def parse_spec(entry: str) -> FaultSpec:
    """Parse one schedule entry (``site[@step=N][:key=value]*``)."""
    entry = entry.strip()
    if not entry:
        raise ValueError("empty fault schedule entry")
    head, _, rest = entry.partition(":")
    site, _, at = head.partition("@")
    kwargs: dict[str, Any] = {}
    tokens = ([at] if at else []) + ([t for t in rest.split(":") if t] if rest else [])
    for tok in tokens:
        key, eq, value = tok.partition("=")
        if not eq:
            raise ValueError(
                f"bad fault modifier {tok!r} in {entry!r}: expected key=value"
            )
        key = key.strip()
        if key in ("step", "times", "proc", "seed"):
            kwargs[key] = int(value)
        elif key in ("p", "delay"):
            kwargs[key] = float(value)
        else:
            raise ValueError(
                f"unknown fault modifier {key!r} in {entry!r}; expected one "
                f"of step/p/seed/times/proc/delay"
            )
    return FaultSpec(site.strip(), **kwargs)


class _Schedule:
    """Installed specs grouped by site, plus the per-site hit counters."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs
        self.by_site: dict[str, list[FaultSpec]] = {}
        for s in specs:
            self.by_site.setdefault(s.site, []).append(s)
        self.hits: dict[str, int] = {}
        self.injected = 0


_active: _Schedule | None = None
_configured_spec: str | None = None  # the string spec configure() installed


def _coerce(spec: Any) -> list[FaultSpec]:
    if isinstance(spec, FaultSpec):
        return [spec]
    if isinstance(spec, str):
        return [parse_spec(e) for e in spec.split(",") if e.strip()]
    if isinstance(spec, Iterable):
        out: list[FaultSpec] = []
        for s in spec:
            out.extend(_coerce(s))
        return out
    raise ValueError(
        f"fault schedule must be a spec string, a FaultSpec, or an "
        f"iterable of those; got {spec!r}"
    )


def install(
    spec: Any, *, append: bool = False, allow_unknown: bool = False
) -> list[FaultSpec]:
    """Arm a fault schedule (replacing any current one unless ``append``):
    a grammar string, a :class:`FaultSpec`, or a list of those. Hit
    counters reset on replace and persist on append. An entry naming an
    unregistered site raises ``ValueError`` before anything is armed,
    unless ``allow_unknown``."""
    global _active, ARMED, _configured_spec
    specs = _coerce(spec)
    if not allow_unknown:
        _validate_sites(specs, strict=True)
    _configured_spec = None
    if append and _active is not None:
        merged = _Schedule(_active.specs + specs)
        merged.hits = _active.hits
        merged.injected = _active.injected
        _active = merged
    else:
        _active = _Schedule(specs) if specs else None
    ARMED = _active is not None
    return specs


def clear() -> None:
    """Disarm: drop the schedule and every hit counter (idempotent)."""
    global _active, ARMED, _configured_spec
    _active = None
    ARMED = False
    _configured_spec = None


def active() -> list[FaultSpec]:
    """The armed specs (empty when off)."""
    return list(_active.specs) if _active is not None else []


def injected_count() -> int:
    """Total injections fired by the current schedule."""
    return _active.injected if _active is not None else 0


def configure(spec: Any = None) -> list[FaultSpec]:
    """Wire the schedule from one value: ``None`` reads
    ``FLUXMPI_TPU_FAULTS`` (no-op when unset or empty); ``False``, ``""``
    or ``"0"`` disarms; anything else is installed (unknown sites warn
    instead of raising). Installing the same schedule again keeps the
    live hit counters."""
    global _configured_spec
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return active()
    if spec is False or spec == "0" or spec == "":
        clear()
        return []
    specs = _coerce(spec)
    canon = ",".join(str(s) for s in specs)
    if _active is not None and canon == _configured_spec:
        return active()
    _validate_sites(specs, strict=False)
    install(specs, allow_unknown=True)
    _configured_spec = canon
    return active()


def _record(site: str, hit: int, spec: FaultSpec) -> None:
    try:
        reg = _telemetry_registry()
        if reg.enabled:
            reg.counter("fault.injected", site=site).inc()
        _tracing.get_tracer().instant(
            "fault.injected", site=site, hit=hit, spec=str(spec)
        )
    except Exception:  # instrumentation must never mask the injection
        pass


def check(site: str) -> None:
    """Count a hit at ``site`` and, when a spec fires, raise
    :class:`FaultInjectedError` (or stall, for a ``delay=`` spec). Call
    sites guard with ``if faults.ARMED:``."""
    sched = _active
    if sched is None:
        return
    hit = sched.hits.get(site, 0) + 1
    sched.hits[site] = hit
    for spec in sched.by_site.get(site, ()):
        if spec.should_fire(hit):
            spec.injected += 1
            sched.injected += 1
            _record(site, hit, spec)
            if spec.delay is not None:
                time.sleep(spec.delay)
                continue  # a stall is not a crash: later specs still run
            raise FaultInjectedError(site, hit, str(spec))


class scope:
    """Context manager arming ``spec`` on entry and restoring the previous
    schedule on exit::

        with faults.scope("data.fetch@step=7"):
            with pytest.raises(faults.FaultInjectedError):
                train_loop(...)
    """

    def __init__(self, spec: Any):
        self.spec = spec
        self._saved: _Schedule | None = None
        self._saved_spec: str | None = None

    def __enter__(self) -> "scope":
        global _active
        specs = _coerce(self.spec)  # validate before touching armed state
        _validate_sites(specs, strict=True)
        self._saved = _active
        self._saved_spec = _configured_spec
        _active = None
        install(specs, allow_unknown=True)
        return self

    def __exit__(self, *exc: Any) -> None:
        global _active, ARMED, _configured_spec
        _active = self._saved
        ARMED = _active is not None
        _configured_spec = self._saved_spec
        self._saved = None
        self._saved_spec = None
