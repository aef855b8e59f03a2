"""Cross-host training monitor: device memory, stragglers, heartbeat
(counterpart of :mod:`fluxmpi_tpu.telemetry.monitor`).

The reference has nothing like this (its examples eyeball wall-clock
deltas per rank); across many processes the two questions that matter are "is a
host slow?" and "is a host *gone*?", and they need different signals:

- **straggler**: every host still participates in collectives, one of
  them late. Detected by aggregating per-host mean step time across
  processes (one :func:`fluxmpi_tpu_torch.comm.host_allgather` of the scalar,
  min/max/mean locally) and flagging ``max > threshold * mean``.
- **hung rank**: a host stopped participating entirely. A hung rank
  cannot be seen *through* a collective (the collective itself blocks),
  so detection is push-based: every host stamps a heartbeat gauge into
  its own flush stream each collect. A reader (or a human tailing the
  per-process JSONL files) distinguishes the cases by the stream itself:
  stale stream = hung; fresh stream with fat ``monitor.step_seconds_max``
  = slow.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np

from .registry import MetricsRegistry, get_registry

__all__ = ["TrainingMonitor"]


class TrainingMonitor:
    """Periodic collector of device memory stats and cross-host step-time
    aggregates, flushing the registry every ``interval`` observed steps.

    Usage — either hand it to the train-step factory::

        mon = TrainingMonitor(interval=20)
        step = make_train_step(loss_fn, opt, metrics=mon)

    or drive it manually: ``mon.observe_step(seconds)`` per step, or call
    :meth:`collect` on your own schedule.

    Args:
      registry: registry to record into (default: the global one, so the
        comm/data instrumentation lands in the same flush lines).
      interval: observed steps between automatic :meth:`collect` calls.
      cross_host: aggregate step times across controller processes. Every
        participating process must call :meth:`collect` the same number
        of times (it is a host collective) — the step-count cadence
        guarantees that in SPMD loops. Set False for loops where hosts
        can diverge.
      straggler_threshold: flag when the slowest host's mean step time
        exceeds this multiple of the cross-host mean.
      clock: wall-clock source for the heartbeat stamp and its staleness
        gauge (injectable — the watchdog's fake-clock test discipline).
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        interval: int = 50,
        cross_host: bool = True,
        straggler_threshold: float = 1.5,
        clock: Callable[[], float] = time.time,
    ):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.registry = registry if registry is not None else get_registry()
        self.interval = interval
        self.cross_host = cross_host
        self.straggler_threshold = straggler_threshold
        self._clock = clock
        self._window: list[float] = []
        self._since_collect = 0
        self._last_heartbeat: float | None = None

    @property
    def progress(self) -> int:
        """Monotonic collect counter — the watchdog's stall-detection
        source. Deliberately the *same* number as the
        ``monitor.heartbeat`` counter (one source of truth: a watchdog
        reading ``progress`` and a human tailing the JSONL heartbeat see
        the identical liveness signal). Use as a custom
        :class:`~fluxmpi_tpu_torch.telemetry.Watchdog` source:
        ``wd.add_source(lambda: mon.progress)``."""
        return int(self.registry.counter("monitor.heartbeat").value)

    def observe_step(self, seconds: float) -> dict[str, Any] | None:
        """Record one step's duration; every ``interval`` steps, collect
        and flush. Returns the collect summary on collecting ticks."""
        self._window.append(float(seconds))
        self._since_collect += 1
        if self._since_collect >= self.interval:
            return self.collect()
        return None

    # -- collection ----------------------------------------------------

    def _collect_memory(self) -> float | None:
        """Device + host memory gauges for this collect. Returns the
        local peak-HBM watermark when the device memory plane is on
        (``init(memory=True)`` — what :meth:`_aggregate_step_times`
        folds into its host gather), else None."""
        from . import memory as _memory

        local_peak: float | None = None
        if _memory.enabled():
            # One device walk: the memory plane's snapshot (closed
            # memory.* gauges + process watermark) also feeds the legacy
            # device.memory.* series below.
            snap = _memory.record_hbm(self.registry)
            local_peak = snap["local_peak_bytes"]
            device_stats = snap["devices"].items()
        else:
            device_stats = (
                (str(d.index if d.index is not None else i),
                 _memory.device_memory_stats(d))
                for i, d in enumerate(_memory._local_devices())
            )
        for dev, stats in device_stats:
            for key, val in stats.items():
                self.registry.gauge(
                    f"device.memory.{key}", device=dev
                ).set(val)
        # CPU (and some backends) report no per-device stats — the host
        # peak RSS keeps a memory signal in every stream regardless.
        try:
            import resource
            import sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss unit: bytes on darwin, kilobytes elsewhere.
            scale = 1.0 if sys.platform == "darwin" else 1024.0
            self.registry.gauge("host.memory.peak_rss_bytes").set(
                float(rss) * scale
            )
        except Exception:  # pragma: no cover - non-POSIX
            pass
        return local_peak

    def _aggregate_step_times(
        self, local_hbm_peak: float | None = None
    ) -> dict[str, float]:
        local_mean = sum(self._window) / len(self._window)

        # The run-health AND device planes ride the SAME gather: when
        # the goodput tracker / memory plane is enabled (env/init-
        # driven, hence SPMD-consistent — every process sends the same
        # vector width), each host's goodput fraction and peak-HBM
        # watermark travel next to its step time, and the cross-host
        # min/max/mean cost zero extra collectives.
        from . import goodput as _goodput

        gp = _goodput.get_goodput_tracker()
        local_goodput: float | None = None
        if gp.enabled:
            # Read the fraction directly (two attribute reads) — the
            # full report() would pay the device lookup + both MFU
            # computations per collect only to discard them.
            wall = gp.wall_seconds()
            local_goodput = (
                gp.bucket_seconds(_goodput.PRODUCTIVE_BUCKET) / wall
                if wall > 0
                else 0.0
            )
        # The fleet plane rides the SAME gather (env/init-driven like
        # the other riders, hence SPMD-consistent): each host's
        # cumulative collective block time and flight-recorder launch
        # sequence travel next to its step time, and the cross-host
        # skew ingredients (max − min) cost zero extra collectives.
        from . import fleet as _fleet

        local_comm: float | None = None
        local_seq: float | None = None
        if _fleet.enabled():
            total = 0.0
            for m in self.registry.snapshot():
                if m.get("name") == "comm.block_seconds":
                    total += float(m.get("sum", 0.0))
            local_comm = total
            from .flight_recorder import get_flight_recorder

            local_seq = float(get_flight_recorder().sequence)
        from .. import runtime

        nproc = runtime.process_count() if runtime.is_initialized() else 1
        if self.cross_host and nproc > 1:
            # ONE gather of the (1- to 5-wide) vector, statistics
            # locally — per-statistic host_allreduce calls would
            # multiply the blocking collective cost paid every interval.
            from ..comm import host_allgather

            payload = [local_mean]
            if local_goodput is not None:
                payload.append(local_goodput)
            if local_hbm_peak is not None:
                payload.append(local_hbm_peak)
            if local_comm is not None:
                payload.append(local_comm)
                payload.append(local_seq)
            gathered = np.asarray(host_allgather(np.float32(payload)))
            cols = gathered.reshape(nproc, -1)
            means = cols[:, 0]
            mn = float(means.min())
            mx = float(means.max())
            mean = float(means.mean())
            col = 1
            if local_goodput is not None:
                fracs = cols[:, col]
                col += 1
                gp_mn, gp_mx, gp_mean = (
                    float(fracs.min()),
                    float(fracs.max()),
                    float(fracs.mean()),
                )
            if local_hbm_peak is not None:
                peaks = cols[:, col]
                col += 1
                hbm_mn, hbm_mx, hbm_mean = (
                    float(peaks.min()),
                    float(peaks.max()),
                    float(peaks.mean()),
                )
            if local_comm is not None:
                comms = cols[:, col]
                seqs = cols[:, col + 1]
                comm_skew = float(comms.max() - comms.min())
                seq_lag = float(seqs.max() - seqs.min())
        else:
            mn = mx = mean = local_mean
            if local_goodput is not None:
                gp_mn = gp_mx = gp_mean = local_goodput
            if local_hbm_peak is not None:
                hbm_mn = hbm_mx = hbm_mean = local_hbm_peak
            if local_comm is not None:
                comm_skew = 0.0
                seq_lag = 0.0
        straggler = mean > 0 and mx > self.straggler_threshold * mean
        reg = self.registry
        reg.gauge("monitor.step_seconds_local_mean").set(local_mean)
        reg.gauge("monitor.step_seconds_min").set(mn)
        reg.gauge("monitor.step_seconds_max").set(mx)
        reg.gauge("monitor.step_seconds_mean").set(mean)
        reg.gauge("monitor.straggler").set(float(straggler))
        summary = {
            "step_seconds_local_mean": local_mean,
            "step_seconds_min": mn,
            "step_seconds_max": mx,
            "step_seconds_mean": mean,
            "straggler": straggler,
        }
        if local_goodput is not None:
            reg.gauge("monitor.goodput_fraction_min").set(gp_mn)
            reg.gauge("monitor.goodput_fraction_max").set(gp_mx)
            reg.gauge("monitor.goodput_fraction_mean").set(gp_mean)
            summary.update(
                goodput_fraction_min=gp_mn,
                goodput_fraction_max=gp_mx,
                goodput_fraction_mean=gp_mean,
            )
        if local_hbm_peak is not None:
            reg.gauge("monitor.hbm_peak_bytes_min").set(hbm_mn)
            reg.gauge("monitor.hbm_peak_bytes_max").set(hbm_mx)
            reg.gauge("monitor.hbm_peak_bytes_mean").set(hbm_mean)
            summary.update(
                hbm_peak_bytes_min=hbm_mn,
                hbm_peak_bytes_max=hbm_mx,
                hbm_peak_bytes_mean=hbm_mean,
            )
        if local_comm is not None:
            # The fleet plane's per-flush skew gauges: worst/mean
            # step-time ratio (1.0 = perfectly even), the cross-host
            # spread of cumulative collective block time (how unevenly
            # the fleet waits — the straggler's victims accumulate the
            # seconds), and the flight-recorder launch-sequence lag
            # (>0 sustained = desync forming).
            step_skew = mx / mean if mean > 0 else 1.0
            reg.gauge("fleet.step_time_skew").set(step_skew)
            reg.gauge("fleet.collective_skew_seconds").set(comm_skew)
            reg.gauge("fleet.flight_seq_lag").set(seq_lag)
            summary.update(
                step_time_skew=step_skew,
                collective_skew_seconds=comm_skew,
                flight_seq_lag=seq_lag,
            )
        return summary

    def collect(self) -> dict[str, Any]:
        """Snapshot device memory, aggregate step times across hosts,
        stamp the heartbeat, and flush the registry (one JSONL line on a
        file-sinked registry). Returns a plain-python summary."""
        summary: dict[str, Any] = {}
        local_hbm_peak = self._collect_memory()
        if self._window:
            summary = self._aggregate_step_times(local_hbm_peak)
            self._window = []
        self._since_collect = 0
        # Heartbeat: this host is alive and flushing. The *absence* of
        # fresh heartbeats in a host's stream is the hung-rank signal.
        # The same tick feeds stall detection: `progress` reads this
        # counter, and the armed watchdog's global progress source is
        # bumped here too — heartbeat and watchdog share one truth.
        # heartbeat_age_seconds makes the staleness readable from the
        # record itself (no cross-line time_unix arithmetic): the gap
        # since the PREVIOUS heartbeat, 0.0 on the first collect.
        now = self._clock()
        self.registry.gauge("monitor.heartbeat_age_seconds").set(
            now - self._last_heartbeat
            if self._last_heartbeat is not None
            else 0.0
        )
        self._last_heartbeat = now
        self.registry.counter("monitor.heartbeat").inc()
        self.registry.gauge("monitor.heartbeat_unix").set(now)
        try:
            from .watchdog import notify_progress

            notify_progress()
        except Exception:  # liveness signalling must never fail a collect
            pass
        summary["record"] = self.registry.flush()
        return summary
