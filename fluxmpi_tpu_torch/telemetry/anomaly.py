"""Run-health anomaly detection: catch a diverged run before a human does
(counterpart of :mod:`fluxmpi_tpu.telemetry.anomaly`: the same rules,
default policies, arithmetic, events and bundle).

A NaN loss burns every card of a run until somebody looks at a
dashboard. :class:`AnomalyDetector` evaluates a small
rule set against the numbers ``train_loop`` already computes at flush
boundaries (no extra device syncs):

==========================  ================================================
rule                        trigger
==========================  ================================================
``nan_loss``                loss is NaN/Inf
``nan_grad``                global grad norm is NaN/Inf
``loss_spike``              loss z-score vs a rolling EWMA mean/variance
                            exceeds ``spike_zscore`` (after ``warmup``
                            observations)
``step_time_regression``    interval step time exceeds ``step_time_factor``
                            × its EWMA (after ``warmup``)
``data_stall``              per-update loader wait exceeds
                            ``data_stall_factor`` × the interval's
                            *compute* remainder (step time − wait) — the
                            device is input-bound
``steady_state_retrace``    the compile plane
                            (:mod:`~fluxmpi_tpu_torch.telemetry.compileplane`)
                            observed compile events (a CUDA-graph
                            capture of a window program, a kernel build)
                            after the warmup boundary — a new window
                            width or batch shape is silently rebuilding
                            the step; the event names the rebuilt
                            function
``layer_grad_explosion``    one layer's gradient norm (from the
                            model-internals plane,
                            :mod:`~fluxmpi_tpu_torch.telemetry.modelstats`)
                            exceeds ``layer_explosion_factor`` × its own
                            per-layer EWMA (after ``warmup``) — the
                            layer-localized precursor the global norm
                            averages away; the event names the layer
``dead_layer``              one layer's gradient norm stays at ≈0
                            (``dead_layer_eps``) for
                            ``dead_layer_flushes`` consecutive flushes —
                            a frozen / disconnected / saturated layer;
                            the event names the layer
``slo_burn``                the serving plane's rolling SLO burn rate
                            (:mod:`~fluxmpi_tpu_torch.serving.observe`'s
                            multi-window good/total tracker) exceeds
                            ``slo_burn_threshold`` — the request error
                            budget is burning faster than it accrues,
                            the SRE burn-alert condition
``persistent_straggler``    the fleet plane's attribution engine
                            (:mod:`~fluxmpi_tpu_torch.telemetry.fleet`) blamed
                            the SAME host for
                            ``persistent_straggler_intervals`` consecutive
                            collection intervals — not a one-interval
                            blip but a host that is reliably slowing the
                            fleet; the event names the host (fires once
                            per streak via :meth:`observe_straggler`; a
                            clean interval or a blame hand-off re-arms)
==========================  ================================================

Each rule carries a **policy**: ``"warn"`` (record and continue),
``"halt"`` (``train_loop`` drains the in-flight window, flushes, and
returns cleanly with ``summary["anomaly"]`` set — the preemption exit
discipline, no mid-collective abort), or ``"off"``. Defaults: NaN rules
halt, the statistical rules warn — in a multi-process world only
SPMD-consistent signals (the loss and grad norm are global scalars,
identical on every process) are safe to halt on; a per-host signal like
step time would desync the collectives, so leave those on ``"warn"``.

On trigger the detector emits the full diagnostic surface:

- an ``anomaly.<rule>`` trace **instant** (schema-validated: instants
  must carry ``args.step`` and ``args.rule``) on the span timeline;
- the ``anomaly.triggered{rule=...}`` counter in the metrics plane;
- a **diagnostics bundle** — ``fluxmpi_anomaly.<process>.json``, built
  by the watchdog's dump machinery (all-thread stacks, the collective
  flight-recorder tail, open spans, a final registry flush) plus an
  ``anomaly`` section naming the rule/value/step — so the artifact a
  responder needs exists the moment the run went wrong, not after an
  interactive session reproduces it;
- for the *performance* rules (``step_time_regression``,
  ``steady_state_retrace``): a triggered profiler capture — when the
  auto-profiler is armed (``FLUXMPI_TPU_PROFILE_DIR`` /
  ``init(profile=...)``, see :mod:`fluxmpi_tpu_torch.utils.profiling`), one
  bounded ``torch.profiler`` window is captured so the regression's device-side
  evidence is on disk before a human looks (rate-limited, once per run
  by default).

Zero-cost-when-off: no detector installed (the default) means
``train_loop`` reads one module attribute per run and never calls
:meth:`observe`.
"""

from __future__ import annotations

import json
import math
import os
import threading
import warnings
from typing import Any

from .registry import MetricsRegistry, get_registry
from .registry import process_index_or_zero as _process_index

__all__ = [
    "AnomalyDetector",
    "get_anomaly_detector",
    "set_anomaly_detector",
    "configure",
    "shutdown",
    "RULES",
    "POLICIES",
]

_ENV_VAR = "FLUXMPI_TPU_ANOMALY"
_ENV_DIR = "FLUXMPI_TPU_ANOMALY_DIR"

RULES = (
    "nan_loss",
    "nan_grad",
    "loss_spike",
    "step_time_regression",
    "data_stall",
    "steady_state_retrace",
    "layer_grad_explosion",
    "dead_layer",
    "slo_burn",
    "persistent_straggler",
)

POLICIES = ("warn", "halt", "off")

_DEFAULT_POLICIES = {
    "nan_loss": "halt",
    "nan_grad": "halt",
    "loss_spike": "warn",
    "step_time_regression": "warn",
    "data_stall": "warn",
    # Per-host signal (each process compiles independently) — never a
    # halt default, like the other statistical rules.
    "steady_state_retrace": "warn",
    # Model-internals rules: statistical per-layer signals —
    # warn-default per the statistical-rule policy (the per-layer
    # norms ARE SPMD-consistent global scalars, but a z-score/EWMA
    # threshold is a judgment call, not a proof of divergence; the NaN
    # rules stay the halting pair).
    "layer_grad_explosion": "warn",
    "dead_layer": "warn",
    # Serving request-observability plane: a burn rate is a
    # per-engine (per-host) statistical signal — warn-default like the
    # other statistical rules; a serving process has no SPMD collective
    # to desync, but halting an engine on a latency regression would
    # turn a slow service into a down one.
    "slo_burn": "warn",
    # Fleet plane: a cross-host statistical verdict computed by
    # the collector, a process OUTSIDE the SPMD world — halting from
    # there could never be collective-consistent, and the right response
    # to a persistently slow host is operator action (drain/replace),
    # not killing the whole run.
    "persistent_straggler": "warn",
}

# Rules whose trigger is *performance* evidence a profiler capture can
# explain — they invoke the armed auto-profiler on emission.
_PROFILE_TRIGGER_RULES = ("step_time_regression", "steady_state_retrace")


def _finite(x: float) -> bool:
    return math.isfinite(x)


class AnomalyDetector:
    """Flush-boundary anomaly rules with warn/halt policies.

    Args:
      registry: registry the ``anomaly.triggered`` counter records into
        (default: the process-global one).
      policies: per-rule overrides of the defaults (NaN rules ``halt``,
        statistical rules ``warn``), e.g. ``{"loss_spike": "halt",
        "data_stall": "off"}``. Unknown rules / policies raise.
      spike_zscore: loss z-score (vs the rolling EWMA mean and variance)
        that counts as a spike.
      ewma_alpha: EWMA smoothing factor for the loss and step-time
        baselines (weight of the newest observation).
      warmup: observations a statistical baseline needs before its rule
        arms — the first steps of a run are legitimately wild.
      step_time_factor: interval step time > factor × EWMA = regression.
      data_stall_factor: per-update loader wait > factor × the interval's
        compute remainder (step time − wait) = input-bound (the wait is
        part of the step time, so it is judged against what is left).
      layer_explosion_factor: a layer's gradient norm > factor × its own
        EWMA (after ``warmup`` per-layer observations) = layer gradient
        explosion. Wider than the step-time factor by default — healthy
        per-layer norms are far noisier than step times.
      dead_layer_eps: a layer whose gradient norm stays ≤ this is
        considered gradient-dead (0.0 exactly means a disconnected
        layer; the default tolerates denormal dust).
      dead_layer_flushes: consecutive dead flushes before ``dead_layer``
        fires (once per streak; a recovery re-arms it).
      slo_burn_threshold: the rolling burn rate (bad requests over the
        window's error budget, reported by the serving plane's
        :class:`~fluxmpi_tpu_torch.serving.observe.SLOBurnTracker`) above
        which ``slo_burn`` fires. 1.0 = the budget is being consumed
        exactly as fast as it accrues; the default leaves headroom for
        bursty arrivals the way multi-window SRE burn alerts do.
      persistent_straggler_intervals: consecutive collection intervals
        the fleet plane must blame the SAME host before
        ``persistent_straggler`` fires (once per streak; a clean
        interval or a blame hand-off re-arms — see
        :meth:`observe_straggler`).
      dump_dir: where the diagnostics bundle lands (default
        ``FLUXMPI_TPU_ANOMALY_DIR`` or ``.``); stable per-process
        filename, latest trigger wins (the watchdog convention).
      dump: write bundles at all (tests that only want the rule engine
        turn it off).
    """

    def __init__(
        self,
        *,
        registry: MetricsRegistry | None = None,
        policies: dict[str, str] | None = None,
        spike_zscore: float = 6.0,
        ewma_alpha: float = 0.1,
        warmup: int = 5,
        step_time_factor: float = 3.0,
        data_stall_factor: float = 1.0,
        layer_explosion_factor: float = 10.0,
        dead_layer_eps: float = 1e-12,
        dead_layer_flushes: int = 3,
        slo_burn_threshold: float = 2.0,
        persistent_straggler_intervals: int = 3,
        dump_dir: str | None = None,
        dump: bool = True,
    ):
        self.enabled = True
        self._registry = registry
        self.policies = dict(_DEFAULT_POLICIES)
        for rule, policy in (policies or {}).items():
            if rule not in RULES:
                raise ValueError(
                    f"unknown anomaly rule {rule!r}; known: {RULES}"
                )
            if policy not in POLICIES:
                raise ValueError(
                    f"anomaly policy must be one of {POLICIES}, "
                    f"got {policy!r} for rule {rule!r}"
                )
            self.policies[rule] = policy
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.spike_zscore = float(spike_zscore)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup = int(warmup)
        self.step_time_factor = float(step_time_factor)
        self.data_stall_factor = float(data_stall_factor)
        if dead_layer_flushes < 1:
            raise ValueError(
                f"dead_layer_flushes must be >= 1, got {dead_layer_flushes}"
            )
        self.layer_explosion_factor = float(layer_explosion_factor)
        self.dead_layer_eps = float(dead_layer_eps)
        self.dead_layer_flushes = int(dead_layer_flushes)
        self.slo_burn_threshold = float(slo_burn_threshold)
        if persistent_straggler_intervals < 1:
            raise ValueError(
                "persistent_straggler_intervals must be >= 1, got "
                f"{persistent_straggler_intervals}"
            )
        self.persistent_straggler_intervals = int(
            persistent_straggler_intervals
        )
        self.dump_dir = (
            dump_dir
            if dump_dir is not None
            else os.environ.get(_ENV_DIR, ".")
        )
        self.dump = dump
        self.last_dump_path: str | None = None
        self.triggered: list[dict[str, Any]] = []
        # Rolling baselines (EWMA mean + variance for loss; EWMA mean
        # for step time) and their observation counts.
        self._loss_mean = 0.0
        self._loss_var = 0.0
        self._loss_n = 0
        self._step_mean = 0.0
        self._step_n = 0
        # Per-layer EWMA gradient-norm baselines (model-internals
        # plane) and the consecutive-dead-flush streaks.
        self._layer_mean: dict[str, float] = {}
        self._layer_n: dict[str, int] = {}
        self._dead_streak: dict[str, int] = {}
        # Fleet-plane straggler streak (observe_straggler): the host
        # currently blamed and how many consecutive intervals it has
        # held the blame.
        self._straggler_host: str | None = None
        self._straggler_streak = 0

    # -- rule engine ---------------------------------------------------

    def _event(
        self, rule: str, value: float, step: int | None
    ) -> dict[str, Any] | None:
        action = self.policies[rule]
        if action == "off":
            return None
        value = float(value)
        return {
            "rule": rule,
            "action": action,
            # The flagship NaN rules carry a non-finite trigger value;
            # json.dump would write the literal `NaN` — invalid strict
            # JSON that makes Perfetto reject the whole trace export
            # and jq choke on the bundle. Numeric slot goes null, the
            # repr keeps the actual trigger readable.
            "value": value if math.isfinite(value) else None,
            "value_repr": f"{value:.6g}",
            "step": int(step) if step is not None else None,
        }

    def observe(
        self,
        *,
        loss: float | None = None,
        grad_norm: float | None = None,
        step_seconds: float | None = None,
        fetch_seconds: float | None = None,
        retraces: int | None = None,
        retraced: str | None = None,
        layer_grad_norms: dict[str, float] | None = None,
        nonfinite_layer: str | None = None,
        slo_burn: float | None = None,
        step: int | None = None,
    ) -> list[dict[str, Any]]:
        """Evaluate every armed rule against one flush interval's
        numbers; returns the triggered events (each ``{"rule", "action",
        "value", "value_repr", "step"}`` — ``value`` is null for
        non-finite triggers, ``value_repr`` always carries the number),
        already emitted (instant + counter + bundle). ``train_loop`` halts when any event's action is
        ``"halt"``. All inputs optional — a rule whose input is absent
        stays quiet (``fetch_seconds`` is the per-update loader wait,
        which the loop derives from the goodput plane's ``data_stall``
        bucket, so the data-stall rule needs goodput enabled there;
        ``retraces`` is the interval's steady-state compile-event count
        from the compile plane's
        :meth:`~fluxmpi_tpu_torch.telemetry.compileplane.CompileMonitor.observe_flush`,
        with ``retraced`` naming the recompiled function(s) — the
        ``steady_state_retrace`` event carries it as ``function``;
        ``layer_grad_norms`` is the model-internals plane's per-layer
        view feeding the ``layer_grad_explosion``/``dead_layer`` rules,
        and ``nonfinite_layer`` its NaN provenance — the first layer
        whose gradients went nonfinite, carried on the ``nan_grad`` /
        ``nan_loss`` events as ``layer``; ``slo_burn`` is the serving
        plane's rolling burn rate — the tracker owns the windowing, so
        the rule has no detector-side warmup and fires whenever the
        reported rate exceeds ``slo_burn_threshold``)."""
        if not self.enabled:
            return []
        events: list[dict[str, Any]] = []

        if loss is not None:
            loss = float(loss)
            if not _finite(loss):
                ev = self._event("nan_loss", loss, step)
                if ev:
                    if nonfinite_layer is not None:
                        # NaN provenance from the model-internals
                        # plane: the first layer whose gradients went
                        # nonfinite — a NaN loss back-propagates NaN
                        # into every layer, so the forward-side culprit
                        # is what a responder actually needs named.
                        ev["layer"] = nonfinite_layer
                    events.append(ev)
            else:
                if self._loss_n >= self.warmup:
                    std = math.sqrt(max(self._loss_var, 0.0))
                    if std > 0.0:
                        z = (loss - self._loss_mean) / std
                        if z > self.spike_zscore:
                            ev = self._event("loss_spike", z, step)
                            if ev:
                                events.append(ev)
                # Update the baseline AFTER the check (a spike must not
                # vaccinate the mean it is judged against); West's EWMA
                # variance update.
                a = self.ewma_alpha
                if self._loss_n == 0:
                    self._loss_mean = loss
                    self._loss_var = 0.0
                else:
                    delta = loss - self._loss_mean
                    self._loss_mean += a * delta
                    self._loss_var = (1 - a) * (self._loss_var + a * delta**2)
                self._loss_n += 1

        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if not _finite(grad_norm):
                ev = self._event("nan_grad", grad_norm, step)
                if ev:
                    if nonfinite_layer is not None:
                        ev["layer"] = nonfinite_layer
                    events.append(ev)

        if step_seconds is not None and step_seconds > 0:
            step_seconds = float(step_seconds)
            if (
                self._step_n >= self.warmup
                and self._step_mean > 0
                and step_seconds > self.step_time_factor * self._step_mean
            ):
                ev = self._event(
                    "step_time_regression",
                    step_seconds / self._step_mean,
                    step,
                )
                if ev:
                    events.append(ev)
            a = self.ewma_alpha
            if self._step_n == 0:
                self._step_mean = step_seconds
            else:
                self._step_mean += a * (step_seconds - self._step_mean)
            self._step_n += 1

        if (
            fetch_seconds is not None
            and step_seconds is not None
            and step_seconds > 0
        ):
            # Input-bound test: the loader wait is PART of the wall
            # step time, so it is compared against the remainder (the
            # compute the device actually got) — fetch vs the whole
            # interval could never exceed 1x and the rule would be
            # dead by construction.
            compute = max(float(step_seconds) - float(fetch_seconds), 0.0)
            if (
                compute <= 0.0
                or fetch_seconds > self.data_stall_factor * compute
            ):
                # Finite ratio even at compute==0 (all-wait interval):
                # the event value must stay strict-JSON-serializable.
                ratio = float(fetch_seconds) / max(compute, 1e-9)
                ev = self._event("data_stall", ratio, step)
                if ev:
                    events.append(ev)

        if layer_grad_norms:
            for lname, norm in layer_grad_norms.items():
                norm = float(norm)
                if not _finite(norm):
                    continue  # the NaN rules own nonfinite gradients
                n = self._layer_n.get(lname, 0)
                mean = self._layer_mean.get(lname, 0.0)
                if (
                    n >= self.warmup
                    and mean > 0.0
                    and norm > self.layer_explosion_factor * mean
                ):
                    ev = self._event(
                        "layer_grad_explosion", norm / mean, step
                    )
                    if ev:
                        ev["layer"] = lname
                        events.append(ev)
                # Baseline updated AFTER the check, like the loss spike
                # rule — an exploding flush must not vaccinate the mean
                # it is judged against.
                a = self.ewma_alpha
                self._layer_mean[lname] = (
                    norm if n == 0 else mean + a * (norm - mean)
                )
                self._layer_n[lname] = n + 1
                if norm <= self.dead_layer_eps:
                    streak = self._dead_streak.get(lname, 0) + 1
                    self._dead_streak[lname] = streak
                    if streak == self.dead_layer_flushes:
                        # Fires once per streak (== not >=): a layer
                        # that stays dead does not re-trigger every
                        # flush; recovery resets the streak and re-arms.
                        ev = self._event("dead_layer", norm, step)
                        if ev:
                            ev["layer"] = lname
                            events.append(ev)
                else:
                    self._dead_streak[lname] = 0

        if retraces is not None and retraces > 0:
            # No detector-side warmup: the compile plane already owns
            # the warmup boundary (its first observe_flush) and only
            # reports steady-state events here.
            from .compileplane import UNTRACKED

            ev = self._event("steady_state_retrace", float(retraces), step)
            if ev:
                ev["function"] = retraced or UNTRACKED
                events.append(ev)

        if slo_burn is not None and _finite(float(slo_burn)):
            # No detector-side warmup: the serving plane's burn tracker
            # owns the windowing and reports nothing until a window has
            # data, so a reported rate is already baselined.
            if float(slo_burn) > self.slo_burn_threshold:
                ev = self._event("slo_burn", float(slo_burn), step)
                if ev:
                    events.append(ev)

        for ev in events:
            self._emit(ev)
        return events

    def observe_straggler(
        self, host: str | None, *, step: int | None = None
    ) -> list[dict[str, Any]]:
        """Feed one fleet-plane attribution interval's verdict: the
        blamed host's name, or None for a clean interval (evaluated but
        nobody flagged). Kept separate from :meth:`observe` because the
        caller is the :class:`~fluxmpi_tpu_torch.telemetry.fleet.FleetCollector`
        on its own thread cadence, not ``train_loop``'s flush path — and
        because None must mean "explicitly clean" (streak reset) here,
        where an absent :meth:`observe` input means "no information".

        The ``dead_layer`` streak discipline: ``persistent_straggler``
        fires exactly once when the same host has been blamed for
        ``persistent_straggler_intervals`` consecutive intervals (== not
        >=, so a host that stays slow does not re-trigger every
        interval); a clean interval resets the streak, a different host
        starts its own streak at 1. The event names the host."""
        if not self.enabled:
            return []
        events: list[dict[str, Any]] = []
        if host is None:
            self._straggler_host = None
            self._straggler_streak = 0
        else:
            if host == self._straggler_host:
                self._straggler_streak += 1
            else:
                self._straggler_host = host
                self._straggler_streak = 1
            if self._straggler_streak == self.persistent_straggler_intervals:
                ev = self._event(
                    "persistent_straggler",
                    float(self._straggler_streak),
                    step,
                )
                if ev:
                    ev["host"] = host
                    events.append(ev)
        for ev in events:
            self._emit(ev)
        return events

    # -- emission ------------------------------------------------------

    def _emit(self, ev: dict[str, Any]) -> None:
        self.triggered.append(ev)
        reg = self._registry if self._registry is not None else get_registry()
        if getattr(reg, "enabled", True):
            reg.counter("anomaly.triggered", rule=ev["rule"]).inc()
        from . import tracing as _tracing

        extra: dict[str, Any] = {}
        for key in ("function", "layer", "host"):
            if key in ev:
                extra[key] = ev[key]
        _tracing.instant(
            "anomaly." + ev["rule"],
            rule=ev["rule"],
            step=int(ev["step"] or 0),
            value=ev["value"],
            value_repr=ev["value_repr"],
            action=ev["action"],
            **extra,
        )
        warnings.warn(
            f"anomaly detected: {ev['rule']} (value {ev['value_repr']} at "
            f"step {ev['step']})"
            + (f" in {ev['function']}" if "function" in ev else "")
            + (f" in layer {ev['layer']}" if "layer" in ev else "")
            + (f" on host {ev['host']}" if "host" in ev else "")
            + f" — policy {ev['action']!r}"
            + (
                f"; diagnostics bundle at {self.dump_path()}"
                if self.dump
                else ""
            ),
            stacklevel=4,
        )
        if self.dump:
            try:
                self.write_bundle(ev)
            except Exception as exc:  # diagnostics must never kill the run
                warnings.warn(
                    f"anomaly diagnostics bundle write failed: {exc!r}",
                    stacklevel=4,
                )
        if ev["rule"] in _PROFILE_TRIGGER_RULES:
            # Performance anomaly: capture the device-side evidence while
            # the regression is still happening. No-op (one None check)
            # when the auto-profiler is unarmed; rate-limited when armed.
            try:
                from ..utils.profiling import maybe_auto_capture

                maybe_auto_capture(f"anomaly:{ev['rule']}")
            except Exception:  # diagnostics must never kill the run
                pass

    def dump_path(self) -> str:
        return os.path.join(
            self.dump_dir, f"fluxmpi_anomaly.{_process_index()}.json"
        )

    def write_bundle(self, ev: dict[str, Any]) -> str:
        """Write the diagnostics bundle for one event and return its
        path. Reuses the watchdog's dump machinery — the bundle IS a
        ``watchdog_dump``-kind record (thread stacks, flight-recorder
        tail, open spans, final registry flush) with an extra
        ``anomaly`` section, so the existing schema validator and triage
        tooling (``diff_flight_dumps``) apply unchanged."""
        from .watchdog import Watchdog, get_watchdog

        wd = get_watchdog()
        if wd is None:
            # An unarmed watchdog: build_dump never starts threads or
            # installs signals — it only assembles the record.
            wd = Watchdog(deadline=1.0, registry=self._registry)
        record = wd.build_dump(f"anomaly:{ev['rule']}")
        record["anomaly"] = dict(ev)
        path = self.dump_path()
        os.makedirs(self.dump_dir or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1)
        self.last_dump_path = path
        return path


# ---------------------------------------------------------------------------
# Default detector wiring (init kwarg / env var)
# ---------------------------------------------------------------------------

_active: AnomalyDetector | None = None
_active_lock = threading.Lock()


def get_anomaly_detector() -> AnomalyDetector | None:
    """The installed detector, if any (None = plane off)."""
    return _active


def set_anomaly_detector(
    detector: AnomalyDetector | None,
) -> AnomalyDetector | None:
    """Install (or, with None, remove) the process anomaly detector;
    returns the previous one."""
    global _active
    with _active_lock:
        prev, _active = _active, detector
    return prev


def configure(spec: Any = None) -> AnomalyDetector | None:
    """Wire anomaly detection from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_ANOMALY`` (same forms; no-op when
      unset/empty);
    - ``False`` / ``"0"`` — uninstall;
    - ``True`` / ``"1"`` — install a default detector (NaN rules halt,
      statistical rules warn);
    - ``"warn"`` — install with EVERY rule on ``"warn"`` (observe-only);
    - an :class:`AnomalyDetector` — install it.

    Called by ``fluxmpi_tpu_torch.init(anomaly=...)``; idempotent — an
    installed detector is kept (with its rolling baselines) on a replay
    with an equivalent spec.
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _active
    if isinstance(spec, AnomalyDetector):
        spec.enabled = True
        set_anomaly_detector(spec)
        return spec
    if spec is False or spec == "0":
        set_anomaly_detector(None)
        return None
    if spec is True or spec == "1":
        # Reuse only a detector that actually carries the default
        # policies: after configure("warn"), a later configure(True)
        # must deliver what True documents (NaN rules HALT) — silently
        # keeping the observe-only detector would let a NaN run burn.
        if _active is not None and _active.policies == _DEFAULT_POLICIES:
            _active.enabled = True
            return _active
        det = AnomalyDetector()
        set_anomaly_detector(det)
        return det
    if spec == "warn":
        if _active is not None and all(
            p in ("warn", "off") for p in _active.policies.values()
        ):
            _active.enabled = True
            return _active
        det = AnomalyDetector(
            policies={rule: "warn" for rule in RULES}
        )
        set_anomaly_detector(det)
        return det
    raise ValueError(
        f"anomaly spec must be a bool, '0'/'1', 'warn', or an "
        f"AnomalyDetector; got {spec!r}"
    )


def shutdown() -> None:
    """Uninstall the detector — baselines and policies must never leak
    into the next init cycle (the fault-plane leak rule)."""
    set_anomaly_detector(None)
