"""Telemetry record schemas and validators: the port's own copy of
:mod:`fluxmpi_tpu.telemetry.schema`, its tables and validators unchanged
(``tests/test_torch_telemetry.py`` holds the two copies equal, so drift
in either fails the tests). The port's records are the JAX package's
records: ``scripts/check_metrics_schema.py``, which loads the JAX
package's copy by file path, validates both. Stdlib only.

Telemetry flush record (one JSON object per line in a JSONL stream):

    {
      "schema": "fluxmpi_tpu.telemetry/v1",
      "time_unix": 1753812345.123,       # host wall clock at flush
      "process": 0,                       # controller process index
      "metrics": [ <metric>, ... ],
      ...optional extra keys (e.g. "bench" for bench emissions)
    }

Metric objects share ``name`` (dotted, e.g. "comm.bytes"), ``type``
("counter" | "gauge" | "histogram"), and ``labels`` (flat str->str):

    counter:   {"value": <number>}            # cumulative, monotonic
    gauge:     {"value": <number>}            # last set value
    histogram: {"count": <int>, "sum": <number>,
                "min"/"max"/"mean"/"last": <number>}   # when count > 0

Bench record (``bench.py`` stdout JSON line / BENCH_*.json "tail"):
required keys ``metric`` (str), ``value`` (number), ``unit`` (str),
``vs_baseline`` (number); known optional keys are type-checked, unknown
keys are allowed (forward compatibility).

Trace-plane records (schema ``fluxmpi_tpu.trace/v1``) share one top-level
shape — ``schema``, ``kind``, ``time_unix``, ``process`` — and dispatch
on ``kind``:

    kind="trace":            a Chrome-trace/Perfetto export — the
                             standard ``traceEvents`` list ("X" complete
                             spans with ``ts``/``dur`` in microseconds,
                             "i" instants, "M" metadata) plus our
                             top-level metadata. Perfetto ignores the
                             extra keys, so the file loads directly.
    kind="flight_recorder":  the last-N collective-launch ring — entries
                             carry a monotonic per-process ``seq``, the
                             op, path, nbytes, start stamp, duration,
                             and a ``completed`` flag. Cross-host dumps
                             diff by ``seq``.
    kind="watchdog_dump":    the hang artifact — all-thread stacks, the
                             flight-recorder tail, the open span stack,
                             and a final telemetry/v1 registry flush.
"""

from __future__ import annotations

SCHEMA = "fluxmpi_tpu.telemetry/v1"

TRACE_SCHEMA = "fluxmpi_tpu.trace/v1"

MANIFEST_SCHEMA = "fluxmpi_tpu.manifest/v1"

# The /status endpoint of the live export plane (telemetry/export.py):
# one JSON snapshot per scrape — run identity, the train_loop status
# board, a live goodput breakdown, the last anomaly, monitor gauges,
# and the health verdict. scripts/fluxmpi_top.py polls it fleet-wide.
STATUS_SCHEMA = "fluxmpi_tpu.status/v1"

# Per-request terminal records from the serving request-observability
# plane (serving/observe.py): one JSON object per request reaching a
# terminal state (finished or rejected), appended to the JSONL log that
# FLUXMPI_TPU_REQUEST_LOG / init(request_log=) opens.
# scripts/serving_report.py aggregates these into a latency/SLO/reject
# post-mortem; scripts/check_metrics_schema.py validates each line.
REQUEST_SCHEMA = "fluxmpi_tpu.request/v1"

# The two terminal statuses a request record may carry — matching the
# serving engine's FINISHED/REJECTED states. A queued or active request
# never logs (its record lands when it drains, completes, or rejects).
REQUEST_STATUSES = ("finished", "rejected")

# Fleet-plane snapshots from the cross-host collector
# (telemetry/fleet.py): one JSON object per collection interval — the
# per-host health/staleness census joined with the straggler
# attribution verdict. ``FleetCollector.snapshot()`` returns one;
# ``FLUXMPI_TPU_FLEET=<path>`` appends one per interval to a JSONL
# bank that ``scripts/fleet_report.py`` replays post-mortem and
# ``scripts/check_metrics_schema.py`` validates.
FLEET_SCHEMA = "fluxmpi_tpu.fleet/v1"

# The causes the straggler attribution engine can assign, in the order
# it checks them: cross-host flight-recorder sequence divergence
# (``desync``, via flight_recorder.diff_dumps), then the straggler's
# dominant badput bucket over the interval (``data_stall`` when input
# starvation dominates, ``comm_wait`` when collective blocking does),
# else ``compute`` (the step itself is slow).
STRAGGLER_CAUSES = ("desync", "data_stall", "comm_wait", "compute")

# Layout-autotuner records (parallel/autotune.py): the banked winner +
# full candidate table one ``autotune()`` run produces — written as the
# ``FLUXMPI_TPU_AUTOTUNE_BANK`` file, as the ``<ckpt>.autotune.json``
# sidecar next to the checkpoint manifest, and embedded in bench
# records under the ``autotune`` key. A later run with the same (model
# fingerprint, topology) trusts this record INSTEAD of re-running
# trials, so ``scripts/check_metrics_schema.py`` validates it like any
# other cross-run contract.
AUTOTUNE_SCHEMA = "fluxmpi_tpu.autotune/v1"

# Why a candidate layout was eliminated before trials, in stage order:
# the static memory model put it over the per-device byte budget
# (``memory``), or another candidate was no worse on both the static
# cost score and the memory floor / it fell past the trial budget
# (``dominated``). A null ``pruned`` means the candidate ran a trial.
AUTOTUNE_PRUNE_REASONS = ("memory", "dominated")

# Live N→M resize records (fleet/resize.py): one JSON object per
# completed resize — the old and new world sizes, the drained step, and
# the badput seconds attributed to each phase of the
# drain→save→reshard→restart pipeline. The draining world banks the
# first half on a handoff stamp next to the checkpoint; the resumed
# world completes the record and appends it to the
# ``FLUXMPI_TPU_RESIZE=<path>`` JSONL bank that
# ``scripts/check_metrics_schema.py`` validates.
RESIZE_SCHEMA = "fluxmpi_tpu.resize/v1"

# The badput phases of one resize, in pipeline order: finishing the
# in-flight window after the request is agreed (``drain``), the final
# synchronous checkpoint save (``save``), the resumed world's
# manifest-remapped restore (``reshard``), and the wall-clock gap
# between the old world's exit stamp and the new world's resume
# (``restart`` — scheduler + process bring-up, the part outside both
# worlds).
RESIZE_PHASES = ("drain", "save", "reshard", "restart")

METRIC_TYPES = ("counter", "gauge", "histogram")

_HIST_STAT_KEYS = ("sum", "min", "max", "mean", "last")

# Every metric name the framework itself emits. Documentation for readers
# of a JSONL stream — and, for the namespaces fully owned by the
# fault-tolerance and run-health planes (see _CLOSED_NAMESPACES), an
# enforced contract: a "fault."/"checkpoint."/"goodput."/"anomaly." name
# outside this set is producer drift, not a user metric. The older
# namespaces stay open (user code legitimately mints train.my_metric
# etc.).
KNOWN_METRIC_NAMES = frozenset(
    {
        "comm.calls",
        "comm.bytes",
        "comm.block_seconds",
        "data.batch_fetch_seconds",
        "data.prefetch_depth",
        "train.step_seconds",
        "train.loss",
        "train.grad_norm",
        "train.examples_per_sec",
        "train.steps",
        "train.examples",
        "train.resumes",
        "fault.injected",
        "checkpoint.retries",
        # Zero-downtime ops (PR 20): async-save accounting (driver-side
        # request counter, coalesced requests superseded by a newer one,
        # local→durable tier promotions) and the off-driver background
        # ledger ({bucket=...} — the async writer's real write cost,
        # kept OUT of the wall-clock badput buckets it overlaps).
        "checkpoint.async_saves",
        "checkpoint.async_superseded",
        "checkpoint.promotions",
        "goodput.background_seconds",
        # Live N→M resize (fleet/resize.py): requests agreed by the
        # world, completed resizes stitched by the resumed world, and
        # the per-phase badput gauges ({phase=...}, RESIZE_PHASES).
        "resize.requests",
        "resize.completed",
        "resize.badput_seconds",
        # Run-health plane (PR 7): goodput/badput wall-clock accounting
        # (cumulative-seconds gauges labeled {bucket=...}), the
        # productive fraction, live MFU over wall / over productive step
        # time, and the anomaly trigger counter ({rule=...}).
        "goodput.bucket_seconds",
        "goodput.wall_seconds",
        "goodput.fraction",
        "goodput.updates",
        "goodput.mfu",
        "goodput.mfu_productive",
        "anomaly.triggered",
        # Device plane (PR 9): XLA compile/retrace accounting
        # (cumulative counters; seconds labeled {phase=trace|lower|
        # compile}, attribution labeled {function=...}) and per-device
        # HBM gauges ({device=<local index>}) with the process-lifetime
        # peak watermark.
        "compile.events",
        "compile.seconds",
        "compile.function_seconds",
        "compile.retraces",
        "compile.unattributed_seconds",
        # Fused-window path (PR 11): AOT-lowered programs have no jit
        # cache to poll — explicit lower()+compile() accounting, labeled
        # {function=...} like the live-jit attribution above.
        "compile.aot_programs",
        "compile.aot_seconds",
        # train_loop fuse="window": the window width in optimizer
        # updates and the cumulative one-dispatch-per-window count (the
        # fused path's host-cost contract, directly observable).
        "train.window.size",
        "train.window.dispatches",
        "memory.bytes_in_use",
        "memory.peak_bytes_in_use",
        "memory.bytes_limit",
        "memory.peak_watermark_bytes",
        "monitor.hbm_peak_bytes_min",
        "monitor.hbm_peak_bytes_max",
        "monitor.hbm_peak_bytes_mean",
        "monitor.heartbeat",
        "monitor.heartbeat_unix",
        "monitor.heartbeat_age_seconds",
        "monitor.step_seconds_local_mean",
        "monitor.step_seconds_min",
        "monitor.step_seconds_max",
        "monitor.step_seconds_mean",
        "monitor.straggler",
        "monitor.goodput_fraction_min",
        "monitor.goodput_fraction_max",
        "monitor.goodput_fraction_mean",
        "host.memory.peak_rss_bytes",
        # Live export plane (PR 12): the exporter's self-telemetry —
        # scrape counts per endpoint ({endpoint=metrics|status|healthz})
        # and the last /metrics render cost (set AFTER the render, so it
        # describes the previous scrape — measuring a render from inside
        # itself would lie).
        "export.requests",
        "export.render_seconds",
        # Serving plane (PR 13): the continuous-batching inference
        # engine's request/latency/cache accounting — queue depth and
        # active batch slots (gauges), TTFT / mean-per-token / queue-wait
        # latency histograms, admission rejects ({reason=...}), SLO
        # breaches ({kind=ttft|per_token}), cumulative decode dispatches
        # and generated tokens, and the paged KV pool's block occupancy.
        "serving.queue_depth",
        "serving.active_sequences",
        "serving.ttft_seconds",
        "serving.token_seconds",
        "serving.queue_wait_seconds",
        "serving.admission_rejects",
        "serving.slo_violations",
        "serving.requests_completed",
        "serving.decode_steps",
        "serving.tokens_generated",
        "serving.kv_blocks_in_use",
        "serving.kv_blocks_free",
        # Serving request-observability plane (PR 16): per-request size
        # histograms (token-count ladder, not the latency ladders), the
        # KV pool's process-lifetime high watermark and free-list
        # fragmentation gauges, and the rolling SLO burn rate
        # ({window=<seconds>} — good/total per window, multi-window like
        # SRE burn alerts) that feeds the `slo_burn` anomaly rule.
        "serving.prompt_tokens",
        "serving.output_tokens",
        "serving.kv_high_watermark_blocks",
        "serving.kv_fragmentation",
        "serving.slo_burn_rate",
        "serving.requests_logged",
        # Request lifecycle trace instants (serving/observe.py): the
        # terminal markers on a request's Perfetto track. The span
        # names (request.queue/prefill/decode) are 'X' events, not
        # instants, so they need no registration.
        "request.done",
        "request.rejected",
        # Model-internals plane (PR 14): per-layer training dynamics
        # computed INSIDE the compiled step (telemetry/modelstats.py) and
        # emitted at train_loop flush boundaries — per-layer gradient /
        # parameter norms and the update-to-weight ratio ({layer=...},
        # grouped by path depth so the set stays O(layers)), the
        # per-layer nonfinite-gradient element count (NaN provenance),
        # and the gradient-noise-scale ingredients the DP allreduce
        # produces for free: the mean per-rank (pre-allreduce) gradient
        # sq-norm, the averaged gradient's sq-norm, and the B_simple
        # critical-batch-size estimate derived from them (McCandlish et
        # al. 2018).
        "model.layer_grad_norm",
        "model.layer_param_norm",
        "model.update_ratio",
        "model.nonfinite",
        "model.grad_sqnorm_local",
        "model.grad_sqnorm_global",
        "model.grad_noise_scale",
        # Parallelism plane (parallel/plan.py): the resolved mesh's
        # per-axis device counts ({axis=...}) and the partition-rule
        # engine's per-source hit counts ({source=table|tp|fsdp|
        # replicated}) — posted when init(parallel=) installs a plan
        # and refreshed by ResolvedPlan.shard_state.
        "parallel.axis_size",
        "parallel.rule_hits",
        # Fleet plane (PR 17): the cross-host collector's own metrics —
        # host census gauges, scrape latency (fast-path ladder so
        # histogram_quantile sees collector overhead), the per-interval
        # straggler verdict counter ({cause=...}, STRAGGLER_CAUSES) —
        # plus the per-flush skew gauges every host computes locally
        # from the monitor's single host_allgather: worst/mean step-time
        # ratio and the cross-host spread of cumulative collective
        # block time (max − min seconds, the "who waits on whom" scalar)
        # and flight-recorder sequence lag (max − min launched seq).
        "fleet.hosts",
        "fleet.hosts_stale",
        "fleet.collect_seconds",
        "fleet.straggler_intervals",
        "fleet.step_time_skew",
        "fleet.collective_skew_seconds",
        "fleet.flight_seq_lag",
        # Layout autotuner (parallel/autotune.py): the last search's
        # candidate census — enumerated total, per-reason prune counts
        # ({reason=...}, AUTOTUNE_PRUNE_REASONS), how many survivors
        # ran fused-window trials and their total wall seconds — plus
        # the cumulative bank-hit counter (a hit means a tune was
        # skipped entirely).
        "autotune.candidates_total",
        "autotune.pruned",
        "autotune.trials",
        "autotune.trial_seconds",
        "autotune.bank_hits",
    }
)

_CLOSED_NAMESPACES = (
    "fault.",
    "checkpoint.",
    "goodput.",
    "anomaly.",
    "compile.",
    "memory.",
    "export.",
    "serving.",
    "model.",
    "parallel.",
    "fleet.",
    "autotune.",
    "resize.",
)

# Histogram bucket edges, declared HERE so the registry (which bins
# observations), the Prometheus exporter (which renders cumulative
# ``_bucket{le=...}`` series), and any JSONL consumer all agree on one
# set of boundaries — PromQL ``histogram_quantile`` needs cumulative
# buckets, and an edge set invented per producer would make cross-host
# aggregation meaningless. Names absent here keep the bucket-free
# count/sum/min/max/mean/last summary (min/max bound the tail exactly,
# which is what straggler detection needs).
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Eager-collective host blocking and per-token decode sit well under a
# millisecond on healthy hardware — extend the ladder down so the fast
# path isn't one undifferentiated first bucket.
_FAST_LATENCY_BUCKETS = (1e-05, 2.5e-05, 5e-05, 0.0001, 0.00025) + (
    _LATENCY_BUCKETS
)
# Request-size histograms count tokens, not seconds: a powers-of-two
# ladder from single-token probes up past the longest context anyone
# serves today, so PromQL can see the prompt/output size mix without a
# per-deployment edge set.
_TOKEN_COUNT_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0, 8192.0, 16384.0, 32768.0,
)

HISTOGRAM_BUCKET_EDGES: dict[str, tuple[float, ...]] = {
    "train.step_seconds": _LATENCY_BUCKETS,
    "data.batch_fetch_seconds": _LATENCY_BUCKETS,
    "comm.block_seconds": _FAST_LATENCY_BUCKETS,
    "serving.ttft_seconds": _LATENCY_BUCKETS,
    "serving.token_seconds": _FAST_LATENCY_BUCKETS,
    "serving.queue_wait_seconds": _LATENCY_BUCKETS,
    "serving.prompt_tokens": _TOKEN_COUNT_BUCKETS,
    "serving.output_tokens": _TOKEN_COUNT_BUCKETS,
    # One scrape = a handful of localhost/LAN HTTP round-trips: healthy
    # collects sit in the fast-path sub-millisecond rungs, a slow or
    # timing-out host pushes into the seconds tail — the same ladder the
    # eager-collective block times use.
    "fleet.collect_seconds": _FAST_LATENCY_BUCKETS,
}

# The preemption trace event train_loop emits when it drains and exits on
# SIGTERM/SIGINT: an instant ("i"/"I") carrying the update count it
# banked — a span ("X") here would claim a duration preemption does not
# have, so the validator rejects the wrong phase.
PREEMPTION_EVENT = "train.preemption"

# Anomaly trace events (AnomalyDetector triggers): "anomaly.<rule>"
# instants carrying the rule name and the update count — same
# instant-only contract as the preemption event (an anomaly is a point
# in time, not a span), enforced by validate_trace_event.
ANOMALY_EVENT_PREFIX = "anomaly."

# Known optional bench keys -> required type(s). Unknown keys pass (new
# fields must not break old validators); known keys with the wrong type
# fail (that is the drift being guarded against).
_BENCH_OPTIONAL: dict[str, tuple[type, ...]] = {
    "platform": (str,),
    "device_kind": (str,),
    "n_chips": (int,),
    "mfu": (int, float),
    "flops_source": (str,),
    "scan_steps": (int,),
    "probe": (dict,),
    "scaling": (dict,),
    "attention": (dict,),
    "transformer_lm": (dict,),
    "deq": (dict,),
    # Steady-state breakdown keys (PR 4): the null-step dispatch floor,
    # the assembly-only loader sub-rate, and the smoke-mode marker.
    "dispatch": (dict,),
    "assembly_samples_per_sec": (int, float),
    "loader_fed_path": (str,),
    "smoke": (int,),
    # Which bench config a record (especially a bench_failed one, which
    # has no device_kind/n_chips) belongs to — part of the JSONL merge
    # key, so failures from different configs bank as distinct lines.
    "config": (str,),
    # An MFU the harness computed but refused to report (>1.0: a broken
    # clock or FLOPs estimate). Recorded instead of stderr-only printed
    # so trajectory tooling can see the discard happened.
    "mfu_discarded": (bool,),
    # Fused-window A/B (PR 11): per-leg throughput + dispatches-per-
    # update for the pipelined vs fuse="window" train_loop paths, so the
    # one-dispatch-per-window claim is asserted in the record rather
    # than inferred.
    "fused_window": (dict,),
    # Serving A/B (PR 13): static-batch vs continuous-batch legs on the
    # mixed-length workload, the speedup, and the steady-state retrace
    # count across mid-flight joins (must be 0 — the zero-retrace
    # claim, asserted by tests/test_bench.py's smoke).
    "serving": (dict,),
    # ParallelConfig plane (parallel/plan.py): the train_loop child's
    # resolved plan — axes, rule hit counts, the loop's own
    # dispatches-per-update under the plan-derived sharding — and the
    # per-axis composition legs (dp vs dp×fsdp vs dp×tp) on the CPU
    # virtual mesh.
    "parallel": (dict,),
    "parallel_axes": (dict,),
    # Layout autotuner (parallel/autotune.py): the full
    # fluxmpi_tpu.autotune/v1 record of the bench's auto-layout leg —
    # candidate table with static scores and trial throughputs, winner,
    # bank identity. Validated as an embedded autotune record by
    # validate_bench_record when it carries the schema tag.
    "autotune": (dict,),
    # Kernel-plane A/B (ISSUE 19): attention="flash" vs "naive" through
    # the model switch on BOTH hot paths — training fwd+bwd (per-leg
    # throughput + compiled HBM footprint from memory_analysis) and
    # paged serving decode (per-leg tokens/sec + steady-state retrace
    # count, which must be 0 per the no-retrace join contract).
    "attention_ab": (dict,),
}


def _is_number(x: object) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _bench_type_ok(v: object, types: tuple[type, ...]) -> bool:
    """Type check for _BENCH_OPTIONAL values. bool is a subclass of int,
    so it is accepted ONLY where (bool,) is the declared type and
    rejected everywhere a number is expected."""
    if isinstance(v, bool):
        return bool in types
    return isinstance(v, types)


def validate_metric(m: object, where: str = "metric") -> list[str]:
    """Validate one metric object; returns a list of error strings."""
    errors: list[str] = []
    if not isinstance(m, dict):
        return [f"{where}: not an object: {m!r}"]
    name = m.get("name")
    if not isinstance(name, str) or not name:
        errors.append(f"{where}: missing/invalid 'name': {name!r}")
        name = "<unnamed>"
    where = f"{where} {name!r}"
    if name.startswith(_CLOSED_NAMESPACES) and name not in KNOWN_METRIC_NAMES:
        errors.append(
            f"{where}: unknown metric in a framework-owned namespace "
            f"(known: {sorted(n for n in KNOWN_METRIC_NAMES if n.startswith(_CLOSED_NAMESPACES))})"
        )
    kind = m.get("type")
    if kind not in METRIC_TYPES:
        errors.append(f"{where}: 'type' must be one of {METRIC_TYPES}, got {kind!r}")
        return errors
    labels = m.get("labels", {})
    if not isinstance(labels, dict) or not all(
        isinstance(k, str) and isinstance(v, str) for k, v in labels.items()
    ):
        errors.append(f"{where}: 'labels' must map str -> str, got {labels!r}")
    if kind in ("counter", "gauge"):
        if not _is_number(m.get("value")):
            errors.append(f"{where}: missing numeric 'value'")
    else:  # histogram
        count = m.get("count")
        if not isinstance(count, int) or isinstance(count, bool) or count < 0:
            errors.append(f"{where}: histogram 'count' must be an int >= 0")
        elif count > 0:
            for k in _HIST_STAT_KEYS:
                if not _is_number(m.get(k)):
                    errors.append(f"{where}: histogram missing numeric {k!r}")
        errors.extend(_validate_histogram_buckets(m, where))
    return errors


def _validate_histogram_buckets(m: dict, where: str) -> list[str]:
    """Optional cumulative buckets on a histogram metric object:
    ``{"edges": [...], "counts": [...]}`` with strictly increasing
    edges, same-length non-decreasing int counts, and the last count
    bounded by the total ``count`` (the implicit ``+Inf`` bucket)."""
    buckets = m.get("buckets")
    if buckets is None:
        return []
    if not isinstance(buckets, dict):
        return [f"{where}: 'buckets' must be an object, got {buckets!r}"]
    errors: list[str] = []
    edges = buckets.get("edges")
    counts = buckets.get("counts")
    if not isinstance(edges, list) or not all(_is_number(e) for e in edges):
        errors.append(f"{where}: buckets 'edges' must be a list of numbers")
        edges = []
    elif any(b <= a for a, b in zip(edges, edges[1:])):
        errors.append(f"{where}: buckets 'edges' must be strictly increasing")
    if not isinstance(counts, list) or not all(
        isinstance(c, int) and not isinstance(c, bool) and c >= 0
        for c in counts
    ):
        errors.append(
            f"{where}: buckets 'counts' must be a list of ints >= 0"
        )
        counts = []
    else:
        if any(b < a for a, b in zip(counts, counts[1:])):
            errors.append(
                f"{where}: buckets 'counts' must be cumulative "
                f"(non-decreasing)"
            )
        total = m.get("count")
        if counts and isinstance(total, int) and counts[-1] > total:
            errors.append(
                f"{where}: last bucket count {counts[-1]} exceeds total "
                f"'count' {total} (the implicit +Inf bucket)"
            )
    if edges and counts and len(edges) != len(counts):
        errors.append(
            f"{where}: buckets edges/counts length mismatch "
            f"({len(edges)} vs {len(counts)})"
        )
    return errors


def validate_record(rec: object) -> list[str]:
    """Validate one telemetry flush record; returns a list of error strings
    (empty == valid)."""
    if not isinstance(rec, dict):
        return [f"record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != SCHEMA:
        errors.append(
            f"'schema' must be {SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    proc = rec.get("process")
    if not isinstance(proc, int) or isinstance(proc, bool) or proc < 0:
        errors.append("'process' must be an int >= 0")
    metrics = rec.get("metrics")
    if not isinstance(metrics, list):
        errors.append("'metrics' must be a list")
    else:
        for i, m in enumerate(metrics):
            errors.extend(validate_metric(m, where=f"metrics[{i}]"))
    return errors


def validate_bench_record(rec: object) -> list[str]:
    """Validate a bench.py output record (the headline JSON line)."""
    if not isinstance(rec, dict):
        return [f"bench record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if not isinstance(rec.get("metric"), str) or not rec.get("metric"):
        errors.append("missing/invalid 'metric' (str)")
    if not _is_number(rec.get("value")):
        errors.append("missing numeric 'value'")
    if not isinstance(rec.get("unit"), str):
        errors.append("missing/invalid 'unit' (str)")
    if not _is_number(rec.get("vs_baseline")):
        errors.append("missing numeric 'vs_baseline'")
    for key, types in _BENCH_OPTIONAL.items():
        if key in rec and not _bench_type_ok(rec[key], types):
            errors.append(
                f"{key!r} must be {'/'.join(t.__name__ for t in types)}, "
                f"got {type(rec[key]).__name__}"
            )
    if "mfu" in rec and _is_number(rec["mfu"]) and not 0 <= rec["mfu"] <= 1:
        errors.append(f"'mfu' out of range [0, 1]: {rec['mfu']!r}")
    at = rec.get("autotune")
    if isinstance(at, dict) and at.get("schema") == AUTOTUNE_SCHEMA:
        errors.extend(
            f"autotune: {e}" for e in validate_autotune_record(at)
        )
    return errors


def validate_status_record(rec: object) -> list[str]:
    """Validate one live-export ``/status`` snapshot (schema
    "fluxmpi_tpu.status/v1", produced by
    ``telemetry/export.Exporter.build_status`` and consumed by
    ``scripts/fluxmpi_top.py``); returns a list of error strings."""
    if not isinstance(rec, dict):
        return [f"status record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != STATUS_SCHEMA:
        errors.append(
            f"'schema' must be {STATUS_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    proc = rec.get("process")
    if not isinstance(proc, int) or isinstance(proc, bool) or proc < 0:
        errors.append("'process' must be an int >= 0")
    if not isinstance(rec.get("run_id"), str) or not rec.get("run_id"):
        errors.append("missing/invalid 'run_id' (str)")
    pc = rec.get("process_count")
    if not isinstance(pc, int) or isinstance(pc, bool) or pc < 1:
        errors.append("'process_count' must be an int >= 1")
    for key in ("train", "monitor", "watchdog"):
        if not isinstance(rec.get(key), dict):
            errors.append(f"'{key}' must be an object")
    for key in (
        "goodput",
        "anomaly",
        "serving",
        "model",
        "parallel",
        "fleet",
        "autotune",
        "checkpoint",
        "resize",
    ):
        v = rec.get(key)
        if v is not None and not isinstance(v, dict):
            errors.append(f"'{key}' must be null or an object")
    health = rec.get("health")
    if not isinstance(health, dict):
        errors.append("'health' must be an object")
    else:
        if not isinstance(health.get("healthy"), bool):
            errors.append("health: 'healthy' must be a bool")
        if not _is_number(health.get("seconds_since_progress")):
            errors.append("health: missing numeric 'seconds_since_progress'")
        if not _is_number(health.get("deadline_seconds")):
            errors.append("health: missing numeric 'deadline_seconds'")
    return errors


def validate_resize_record(rec: object) -> list[str]:
    """Validate one live-resize event record (schema
    "fluxmpi_tpu.resize/v1", started by the draining world's handoff
    stamp and completed by the resumed world —
    ``fleet/resize.py``); returns a list of error strings (empty ==
    valid).

    ``phases`` must carry a number >= 0 for every name in
    :data:`RESIZE_PHASES` — a resize that skipped a phase reports 0.0
    for it, never omits it (post-mortem tooling sums columns)."""
    if not isinstance(rec, dict):
        return [f"resize record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != RESIZE_SCHEMA:
        errors.append(
            f"'schema' must be {RESIZE_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    for key in ("from_processes", "to_processes"):
        v = rec.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errors.append(f"'{key}' must be an int >= 1")
    step = rec.get("step")
    if not isinstance(step, int) or isinstance(step, bool) or step < 0:
        errors.append("'step' must be an int >= 0")
    reason = rec.get("reason")
    if reason is not None and (not isinstance(reason, str) or not reason):
        errors.append("'reason' must be null or a non-empty str")
    phases = rec.get("phases")
    if not isinstance(phases, dict):
        errors.append("'phases' must be an object")
    else:
        for name in RESIZE_PHASES:
            v = phases.get(name)
            if not _is_number(v) or v < 0:
                errors.append(
                    f"phases: missing numeric '{name}' >= 0 (every "
                    f"RESIZE_PHASES entry is required)"
                )
        for name in phases:
            if name not in RESIZE_PHASES:
                errors.append(
                    f"phases: unknown phase {name!r} "
                    f"(must be one of {RESIZE_PHASES})"
                )
    total = rec.get("badput_seconds")
    if not _is_number(total) or total < 0:
        errors.append("'badput_seconds' must be a number >= 0")
    elif isinstance(phases, dict) and all(
        _is_number(phases.get(n)) for n in RESIZE_PHASES
    ):
        s = sum(float(phases[n]) for n in RESIZE_PHASES)
        if abs(s - float(total)) > max(1e-6, 1e-3 * s):
            errors.append(
                f"'badput_seconds' ({total}) must equal the sum of "
                f"'phases' ({s})"
            )
    return errors


def validate_request_record(rec: object) -> list[str]:
    """Validate one per-request terminal record (schema
    "fluxmpi_tpu.request/v1", produced by ``serving/observe.RequestLog``
    and aggregated by ``scripts/serving_report.py``); returns a list of
    error strings (empty == valid).

    A record is written exactly once per request, at its terminal
    transition: ``status`` is "finished" (natural completion) or
    "rejected" (admission reject, drain, preemption, or engine failure —
    ``reason`` says which). Latency fields are null when the request
    never reached the stage that defines them (a queue-rejected request
    has no TTFT)."""
    if not isinstance(rec, dict):
        return [f"request record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != REQUEST_SCHEMA:
        errors.append(
            f"'schema' must be {REQUEST_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    proc = rec.get("process")
    if not isinstance(proc, int) or isinstance(proc, bool) or proc < 0:
        errors.append("'process' must be an int >= 0")
    rid = rec.get("request_id")
    if not isinstance(rid, int) or isinstance(rid, bool) or rid < 0:
        errors.append("'request_id' must be an int >= 0")
    status = rec.get("status")
    if status not in REQUEST_STATUSES:
        errors.append(
            f"'status' must be one of {REQUEST_STATUSES}, got {status!r}"
        )
    reason = rec.get("reason")
    if reason is not None and (not isinstance(reason, str) or not reason):
        errors.append("'reason' must be null or a non-empty str")
    if status == "rejected" and not (isinstance(reason, str) and reason):
        errors.append("rejected record needs a non-empty 'reason'")
    for key in ("prompt_tokens", "output_tokens", "kv_blocks"):
        v = rec.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errors.append(f"'{key}' must be an int >= 0")
    for key in ("queue_wait_s", "ttft_s", "per_token_s", "total_s"):
        v = rec.get(key)
        if v is not None and (not _is_number(v) or v < 0):
            errors.append(f"'{key}' must be null or a number >= 0")
    if not isinstance(rec.get("slo_ok"), bool):
        errors.append("'slo_ok' must be a bool")
    viol = rec.get("slo_violations")
    if not isinstance(viol, list) or not all(
        isinstance(k, str) and k for k in viol
    ):
        errors.append("'slo_violations' must be a list of non-empty str")
    return errors


def validate_fleet_snapshot(rec: object) -> list[str]:
    """Validate one fleet-plane snapshot (schema "fluxmpi_tpu.fleet/v1",
    produced by ``telemetry/fleet.FleetCollector.snapshot`` — and, one
    per collection interval, appended to the JSONL bank
    ``scripts/fleet_report.py`` replays); returns a list of error
    strings (empty == valid).

    ``hosts`` maps each scrape target to its census row: ``alive`` (the
    last scrape succeeded), ``stale_seconds`` (age of the last GOOD
    scrape — null until one has ever succeeded), and whatever identity
    and signal fields that scrape yielded. ``attribution`` is the
    interval's verdict: the blamed target (null = no straggler this
    interval), its cause (one of STRAGGLER_CAUSES), the step-time skew
    that triggered the blame, and the current same-host streak length.
    ``stragglers`` is the run-cumulative verdict count per cause."""
    if not isinstance(rec, dict):
        return [f"fleet snapshot is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != FLEET_SCHEMA:
        errors.append(
            f"'schema' must be {FLEET_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    collects = rec.get("collects")
    if not isinstance(collects, int) or isinstance(collects, bool):
        errors.append("'collects' must be an int")
    elif collects < 1:
        errors.append("'collects' must be >= 1")
    hosts = rec.get("hosts")
    if not isinstance(hosts, dict) or not hosts:
        errors.append("'hosts' must be a non-empty object")
    else:
        for target, row in hosts.items():
            where = f"hosts[{target!r}]"
            if not isinstance(target, str) or not target:
                errors.append(f"{where}: target must be a non-empty str")
            if not isinstance(row, dict):
                errors.append(f"{where}: must be an object")
                continue
            if not isinstance(row.get("alive"), bool):
                errors.append(f"{where}: 'alive' must be a bool")
            stale = row.get("stale_seconds")
            if stale is not None and (not _is_number(stale) or stale < 0):
                errors.append(
                    f"{where}: 'stale_seconds' must be null or >= 0"
                )
            if row.get("alive") and stale is None:
                errors.append(
                    f"{where}: an alive host must carry 'stale_seconds'"
                )
    attr = rec.get("attribution")
    if not isinstance(attr, dict):
        errors.append("'attribution' must be an object")
    else:
        straggler = attr.get("straggler")
        if straggler is not None and (
            not isinstance(straggler, str) or not straggler
        ):
            errors.append(
                "attribution: 'straggler' must be null or a non-empty str"
            )
        cause = attr.get("cause")
        if straggler is None:
            if cause is not None:
                errors.append(
                    "attribution: 'cause' must be null without a straggler"
                )
        elif cause not in STRAGGLER_CAUSES:
            errors.append(
                f"attribution: 'cause' must be one of {STRAGGLER_CAUSES}, "
                f"got {cause!r}"
            )
        streak = attr.get("streak")
        if not isinstance(streak, int) or isinstance(streak, bool) or (
            streak < 0
        ):
            errors.append("attribution: 'streak' must be an int >= 0")
    totals = rec.get("stragglers")
    if not isinstance(totals, dict):
        errors.append("'stragglers' must be an object")
    else:
        for cause, n in totals.items():
            if cause not in STRAGGLER_CAUSES:
                errors.append(
                    f"stragglers: unknown cause {cause!r} "
                    f"(known: {STRAGGLER_CAUSES})"
                )
            if not isinstance(n, int) or isinstance(n, bool) or n < 0:
                errors.append(
                    f"stragglers[{cause!r}]: count must be an int >= 0"
                )
    return errors


def validate_autotune_record(rec: object) -> list[str]:
    """Validate one layout-autotuner record (schema
    "fluxmpi_tpu.autotune/v1", produced by
    ``parallel/autotune.autotune`` — the bank file, the checkpoint
    sidecar, and the bench's embedded ``autotune`` block all carry the
    same shape); returns a list of error strings (empty == valid).

    The internal consistency rules ARE the bank contract: a ``pruned``
    candidate (reason in AUTOTUNE_PRUNE_REASONS) must carry no trial, an
    unpruned one must carry its trial evidence, ``trials`` must equal
    the unpruned count, and the ``winner`` must be one of the trialed
    candidates — a record violating any of these was not produced by a
    completed search and must not short-circuit one."""
    if not isinstance(rec, dict):
        return [f"autotune record is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != AUTOTUNE_SCHEMA:
        errors.append(
            f"'schema' must be {AUTOTUNE_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    fp = rec.get("model_fingerprint")
    if not isinstance(fp, str) or not fp:
        errors.append("missing/invalid 'model_fingerprint' (non-empty str)")
    topo = rec.get("topology")
    if not isinstance(topo, dict):
        errors.append("'topology' must be an object")
    else:
        nd = topo.get("n_devices")
        if not isinstance(nd, int) or isinstance(nd, bool) or nd < 1:
            errors.append("topology: 'n_devices' must be an int >= 1")
        if not isinstance(topo.get("device_kind"), str) or not topo.get(
            "device_kind"
        ):
            errors.append(
                "topology: 'device_kind' must be a non-empty str"
            )
        pc = topo.get("process_count")
        if not isinstance(pc, int) or isinstance(pc, bool) or pc < 1:
            errors.append("topology: 'process_count' must be an int >= 1")
    fsdp_min = rec.get("fsdp_min_size")
    if not isinstance(fsdp_min, int) or isinstance(fsdp_min, bool) or (
        fsdp_min < 0
    ):
        errors.append("'fsdp_min_size' must be an int >= 0")

    def _axes_ok(axes: object, where: str) -> bool:
        if not isinstance(axes, dict) or not axes:
            errors.append(f"{where}: 'axes' must be a non-empty object")
            return False
        ok = True
        for axis, size in axes.items():
            if not isinstance(axis, str) or not axis:
                errors.append(f"{where}: axes keys must be non-empty str")
                ok = False
            if not isinstance(size, int) or isinstance(size, bool) or (
                size < 1
            ):
                errors.append(
                    f"{where}: axes[{axis!r}] must be an int >= 1"
                )
                ok = False
        return ok

    winner = rec.get("winner")
    winner_axes = None
    if not isinstance(winner, dict):
        errors.append("'winner' must be an object")
    else:
        if _axes_ok(winner.get("axes"), "winner"):
            winner_axes = winner.get("axes")
        names = winner.get("axis_names")
        if not isinstance(names, dict) or not all(
            isinstance(k, str) and isinstance(v, str) and k and v
            for k, v in names.items()
        ):
            errors.append(
                "winner: 'axis_names' must map non-empty str -> str"
            )
    trials = rec.get("trials")
    if not isinstance(trials, int) or isinstance(trials, bool) or trials < 1:
        errors.append("'trials' must be an int >= 1")
    cands = rec.get("candidates")
    trialed = 0
    winner_trialed = False
    if not isinstance(cands, list) or not cands:
        errors.append("'candidates' must be a non-empty list")
    else:
        for i, cand in enumerate(cands):
            where = f"candidates[{i}]"
            if not isinstance(cand, dict):
                errors.append(f"{where}: must be an object")
                continue
            _axes_ok(cand.get("axes"), where)
            for key in ("mem_bytes_per_device", "score"):
                v = cand.get(key)
                if v is not None and (not _is_number(v) or v < 0):
                    errors.append(
                        f"{where}: {key!r} must be null or a number >= 0"
                    )
            pruned = cand.get("pruned")
            trial = cand.get("trial")
            if pruned is not None:
                if pruned not in AUTOTUNE_PRUNE_REASONS:
                    errors.append(
                        f"{where}: 'pruned' must be null or one of "
                        f"{AUTOTUNE_PRUNE_REASONS}, got {pruned!r}"
                    )
                if trial is not None:
                    errors.append(
                        f"{where}: a pruned candidate must carry no "
                        f"'trial' (got one — prune/trial disagree)"
                    )
                continue
            trialed += 1
            if not isinstance(trial, dict):
                errors.append(
                    f"{where}: an unpruned candidate must carry its "
                    f"'trial' evidence object"
                )
                continue
            for key in ("examples_per_sec", "compile_seconds", "seconds"):
                v = trial.get(key)
                if not _is_number(v) or v < 0:
                    errors.append(
                        f"{where}: trial {key!r} must be a number >= 0"
                    )
            sc = trial.get("steady_compiles")
            if not isinstance(sc, int) or isinstance(sc, bool) or sc < 0:
                errors.append(
                    f"{where}: trial 'steady_compiles' must be an "
                    f"int >= 0"
                )
            if winner_axes is not None and cand.get("axes") == winner_axes:
                winner_trialed = True
        if isinstance(trials, int) and not isinstance(trials, bool) and (
            trials != trialed
        ):
            errors.append(
                f"'trials' is {trials} but {trialed} candidate(s) carry "
                f"trial evidence"
            )
        if winner_axes is not None and not winner_trialed:
            errors.append(
                "'winner' axes match no trialed (unpruned) candidate"
            )
    return errors


# ---------------------------------------------------------------------------
# Checkpoint manifest (schema "fluxmpi_tpu.manifest/v1"): the topology
# sidecar every save writes next to the commit marker — global leaf
# shapes/dtypes/partition specs, the save-time mesh and process count,
# the loader position + batch geometry, and the loop counters. Elastic
# restore (docs/fault_tolerance.md, "Elastic resume") reads it to build
# the resharding template; this validator is what
# scripts/check_metrics_schema.py runs against manifest.json files.
# ---------------------------------------------------------------------------

MANIFEST_LAYOUTS = ("replicated", "sharded")

# Loader-geometry keys an elastic resume needs (ints); the three position
# keys are always present, the geometry keys ride along from PR 6 on.
_MANIFEST_LOADER_REQUIRED = ("epoch", "cursor", "seed")
_MANIFEST_LOADER_OPTIONAL = (
    "global_batch_size",
    "num_batches",
    "process_count",
    "elastic_order",
)

_MANIFEST_COUNTER_KEYS = ("updates", "examples", "epochs")


def _is_int(x: object) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _validate_manifest_spec(spec: object, ndim: int, where: str) -> list[str]:
    """One leaf's partition spec: null (replicated) or a per-dimension
    list of null | axis name | list of axis names, no longer than the
    leaf's rank."""
    if spec is None:
        return []
    if not isinstance(spec, list):
        return [f"{where}: 'spec' must be null or a list, got {spec!r}"]
    errors: list[str] = []
    if len(spec) > ndim:
        errors.append(
            f"{where}: 'spec' has {len(spec)} entries for a rank-{ndim} leaf"
        )
    for d, names in enumerate(spec):
        if names is None or (isinstance(names, str) and names):
            continue
        if isinstance(names, list) and names and all(
            isinstance(n, str) and n for n in names
        ):
            continue
        errors.append(
            f"{where}: spec[{d}] must be null, an axis name, or a "
            f"non-empty list of axis names, got {names!r}"
        )
    return errors


def validate_manifest(rec: object) -> list[str]:
    """Validate a checkpoint manifest (schema "fluxmpi_tpu.manifest/v1");
    returns a list of error strings (empty == valid)."""
    if not isinstance(rec, dict):
        return [f"manifest is not an object: {type(rec).__name__}"]
    errors: list[str] = []
    if rec.get("schema") != MANIFEST_SCHEMA:
        errors.append(
            f"'schema' must be {MANIFEST_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    if rec.get("layout") not in MANIFEST_LAYOUTS:
        errors.append(
            f"'layout' must be one of {MANIFEST_LAYOUTS}, "
            f"got {rec.get('layout')!r}"
        )
    if not _is_int(rec.get("process_count")) or rec["process_count"] < 1:
        errors.append("'process_count' must be an int >= 1")
    step = rec.get("step")
    if step is not None and not _is_int(step):
        errors.append("'step' must be an int or null")
    mesh = rec.get("mesh")
    if mesh is not None:
        axes = mesh.get("axes") if isinstance(mesh, dict) else None
        if not isinstance(axes, dict) or not axes or not all(
            isinstance(k, str) and k and _is_int(v) and v >= 1
            for k, v in axes.items()
        ):
            errors.append(
                "'mesh' must be null or {'axes': {name: size >= 1, ...}}, "
                f"got {mesh!r}"
            )
    leaves = rec.get("leaves")
    if not isinstance(leaves, list):
        errors.append("'leaves' must be a list")
        leaves = []
    seen_paths: set[str] = set()
    for i, leaf in enumerate(leaves):
        lw = f"leaves[{i}]"
        if not isinstance(leaf, dict):
            errors.append(f"{lw}: not an object")
            continue
        path = leaf.get("path")
        if not isinstance(path, str) or not path:
            errors.append(f"{lw}: missing/invalid 'path' (str)")
        elif path in seen_paths:
            errors.append(f"{lw}: duplicate leaf path {path!r}")
        else:
            seen_paths.add(path)
        shape = leaf.get("shape")
        if not isinstance(shape, list) or not all(
            _is_int(d) and d >= 0 for d in shape
        ):
            errors.append(f"{lw}: 'shape' must be a list of ints >= 0")
            shape = []
        if not isinstance(leaf.get("dtype"), str) or not leaf.get("dtype"):
            errors.append(f"{lw}: missing/invalid 'dtype' (str)")
        errors.extend(
            _validate_manifest_spec(leaf.get("spec"), len(shape), lw)
        )
    loader = rec.get("loader")
    if loader is not None:
        if not isinstance(loader, dict):
            errors.append(f"'loader' must be null or an object, got {loader!r}")
        else:
            for key in _MANIFEST_LOADER_REQUIRED:
                if not _is_int(loader.get(key)):
                    errors.append(f"loader: missing int {key!r}")
            for key in _MANIFEST_LOADER_OPTIONAL:
                if key in loader and not _is_int(loader[key]):
                    errors.append(f"loader: {key!r} must be an int")
    counters = rec.get("counters")
    if counters is not None:
        if not isinstance(counters, dict):
            errors.append(
                f"'counters' must be null or an object, got {counters!r}"
            )
        else:
            for key in _MANIFEST_COUNTER_KEYS:
                if not _is_int(counters.get(key)):
                    errors.append(f"counters: missing int {key!r}")
    parallel = rec.get("parallel")
    if parallel is not None:
        # The ParallelConfig that produced the specs (parallel/plan.py):
        # plan-axis sizes plus the plan-axis → mesh-axis name map, so a
        # restore can rebuild the SAME composed layout declaratively.
        if not isinstance(parallel, dict):
            errors.append(
                f"'parallel' must be null or an object, got {parallel!r}"
            )
        else:
            axes = parallel.get("axes")
            if not isinstance(axes, dict) or not axes or not all(
                isinstance(k, str) and k and _is_int(v) and v >= 1
                for k, v in axes.items()
            ):
                errors.append(
                    "parallel: 'axes' must map plan axis -> size >= 1"
                )
            names = parallel.get("axis_names")
            if not isinstance(names, dict) or not all(
                isinstance(k, str) and isinstance(v, str) and v
                for k, v in names.items()
            ):
                errors.append(
                    "parallel: 'axis_names' must map plan axis -> mesh "
                    "axis name"
                )
            fp = parallel.get("autotune_fingerprint")
            if fp is not None and (not isinstance(fp, str) or not fp):
                # Present only when the layout autotuner picked this
                # plan: the model fingerprint keying its banked record
                # (the <ckpt>.autotune.json sidecar carries the table).
                errors.append(
                    "parallel: 'autotune_fingerprint' must be null or a "
                    "non-empty str"
                )
    return errors


# ---------------------------------------------------------------------------
# Trace plane (schema "fluxmpi_tpu.trace/v1"): span exports, the collective
# flight recorder, and watchdog hang dumps.
# ---------------------------------------------------------------------------

_TRACE_PHASES = ("X", "i", "I", "M", "C")


def _validate_trace_header(rec: dict, kind: str) -> list[str]:
    errors: list[str] = []
    if rec.get("schema") != TRACE_SCHEMA:
        errors.append(
            f"'schema' must be {TRACE_SCHEMA!r}, got {rec.get('schema')!r}"
        )
    if rec.get("kind") != kind:
        errors.append(f"'kind' must be {kind!r}, got {rec.get('kind')!r}")
    if not _is_number(rec.get("time_unix")):
        errors.append("missing numeric 'time_unix'")
    proc = rec.get("process")
    if not isinstance(proc, int) or isinstance(proc, bool) or proc < 0:
        errors.append("'process' must be an int >= 0")
    return errors


def validate_trace_event(ev: object, where: str = "traceEvents[]") -> list[str]:
    """Validate one Chrome-trace event object."""
    if not isinstance(ev, dict):
        return [f"{where}: not an object: {ev!r}"]
    errors: list[str] = []
    if not isinstance(ev.get("name"), str) or not ev.get("name"):
        errors.append(f"{where}: missing/invalid 'name'")
    ph = ev.get("ph")
    if ph not in _TRACE_PHASES:
        errors.append(
            f"{where}: 'ph' must be one of {_TRACE_PHASES}, got {ph!r}"
        )
        return errors
    if ph != "M":  # metadata events carry no timestamp
        if not _is_number(ev.get("ts")):
            errors.append(f"{where}: missing numeric 'ts'")
        for key in ("pid", "tid"):
            v = ev.get(key)
            if not isinstance(v, int) or isinstance(v, bool):
                errors.append(f"{where}: {key!r} must be an int")
    if ph == "X":
        dur = ev.get("dur")
        if not _is_number(dur) or dur < 0:
            errors.append(f"{where}: 'X' event needs numeric 'dur' >= 0")
    args = ev.get("args")
    if args is not None and not isinstance(args, dict):
        errors.append(f"{where}: 'args' must be an object")
    if ev.get("name") == PREEMPTION_EVENT:
        if ph not in ("i", "I"):
            errors.append(
                f"{where}: {PREEMPTION_EVENT!r} must be an instant "
                f"('i'/'I'), got ph={ph!r}"
            )
        if not isinstance(args, dict) or not _is_number(args.get("step")):
            errors.append(
                f"{where}: {PREEMPTION_EVENT!r} needs numeric args.step "
                f"(the update count banked at preemption)"
            )
    name = ev.get("name")
    if isinstance(name, str) and name.startswith(ANOMALY_EVENT_PREFIX):
        if ph not in ("i", "I"):
            errors.append(
                f"{where}: {name!r} must be an instant ('i'/'I'), "
                f"got ph={ph!r} — an anomaly trigger is a point in time"
            )
        if not isinstance(args, dict) or not _is_number(args.get("step")):
            errors.append(
                f"{where}: {name!r} needs numeric args.step (the update "
                f"count at the triggering flush)"
            )
        if not isinstance(args, dict) or not isinstance(
            args.get("rule"), str
        ) or not args.get("rule"):
            errors.append(f"{where}: {name!r} needs args.rule (str)")
    return errors


def validate_trace_export(rec: object) -> list[str]:
    """Validate a trace export file (kind="trace") — our metadata header
    plus a Chrome-trace ``traceEvents`` list (the part Perfetto loads)."""
    if not isinstance(rec, dict):
        return [f"trace export is not an object: {type(rec).__name__}"]
    errors = _validate_trace_header(rec, "trace")
    events = rec.get("traceEvents")
    if not isinstance(events, list):
        errors.append("'traceEvents' must be a list")
        return errors
    for i, ev in enumerate(events):
        errors.extend(validate_trace_event(ev, where=f"traceEvents[{i}]"))
    return errors


def validate_flight_dump(rec: object, where: str = "flight_recorder") -> list[str]:
    """Validate a flight-recorder dump (kind="flight_recorder"). Entry
    ``seq`` numbers must be strictly increasing — the cross-host diff
    keys on them."""
    if not isinstance(rec, dict):
        return [f"{where}: not an object: {type(rec).__name__}"]
    errors = _validate_trace_header(rec, "flight_recorder")
    for key in ("sequence", "completed", "capacity"):
        v = rec.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errors.append(f"{where}: {key!r} must be an int >= 0")
    entries = rec.get("entries")
    if not isinstance(entries, list):
        errors.append(f"{where}: 'entries' must be a list")
        return errors
    prev_seq = 0
    for i, e in enumerate(entries):
        ew = f"{where}: entries[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{ew}: not an object")
            continue
        seq = e.get("seq")
        if not isinstance(seq, int) or isinstance(seq, bool) or seq < 1:
            errors.append(f"{ew}: 'seq' must be an int >= 1")
        elif seq <= prev_seq:
            errors.append(
                f"{ew}: 'seq' {seq} not strictly increasing (prev {prev_seq})"
            )
        else:
            prev_seq = seq
        for key in ("op", "path"):
            if not isinstance(e.get(key), str) or not e.get(key):
                errors.append(f"{ew}: missing/invalid {key!r} (str)")
        if not _is_number(e.get("nbytes")) or e.get("nbytes") < 0:
            errors.append(f"{ew}: 'nbytes' must be a number >= 0")
        if not _is_number(e.get("time_unix")):
            errors.append(f"{ew}: missing numeric 'time_unix'")
        if not isinstance(e.get("completed"), bool):
            errors.append(f"{ew}: 'completed' must be a bool")
        dur = e.get("duration")
        if dur is not None and not _is_number(dur):
            errors.append(f"{ew}: 'duration' must be a number or null")
    return errors


def validate_watchdog_dump(rec: object) -> list[str]:
    """Validate a watchdog hang dump (kind="watchdog_dump")."""
    if not isinstance(rec, dict):
        return [f"watchdog dump is not an object: {type(rec).__name__}"]
    errors = _validate_trace_header(rec, "watchdog_dump")
    if not isinstance(rec.get("reason"), str) or not rec.get("reason"):
        errors.append("missing/invalid 'reason' (str)")
    pid = rec.get("pid")
    if not isinstance(pid, int) or isinstance(pid, bool) or pid <= 0:
        errors.append("'pid' must be a positive int")
    threads = rec.get("threads")
    if not isinstance(threads, list) or not threads:
        errors.append("'threads' must be a non-empty list")
    else:
        for i, t in enumerate(threads):
            tw = f"threads[{i}]"
            if not isinstance(t, dict):
                errors.append(f"{tw}: not an object")
                continue
            if not isinstance(t.get("thread_id"), int):
                errors.append(f"{tw}: 'thread_id' must be an int")
            stack = t.get("stack")
            if not isinstance(stack, list):
                errors.append(f"{tw}: 'stack' must be a list")
                continue
            for j, fr in enumerate(stack):
                fw = f"{tw}.stack[{j}]"
                if not isinstance(fr, dict):
                    errors.append(f"{fw}: not an object")
                    continue
                if not isinstance(fr.get("file"), str):
                    errors.append(f"{fw}: missing 'file' (str)")
                if not isinstance(fr.get("line"), int):
                    errors.append(f"{fw}: missing 'line' (int)")
                if not isinstance(fr.get("function"), str):
                    errors.append(f"{fw}: missing 'function' (str)")
    fr_dump = rec.get("flight_recorder")
    if fr_dump is not None:
        errors.extend(validate_flight_dump(fr_dump))
    spans = rec.get("open_spans")
    if not isinstance(spans, list):
        errors.append("'open_spans' must be a list")
    else:
        for i, s in enumerate(spans):
            if not isinstance(s, dict) or not isinstance(
                s.get("thread_id"), int
            ) or not isinstance(s.get("spans"), list):
                errors.append(
                    f"open_spans[{i}]: must be "
                    "{'thread_id': int, 'spans': [...]}"
                )
    flush = rec.get("registry_flush")
    if flush is not None:
        for e in validate_record(flush):
            errors.append(f"registry_flush: {e}")
    anomaly = rec.get("anomaly")
    if anomaly is not None:
        # An anomaly diagnostics bundle: the same dump record with the
        # triggering event attached (telemetry/anomaly.py).
        if not isinstance(anomaly, dict):
            errors.append(f"'anomaly' must be an object, got {anomaly!r}")
        else:
            if not isinstance(anomaly.get("rule"), str) or not anomaly.get(
                "rule"
            ):
                errors.append("anomaly: missing 'rule' (str)")
            if not isinstance(anomaly.get("action"), str):
                errors.append("anomaly: missing 'action' (str)")
            step = anomaly.get("step")
            if step is not None and not _is_number(step):
                errors.append("anomaly: 'step' must be a number or null")
    oom = rec.get("oom")
    if oom is not None:
        # An OOM forensics bundle (telemetry/memory.py): the same dump
        # record with the failing error, the live-array census, and the
        # per-device HBM stats attached.
        errors.extend(_validate_oom_section(oom))
    return errors


def _validate_oom_section(oom: object) -> list[str]:
    """The ``oom`` section of an OOM forensics bundle
    (``fluxmpi_oom.<process>.json``, written by
    ``telemetry/memory.write_oom_bundle``): the RESOURCE_EXHAUSTED
    error string, the :func:`jax.live_arrays` census (top-N buffers by
    nbytes with shape/dtype/sharding), normalized per-device memory
    stats, and the process-lifetime peak watermark."""
    if not isinstance(oom, dict):
        return [f"'oom' must be an object, got {oom!r}"]
    errors: list[str] = []
    if not isinstance(oom.get("error"), str) or not oom.get("error"):
        errors.append("oom: missing 'error' (str)")
    census = oom.get("census")
    if not isinstance(census, dict):
        errors.append("oom: 'census' must be an object")
    else:
        for key in ("count", "total_bytes"):
            v = census.get(key)
            if not _is_int(v) or v < 0:
                errors.append(f"oom: census {key!r} must be an int >= 0")
        arrays = census.get("arrays")
        if not isinstance(arrays, list):
            errors.append("oom: census 'arrays' must be a list")
            arrays = []
        for i, a in enumerate(arrays):
            aw = f"oom: census arrays[{i}]"
            if not isinstance(a, dict):
                errors.append(f"{aw}: not an object")
                continue
            if not _is_int(a.get("nbytes")) or a["nbytes"] < 0:
                errors.append(f"{aw}: 'nbytes' must be an int >= 0")
            shape = a.get("shape")
            if not isinstance(shape, list) or not all(
                _is_int(d) and d >= 0 for d in shape
            ):
                errors.append(f"{aw}: 'shape' must be a list of ints >= 0")
            if not isinstance(a.get("dtype"), str) or not a.get("dtype"):
                errors.append(f"{aw}: missing 'dtype' (str)")
    devices = oom.get("devices")
    if not isinstance(devices, dict):
        errors.append("oom: 'devices' must be an object")
    else:
        for dev, stats in devices.items():
            if not isinstance(dev, str) or not isinstance(stats, dict) or not all(
                isinstance(k, str) and _is_number(v)
                for k, v in stats.items()
            ):
                errors.append(
                    f"oom: devices[{dev!r}] must map str stat keys to numbers"
                )
    watermark = oom.get("peak_watermark_bytes")
    if watermark is not None and (
        not _is_number(watermark) or watermark < 0
    ):
        errors.append("oom: 'peak_watermark_bytes' must be a number >= 0")
    return errors


def validate_trace_file(rec: object) -> list[str]:
    """Dispatch a trace-plane record (schema "fluxmpi_tpu.trace/v1") to
    the validator matching its ``kind``."""
    if not isinstance(rec, dict):
        return [f"record is not an object: {type(rec).__name__}"]
    kind = rec.get("kind")
    if kind == "trace":
        return validate_trace_export(rec)
    if kind == "flight_recorder":
        return validate_flight_dump(rec)
    if kind == "watchdog_dump":
        return validate_watchdog_dump(rec)
    return [
        f"'kind' must be 'trace', 'flight_recorder', or 'watchdog_dump', "
        f"got {kind!r}"
    ]
