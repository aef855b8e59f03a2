"""The port's serving plane, ported from the JAX package's
``tests/test_serving.py`` (the cases that need no exporter, anomaly or
compile plane): the memory-plane admission check, the attention switch,
admission control and load shedding, static against continuous batching,
streaming and latency accounting, SLO violations, the preemption drain,
the ``serving.admit``/``serving.decode`` fault sites, the watchdog's
progress clock, the ``serving.*`` metrics, fleet defaults from
``configure``/``init``/the environment, background serving and its error
path, teardown, and the request-observability plane (burn windows, the
request log, spans, the load-shed bundle) through the stdlib scripts. The
reference for streams is the port's own ``generate()`` (itself held to
JAX's token for token in ``tests/test_torch_serving.py``).

The last test runs the same scripted traffic (prompts, a shed queue, an
SLO some requests break, a preemption raised mid-run, injected clocks)
through the JAX engine and the port's on converted weights: summaries,
statuses, reject reasons, tokens, request-log records (``time_unix``
removed) and the ``serving.*`` metrics must be equal."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import faults, runtime, serving
from fluxmpi_tpu_torch.errors import FaultInjectedError, RequestRejectedError
from fluxmpi_tpu_torch.models import TransformerLM, generate, load_flax_params
from fluxmpi_tpu_torch.serving import BlockKVCache, InferenceEngine, observe
from fluxmpi_tpu_torch.telemetry import MetricsRegistry, get_registry, tracing
from fluxmpi_tpu_torch.telemetry.schema import (KNOWN_METRIC_NAMES, validate_metric,
                                                validate_record)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 97
CFG = dict(vocab_size=VOCAB, max_len=64, num_layers=2, d_model=32, num_heads=4,
           d_ff=64)


@pytest.fixture(scope="module")
def lm():
    return TransformerLM(**CFG, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture()
def engine_factory(lm):
    built = []

    def make(**kwargs):
        kwargs.setdefault("slots", 2)
        kwargs.setdefault("block_size", 8)
        eng = InferenceEngine(lm, **kwargs)
        built.append(eng)
        return eng

    yield make
    for eng in built:
        eng.close()
    serving.shutdown()
    observe.shutdown()
    runtime.clear_preemption()
    get_registry().reset()


def _prompt(rng, n):
    return rng.integers(0, VOCAB, size=(n,)).astype(np.int32)


def _ref(lm, req, n=None):
    n = req.max_new_tokens if n is None else n
    return generate(lm, req.prompt[None], n)[0, len(req.prompt):].numpy()


def _snap(reg=None, name=None):
    reg = get_registry() if reg is None else reg
    return {(m["name"], tuple(sorted(m["labels"].items()))): m
            for m in reg.snapshot() if name is None or m["name"] == name}


def _script(*args, timeout=60):
    proc = subprocess.run([sys.executable, *map(str, args)], capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


# ---------------------------------------------------------------------------
# Cache, construction, attention switch
# ---------------------------------------------------------------------------


def test_memory_plane_admission_check(lm, monkeypatch):
    """A pool that cannot fit beside what the device holds refuses at
    construction, by the memory plane's ``bytes_limit``; a device without
    stats (the CPU) has nothing to check; ``check_memory=False`` skips it."""
    from fluxmpi_tpu_torch.telemetry import memory as memory_mod

    monkeypatch.setattr(memory_mod, "device_memory_stats",
                        lambda d: {"bytes_limit": 1024.0, "bytes_in_use": 0.0})
    with pytest.raises(RuntimeError, match="device memory"):
        InferenceEngine(lm, slots=2, block_size=8)
    InferenceEngine(lm, slots=2, block_size=8, check_memory=False).close()
    # The limit counts what is already in use: 8 KiB in use + the pool.
    need = BlockKVCache(num_layers=2, num_heads=4, head_dim=8, num_blocks=17,
                        block_size=8, max_blocks_per_seq=8, device="cpu").pool_bytes
    monkeypatch.setattr(memory_mod, "device_memory_stats",
                        lambda d: {"bytes_limit": need + 8192.0, "bytes_in_use": 8192.0})
    InferenceEngine(lm, slots=2, block_size=8).close()
    monkeypatch.setattr(memory_mod, "device_memory_stats",
                        lambda d: {"bytes_limit": need + 8191.0, "bytes_in_use": 8192.0})
    with pytest.raises(RuntimeError, match="in-use"):
        InferenceEngine(lm, slots=2, block_size=8)
    serving.shutdown()
    monkeypatch.setattr(memory_mod, "device_memory_stats", lambda d: {})
    InferenceEngine(lm, slots=2, block_size=8).close()


def test_engine_attention_option_validation(lm, monkeypatch):
    """An unknown mode raises, a model without the switch raises a named
    error, the environment default reaches the engine, and the mode is
    passed to the model's own switch on every call (a naive model served
    with ``attention="flash"`` decodes through the flash wrapper and
    streams ``generate()``'s tokens)."""
    from fluxmpi_tpu_torch.models import transformer

    with pytest.raises(ValueError, match="naive.*flash.*auto"):
        InferenceEngine(lm, slots=2, block_size=8, attention="fast")

    class NoSwitch(torch.nn.Module):
        def forward(self, tokens):
            return tokens

    with pytest.raises(ValueError, match="attention switch"):
        InferenceEngine(NoSwitch(), attention="flash")
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_ATTENTION", "naive")
    eng = InferenceEngine(lm, slots=2, block_size=8)
    assert eng.attention == "naive"
    eng.close()
    monkeypatch.delenv("FLUXMPI_TPU_SERVING_ATTENTION")
    calls = []
    real = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert lm.attention == "naive"
    eng = InferenceEngine(lm, slots=2, block_size=8)
    req = eng.submit(_prompt(np.random.default_rng(3), 5), 4)
    eng.run()
    assert calls == [] and eng.attention is None
    eng = InferenceEngine(lm, slots=2, block_size=8, attention="flash")
    req = eng.submit(req.prompt, 4)
    eng.run()
    assert len(calls) == CFG["num_layers"] * 3  # three decode ticks
    np.testing.assert_array_equal(np.asarray(req.tokens), _ref(lm, req))
    eng.close()
    serving.shutdown()


def test_warmup_touches_only_the_trash_block(engine_factory):
    eng = engine_factory()
    free_before = eng.cache.free_blocks
    eng.warmup(prompt_lengths=(4, 11))
    assert eng.cache.free_blocks == free_before and eng.prefills == 0
    assert eng.queue_depth == 0 and eng.active_count == 0


def test_max_len_caps_sequences(engine_factory):
    eng = engine_factory(max_len=21)
    assert eng.max_len == 16 and eng.max_blocks_per_seq == 2
    assert eng.cache.num_blocks == 1 + 2 * 2
    with pytest.raises(ValueError, match="max_len 16"):
        eng.submit(_prompt(np.random.default_rng(0), 10), 7)
    assert engine_factory(max_len=1000).max_len == CFG["max_len"]
    with pytest.raises(ValueError, match="below one block"):
        engine_factory(max_len=7)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def test_queue_full_rejects_with_counter(engine_factory):
    get_registry().reset()
    eng = engine_factory(slots=1, max_queue=2)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(_prompt(rng, 4), 4) for _ in range(3)]
    assert [r.status for r in reqs[:2]] == ["queued", "queued"]
    assert reqs[2].status == "rejected" and reqs[2].reject_reason == "queue_full"
    with pytest.raises(RuntimeError, match="queue_full"):
        reqs[2].result()
    key = ("serving.admission_rejects", (("reason", "queue_full"),))
    assert _snap()[key]["value"] == 1
    eng.run()


def test_oversized_request_raises(engine_factory):
    eng = engine_factory()
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_prompt(rng, 30), eng.max_len)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(_prompt(rng, 4), 0)
    with pytest.raises(ValueError, match="vocabulary"):
        eng.submit(_prompt(rng, 4), 4, eos_token=99)


def test_capacity_queueing_and_block_reuse(lm, engine_factory):
    """A pool that holds ONE request at a time queues the second until
    eviction frees blocks, then serves it from the recycled blocks."""
    eng = engine_factory(slots=2, num_blocks=6, max_queue=8)
    rng = np.random.default_rng(3)
    a = eng.submit(_prompt(rng, 8), 16)   # 24 tokens -> 3 blocks
    b = eng.submit(_prompt(rng, 10), 12)  # 22 tokens -> 3 blocks, must wait
    eng.step()
    assert a.status == "active" and b.status == "queued"
    eng.run()
    assert a.status == "finished" and b.status == "finished"
    for req in (a, b):
        np.testing.assert_array_equal(np.asarray(req.tokens), _ref(lm, req))
    assert eng.cache.free_blocks == 5


def test_static_batching_gangs_admissions(engine_factory):
    rng = np.random.default_rng(5)
    workload = [(6, 16), (4, 2), (5, 2), (4, 2)]

    def run_mode(continuous):
        eng = engine_factory(slots=2, continuous=continuous)
        for plen, mnew in workload:
            eng.submit(_prompt(rng, plen), mnew)
        return eng.run()

    static = run_mode(False)
    cont = run_mode(True)
    assert static["completed"] == cont["completed"] == 4
    assert static["tokens"] == cont["tokens"]
    assert cont["decode_steps"] < static["decode_steps"]


# ---------------------------------------------------------------------------
# Streaming, latency, SLOs
# ---------------------------------------------------------------------------


def test_streaming_callback_iterator_and_latency(lm, engine_factory):
    eng = engine_factory()
    eng.warmup(prompt_lengths=(5,))
    rng = np.random.default_rng(11)
    seen = []
    eng.start()
    try:
        req = eng.submit(_prompt(rng, 5), 10, on_token=seen.append)
        streamed = list(req.stream(timeout=30.0))
    finally:
        eng.stop()
    assert req.status == "finished"
    assert streamed == req.tokens == seen
    np.testing.assert_array_equal(np.asarray(streamed), _ref(lm, req))
    assert req.queue_wait_s is not None and req.queue_wait_s >= 0
    assert req.ttft_s is not None and req.ttft_s >= req.queue_wait_s
    assert req.per_token_s is not None and req.per_token_s >= 0


def test_injected_clock_drives_latency_accounting(engine_factory):
    """``clock=`` stamps every latency field: with a clock that advances
    one unit per read, the fields count reads."""
    ticks = iter(range(1000))
    eng = engine_factory(clock=lambda: float(next(ticks)))
    req = eng.submit(_prompt(np.random.default_rng(0), 4), 3)
    assert req.submitted_t == 0.0
    summary = eng.run()
    # run's t0 = 1; admission 2; first token 3; finish 4; wall read 5.
    assert (req.admitted_t, req.first_token_t, req.finished_t) == (2.0, 3.0, 4.0)
    assert (req.queue_wait_s, req.ttft_s, req.per_token_s) == (2.0, 3.0, 0.5)
    assert summary["wall_seconds"] == 4.0
    alone = serving.ServingRequest([1, 2], 3, clock=lambda: 7.5)
    assert alone.submitted_t == 7.5 and alone.queue_wait_s is None


def test_slo_violation_counter(engine_factory):
    get_registry().reset()
    eng = engine_factory(slo_ttft_s=0.0, slo_token_s=0.0)  # impossible SLOs
    eng.submit(_prompt(np.random.default_rng(2), 4), 4)
    summary = eng.run()
    assert summary["slo_violations"] == 2
    snap = _snap(name="serving.slo_violations")
    assert snap[("serving.slo_violations", (("kind", "ttft"),))]["value"] == 1
    assert snap[("serving.slo_violations", (("kind", "per_token"),))]["value"] == 1


# ---------------------------------------------------------------------------
# Preemption, faults, the watchdog clock
# ---------------------------------------------------------------------------


def test_sigterm_drains_inflight_rejects_new(lm, engine_factory):
    """In-flight requests decode to completion, queued and new ones are
    rejected, and the summary reports the drained/rejected split."""
    eng = engine_factory(slots=2, max_queue=8)
    rng = np.random.default_rng(9)
    a = eng.submit(_prompt(rng, 5), 24)
    b = eng.submit(_prompt(rng, 7), 24)
    c = eng.submit(_prompt(rng, 4), 4)  # queued behind the two slots
    eng.step()  # admit a + b
    runtime.request_preemption()
    try:
        summary = eng.run()
    finally:
        runtime.clear_preemption()
    assert summary["preempted"] is True
    assert summary["drained"] == 2 and summary["rejected"] == 1
    assert a.status == "finished" and len(a.tokens) == 24
    assert b.status == "finished" and len(b.tokens) == 24
    assert c.status == "rejected" and c.reject_reason == "preempted"
    np.testing.assert_array_equal(np.asarray(a.tokens), _ref(lm, a))
    late = eng.submit(_prompt(rng, 4), 4)
    assert late.status == "rejected" and late.reject_reason == "draining"


@pytest.mark.parametrize("site", ["serving.admit", "serving.decode"])
def test_serving_sites_are_injectable(engine_factory, site):
    eng = engine_factory()
    rng = np.random.default_rng(4)
    with faults.scope(site + "@step=1"):
        with pytest.raises(FaultInjectedError, match=site):
            eng.submit(_prompt(rng, 4), 4)
            eng.run()
    # Disarmed: the engine still serves (a decode crash left its slot
    # active; the rerun drains it).
    req = eng.submit(_prompt(rng, 4), 4)
    eng.run()
    assert req.status == "finished"


def test_decode_stall_feeds_watchdog_clock(engine_factory):
    from fluxmpi_tpu_torch.telemetry.watchdog import progress_value

    eng = engine_factory()
    before = progress_value()
    with faults.scope("serving.decode@step=1:delay=0.05"):
        eng.submit(_prompt(np.random.default_rng(4), 4), 3)
        summary = eng.run()
    assert summary["completed"] == 1
    assert progress_value() > before


def test_idle_serve_thread_does_not_feed_watchdog(engine_factory):
    """An idle serving thread must not advance the progress counter (it
    would hide a co-resident training loop's stall)."""
    from fluxmpi_tpu_torch.telemetry.watchdog import progress_value

    eng = engine_factory()
    eng.start()
    try:
        time.sleep(0.2)
        before = progress_value()
        time.sleep(0.3)
        assert progress_value() == before
        req = eng.submit(_prompt(np.random.default_rng(0), 4), 4)
        assert req.wait(timeout=60.0)
        assert progress_value() > before
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# Metrics, configuration, init
# ---------------------------------------------------------------------------


def test_metrics_schema_valid_and_namespace_closed(engine_factory):
    get_registry().reset()
    eng = engine_factory()
    eng.submit(_prompt(np.random.default_rng(6), 5), 6)
    eng.run()
    rec = get_registry().flush()
    assert validate_record(rec) == []
    emitted = {m["name"] for m in rec["metrics"] if m["name"].startswith("serving.")}
    assert emitted and emitted <= KNOWN_METRIC_NAMES
    bad = {"name": "serving.bogus", "type": "gauge", "labels": {}, "value": 1.0}
    assert any("framework-owned" in e for e in validate_metric(bad))


def test_registry_counters_match_summary_across_a_switch_to_run(engine_factory):
    """Ticks between the last update and a switch to ``run()`` still reach
    the cumulative counters; an explicit ``registry=`` takes them instead of
    the process registry."""
    get_registry().reset()
    eng = engine_factory(flush_every=16)
    eng.submit(_prompt(np.random.default_rng(1), 4), 8)
    for _ in range(4):  # admit + a few ticks short of flush_every
        eng.step()
    summary = eng.run()
    snap = {m["name"]: m["value"] for m in get_registry().snapshot()
            if m["type"] == "counter"}
    assert snap["serving.decode_steps"] == summary["decode_steps"]
    assert snap["serving.tokens_generated"] == summary["tokens"]
    own = MetricsRegistry()
    eng2 = engine_factory(registry=own, flush_every=4)
    eng2.submit(_prompt(np.random.default_rng(2), 4), 9)
    for _ in range(5):  # the admission, then 4 ticks: one update
        eng2.step()
    counters = {m["name"]: m["value"] for m in own.snapshot() if m["type"] == "counter"}
    assert counters["serving.decode_steps"] == 4
    process = {m["name"]: m["value"] for m in get_registry().snapshot()
               if m["type"] == "counter"}
    assert process["serving.decode_steps"] == summary["decode_steps"]  # untouched


def test_configure_env_forms(lm, monkeypatch):
    serving.shutdown()
    monkeypatch.setenv("FLUXMPI_TPU_SERVING", "1")
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_SLOTS", "3")
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_BLOCK_SIZE", "4")
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_QUEUE", "5")
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_BLOCKS", "9")
    serving.configure()
    assert serving.enabled()
    eng = InferenceEngine(lm)
    try:
        assert (eng.slots, eng.block_size, eng.max_queue) == (3, 4, 5)
        assert eng.cache.num_blocks == 9
    finally:
        eng.close()
        serving.shutdown()
    assert not serving.enabled()


def test_configure_dict_and_env_typo(lm, monkeypatch):
    cfg = serving.configure({"slots": 5, "block_size": 8})
    assert cfg.slots == 5
    eng = InferenceEngine(lm)
    assert (eng.slots, eng.block_size) == (5, 8)
    assert InferenceEngine(lm, slots=1).slots == 1  # explicit beats configured
    with pytest.raises(ValueError, match="unknown serving config"):
        serving.configure({"slotz": 5})
    serving.shutdown()
    assert serving.get_engine() is None
    monkeypatch.setenv("FLUXMPI_TPU_SERVING_SLOTS", "many")
    with pytest.warns(UserWarning, match="FLUXMPI_TPU_SERVING_SLOTS"):
        eng = InferenceEngine(lm, block_size=8)
    try:
        assert eng.slots == 8  # the built-in default
    finally:
        eng.close()
        serving.shutdown()


def test_init_serving_kwarg(lm):
    tfm.init(device="cpu", serving={"slots": 3})
    try:
        assert serving.enabled()
        eng = InferenceEngine(lm, block_size=8)
        assert eng.slots == 3 and serving.get_engine() is eng
        tfm.init(serving=False)
        assert not serving.enabled() and serving.get_engine() is None
        assert eng.cache._k_pool is None  # the reset closed it
    finally:
        tfm.shutdown()


def test_env_typo_on_master_switch_warns_not_crashes(monkeypatch):
    serving.shutdown()
    monkeypatch.setenv("FLUXMPI_TPU_SERVING", "true")
    with pytest.warns(UserWarning, match="FLUXMPI_TPU_SERVING"):
        cfg = serving.configure()
    assert cfg is None and not serving.enabled()
    with pytest.raises(ValueError, match="serving spec"):
        serving.configure("true")


# ---------------------------------------------------------------------------
# Background serving, switching to run(), teardown
# ---------------------------------------------------------------------------


def test_serve_thread_error_fails_pending_requests(engine_factory):
    """An error inside a background iteration (the serving.decode site)
    rejects every pending request with reason "error" and banks the
    exception."""
    eng = engine_factory()
    eng.warmup(prompt_lengths=(4,))
    rng = np.random.default_rng(0)
    with faults.scope("serving.decode@step=1"):
        eng.start()
        req = eng.submit(_prompt(rng, 4), 8)
        assert req.wait(timeout=60.0)
    assert req.status == "rejected" and req.reject_reason == "error"
    with pytest.raises(RuntimeError, match="error"):
        list(req.stream(timeout=5.0))
    assert isinstance(eng.serve_error, FaultInjectedError)
    assert eng.cache.free_blocks == eng.cache.num_blocks - 1
    eng.stop()


def test_stop_then_run_inline_serves_again(lm, engine_factory):
    eng = engine_factory()
    rng = np.random.default_rng(3)
    eng.start()
    first = eng.submit(_prompt(rng, 4), 4)
    assert first.wait(timeout=60.0)
    assert eng.stop()
    parked = eng.submit(_prompt(rng, 4), 6)
    assert parked.status == "queued"
    summary = eng.run()
    assert parked.status == "finished" and len(parked.tokens) == 6
    assert summary["completed"] >= 1
    np.testing.assert_array_equal(np.asarray(parked.tokens), _ref(lm, parked))
    idle = eng.run()
    assert idle["tokens_per_sec"] == 0.0
    assert idle["tokens"] == summary["tokens"] == 10


def test_warmup_refuses_while_serving(engine_factory):
    eng = engine_factory()
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="background thread"):
            eng.warmup(prompt_lengths=(8,))
        with pytest.raises(RuntimeError, match="stop"):
            eng.run()
    finally:
        eng.stop()


def test_stream_timeout_raises_timeout_error(engine_factory):
    eng = engine_factory()
    req = eng.submit(_prompt(np.random.default_rng(0), 4), 4)  # nothing drives it
    with pytest.raises(TimeoutError, match="no token"):
        list(req.stream(timeout=0.05))
    eng.run()
    assert req.status == "finished"


def test_engine_close_fails_pending_and_drops_pools(lm):
    get_registry().reset()
    eng = InferenceEngine(lm, slots=1, block_size=8, max_queue=4)
    rng = np.random.default_rng(1)
    active = eng.submit(_prompt(rng, 5), 30)
    queued = eng.submit(_prompt(rng, 5), 30)
    eng.step()
    assert serving.get_engine() is eng
    rejected_before = eng._rejected
    eng.close()
    assert active.status == "rejected" and active.reject_reason == "shutdown"
    assert queued.status == "rejected" and queued.reject_reason == "shutdown"
    assert eng._rejected == rejected_before + 2
    snap = _snap(name="serving.admission_rejects")
    assert snap[("serving.admission_rejects", (("reason", "shutdown"),))]["value"] == 2
    assert eng.cache._k_pool is None and eng.cache._v_pool is None
    assert eng.cache.free_blocks == eng.cache.num_blocks - 1
    assert serving.get_engine() is None
    get_registry().reset()


def test_stop_keeps_a_thread_that_outlives_its_timeout(engine_factory):
    """A serve thread stuck past ``stop(timeout)`` keeps its reference:
    ``stop`` says False, teardown leaves the pools, a later ``stop``
    joins it."""
    eng = engine_factory()
    with faults.scope("serving.decode@step=1:delay=1.0"):
        eng.start()
        req = eng.submit(_prompt(np.random.default_rng(0), 4), 3)
        time.sleep(0.3)  # inside the delayed tick
        with pytest.warns(UserWarning, match="still running"):
            assert eng.stop(timeout=0.05) is False
        assert eng._thread is not None
        assert eng.stop(timeout=30.0) is True
    assert eng._thread is None
    assert req.status == "active"  # stop does not complete requests


# ---------------------------------------------------------------------------
# Request-observability plane
# ---------------------------------------------------------------------------


def test_kv_high_watermark_and_fragmentation():
    cache = BlockKVCache(num_layers=2, num_heads=4, head_dim=8, num_blocks=9,
                         block_size=8, max_blocks_per_seq=8, device="cpu")
    assert cache.high_watermark_blocks == 0 and cache.fragmentation == 0.0
    assert cache.free_tokens == 64
    a = cache.alloc(24)  # blocks 1,2,3
    b = cache.alloc(24)  # blocks 4,5,6
    assert cache.high_watermark_blocks == 6 and cache.free_tokens == 16
    cache.free(a)
    assert cache.used_blocks == 3 and cache.high_watermark_blocks == 6
    # Free ids {1,2,3,7,8}: longest run 3 of 5 free -> 0.4 scattered.
    assert cache.fragmentation == pytest.approx(1.0 - 3.0 / 5.0)
    cache.free(b)
    assert cache.fragmentation == 0.0 and cache.high_watermark_blocks == 6


def test_slo_burn_tracker_multi_window_math():
    now = {"t": 0.0}
    t = observe.SLOBurnTracker(window=120.0, slo_target=0.9, clock=lambda: now["t"])
    assert t.windows == (10.0, 120.0)
    assert t.budget == pytest.approx(0.1)
    assert t.burn_rate() == 0.0 and t.alert_rate() is None
    for _ in range(8):
        t.observe(True)
    for _ in range(2):
        t.observe(False)
    assert t.burn_rate(10.0) == pytest.approx(2.0)
    assert t.burn_rate(120.0) == pytest.approx(2.0)
    assert t.alert_rate() == pytest.approx(2.0)
    now["t"] = 50.0
    t.observe(True)
    assert t.burn_rate(10.0) == 0.0
    assert t.burn_rate(120.0) == pytest.approx((2.0 / 11.0) / 0.1)
    assert t.alert_rate() == 0.0
    t.reset()
    assert t.total == 0 and t.good == 0 and t.alert_rate() is None
    with pytest.raises(ValueError, match="window"):
        observe.SLOBurnTracker(window=0.0)
    with pytest.raises(ValueError, match="slo_target"):
        observe.SLOBurnTracker(slo_target=1.0)


def test_request_log_complete_under_sigterm_drain(engine_factory, tmp_path):
    """Every in-flight, queued and post-drain request lands in the log
    with its terminal status, valid by the stdlib checker."""
    path_spec = str(tmp_path / "requests.{process}.jsonl")
    observe.configure(path_spec)
    eng = engine_factory(slots=2, max_queue=8)
    rng = np.random.default_rng(9)
    a = eng.submit(_prompt(rng, 5), 24)
    b = eng.submit(_prompt(rng, 7), 24)
    c = eng.submit(_prompt(rng, 4), 4)
    eng.step()
    runtime.request_preemption()
    try:
        summary = eng.run()
    finally:
        runtime.clear_preemption()
    assert summary["drained"] == 2 and summary["rejected"] == 1
    late = eng.submit(_prompt(rng, 4), 4)
    assert late.status == "rejected" and late.reject_reason == "draining"
    path = path_spec.format(process=0)
    with open(path, encoding="utf-8") as f:
        records = {r["request_id"]: r for r in map(json.loads, f)}
    assert set(records) == {req.id for req in (a, b, c, late)}
    assert records[a.id]["status"] == "finished" and records[a.id]["output_tokens"] == 24
    assert records[b.id]["status"] == "finished"
    assert records[c.id]["status"] == "rejected" and records[c.id]["reason"] == "preempted"
    assert records[late.id]["reason"] == "draining"
    assert records[a.id]["ttft_s"] is not None and records[late.id]["ttft_s"] is None
    _script(ROOT / "scripts" / "check_metrics_schema.py", path)


def test_rejected_requests_raise_typed_error(engine_factory):
    eng = engine_factory(slots=1, max_queue=1)
    rng = np.random.default_rng(0)
    eng.submit(_prompt(rng, 4), 4)
    shed = eng.submit(_prompt(rng, 4), 4)
    assert shed.status == "rejected"
    with pytest.raises(RequestRejectedError, match="queue_full") as info:
        shed.result()
    assert info.value.reject_reason == "queue_full"
    assert isinstance(info.value, RuntimeError)
    with pytest.raises(RequestRejectedError, match="queue_full"):
        list(shed.stream(timeout=1.0))
    eng.run()


def test_request_plane_fully_off_never_touches_observer(engine_factory, monkeypatch):
    """With the plane off, a full run (a load-shed reject included) calls
    no method of it: exploding stand-ins, not timers."""
    observe.shutdown()
    assert observe.get_request_observer() is None

    def boom(*a, **k):
        raise AssertionError("request plane touched while off")

    monkeypatch.setattr(observe.RequestObserver, "observe_terminal", boom)
    monkeypatch.setattr(observe.RequestObserver, "board", boom)
    monkeypatch.setattr(observe.RequestObserver, "maybe_write_bundle", boom)
    monkeypatch.setattr(observe.SLOBurnTracker, "observe", boom)
    monkeypatch.setattr(observe.RequestLog, "write", boom)
    eng = engine_factory(slots=1, max_queue=1)
    rng = np.random.default_rng(2)
    ok = eng.submit(_prompt(rng, 4), 4)
    shed = eng.submit(_prompt(rng, 4), 4)
    eng.run()
    assert ok.status == "finished" and len(ok.tokens) == 4
    assert shed.status == "rejected" and shed.reject_reason == "queue_full"


def test_request_plane_e2e_trace_log_report(engine_factory, tmp_path):
    """One plane-on run gives a Perfetto-valid merged trace with the
    request span chains on named tracks, a schema-valid request log, and
    a ``serving_report.py`` aggregation whose totals equal the registry's
    counters."""
    get_registry().reset()
    log_spec = str(tmp_path / "requests.{process}.jsonl")
    trace_spec = str(tmp_path / "trace.{process}.json")
    tracing.configure(trace_spec)
    obs = observe.configure(log_spec)
    obs.dump_dir = str(tmp_path)
    try:
        eng = engine_factory(slots=2, max_queue=2)
        rng = np.random.default_rng(7)
        good = [eng.submit(_prompt(rng, 5), 6) for _ in range(2)]
        shed = [eng.submit(_prompt(rng, 5), 6) for _ in range(3)]
        summary = eng.run()
        assert [r.status for r in good] == ["finished", "finished"]
        assert {r.reject_reason for r in shed} == {"queue_full"}
        trace_path = tracing.shutdown()
        assert trace_path is not None
    finally:
        tracing.configure(False)
        tracing.reset()
    merged = str(tmp_path / "merged.json")
    _script(ROOT / "scripts" / "merge_traces.py", "-o", merged, trace_path)
    log_path = log_spec.format(process=0)
    _script(ROOT / "scripts" / "check_metrics_schema.py", merged, log_path)
    with open(merged, encoding="utf-8") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"request.queue", "request.prefill", "request.decode", "request.done",
            "request.rejected"} <= names
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {f"request {r.id}" for r in good} <= tracks
    report = json.loads(_script(ROOT / "scripts" / "serving_report.py", "--json", log_path))
    snap = {}
    for m in get_registry().snapshot():
        if m["type"] == "counter":
            snap[m["name"]] = snap.get(m["name"], 0) + m["value"]
    assert report["requests"] == 5
    assert report["finished"] == snap["serving.requests_completed"] == 2
    assert report["rejected"] == snap["serving.admission_rejects"] == 3
    assert report["reject_reasons"] == {"queue_full": 3}
    assert report["output_tokens"] == summary["tokens"]
    assert report["ttft"]["count"] == 2 and report["slo_ok"] == 2
    assert snap["serving.requests_logged"] == 5
    p50, p99 = obs.ttft_percentiles()
    board = obs.board()
    assert board["requests_logged"] == 5 and board["ttft_p50"] == p50 is not None


def test_queue_full_load_shed_writes_debug_bundle_once(engine_factory, tmp_path):
    obs = observe.configure(True)
    obs.dump_dir = str(tmp_path)
    eng = engine_factory(slots=1, max_queue=1)
    rng = np.random.default_rng(6)
    held = eng.submit(_prompt(rng, 5), 24)
    eng.step()  # admitted: the slot holds blocks the census reports
    eng.submit(_prompt(rng, 4), 4)  # fills the queue
    shed = eng.submit(_prompt(rng, 4), 4)
    assert shed.reject_reason == "queue_full"
    bundle_path = os.path.join(str(tmp_path), "fluxmpi_serving.0.json")
    assert obs.last_dump_path == bundle_path
    with open(bundle_path, encoding="utf-8") as f:
        bundle = json.load(f)
    srv = bundle["serving"]
    assert srv["blocks_total"] == eng.cache.num_blocks - 1
    assert srv["blocks_in_use"] > 0 and srv["queue_depth"] == 1
    assert srv["census"][0]["request_id"] == held.id
    assert srv["census"][0]["blocks"] == len(eng._slots[0].blocks)
    _script(ROOT / "scripts" / "check_metrics_schema.py", bundle_path)
    os.unlink(bundle_path)
    again = eng.submit(_prompt(rng, 4), 4)
    assert again.reject_reason == "queue_full"
    assert not os.path.exists(bundle_path)
    eng.run()


def test_request_log_configure_env_forms_and_typo(monkeypatch, tmp_path):
    observe.shutdown()
    monkeypatch.delenv("FLUXMPI_TPU_REQUEST_LOG", raising=False)
    assert observe.configure() is None
    obs = observe.configure(True)
    assert obs is not None and obs.log is None
    assert observe.configure("1") is obs
    spec = str(tmp_path / "requests.{process}.jsonl")
    obs2 = observe.configure(spec)
    assert obs2 is not obs and obs2.log.path == spec.format(process=0)
    assert observe.configure(spec) is obs2
    observe.shutdown()
    monkeypatch.setenv("FLUXMPI_TPU_REQUEST_LOG", "req.{proc}.jsonl")
    with pytest.warns(UserWarning, match="FLUXMPI_TPU_REQUEST_LOG"):
        assert observe.configure() is None
    with pytest.raises(ValueError, match="not formattable"):
        observe.configure("req.{proc}.jsonl")
    with pytest.raises(ValueError, match="request_log spec"):
        observe.configure(3.5)
    monkeypatch.delenv("FLUXMPI_TPU_REQUEST_LOG")
    observe.configure(True)
    assert observe.configure(False) is None
    assert observe.get_request_observer() is None
    monkeypatch.setenv("FLUXMPI_TPU_SLO_WINDOW", "soon")
    with pytest.warns(UserWarning, match="FLUXMPI_TPU_SLO_WINDOW"):
        t = observe.SLOBurnTracker()
    assert t.windows[-1] == 300.0


def test_init_request_log_kwarg_and_shutdown_order(lm, tmp_path):
    """``init(request_log=)`` installs the observer; ``shutdown()`` resets
    the serving plane first (the engine's pending requests are rejected
    and logged while the observer is still up), then the observer."""
    spec = str(tmp_path / "requests.{process}.jsonl")
    tfm.init(device="cpu", request_log=spec)
    try:
        obs = observe.get_request_observer()
        assert obs is not None and obs.log.path_spec == spec
        eng = InferenceEngine(lm, slots=1, block_size=8)
        pending = eng.submit(_prompt(np.random.default_rng(0), 4), 4)
        tfm.init(request_log=False)
        assert observe.get_request_observer() is None
        tfm.init(request_log=spec)
    finally:
        tfm.shutdown()
    assert pending.reject_reason == "shutdown"
    assert serving.get_engine() is None and observe.get_request_observer() is None
    with open(spec.format(process=0), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    assert [(r["request_id"], r["reason"]) for r in records] == [(pending.id, "shutdown")]


# ---------------------------------------------------------------------------
# The same traffic through the JAX engine and the port's
# ---------------------------------------------------------------------------


class _Clock:
    """Advances one unit per read: both engines read their clocks at the
    same points, so every latency field counts the same reads."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _drive(pkg, model, log_path):
    """The scripted traffic through one package's engine; returns the
    summary, the requests' outcomes, the log records and the metrics."""
    eng_mod, obs_mod, rt, reg = pkg["engine"], pkg["observe"], pkg["runtime"], pkg["registry"]
    obs_mod.configure(str(log_path)).dump_dir = str(log_path.parent)  # the shed's bundle
    clock = _Clock()
    eng = eng_mod.InferenceEngine(*model, slots=2, block_size=8, max_queue=3,
                                  slo_ttft_s=12.0, slo_token_s=1.6, registry=reg,
                                  clock=clock, flush_every=3)
    rng = np.random.default_rng(21)
    # (prompt length, new tokens): r0 raises the preemption at its 5th
    # token; r3, r4 and r7 meet a full queue; r6 is queued at the drain.
    specs = [(5, 9), (9, 2), (4, 3), (6, 4), (3, 2), (12, 5), (7, 4), (4, 4)]
    prompts = [rng.integers(0, VOCAB, p).astype(np.int32) for p, _ in specs]
    reqs = []

    def preempt(tok, count=[0]):
        count[0] += 1
        if count[0] == 5:
            rt.request_preemption()

    try:
        for i in range(5):
            reqs.append(eng.submit(prompts[i], specs[i][1],
                                   on_token=preempt if i == 0 else None))
        eng.step()
        for i in range(5, 8):
            reqs.append(eng.submit(prompts[i], specs[i][1]))
        summary = eng.run()
        reqs.append(eng.submit(prompts[0], 2))
    finally:
        rt.clear_preemption()
        eng.close()
        obs_mod.shutdown()
    ids = {r.id: i for i, r in enumerate(reqs)}
    with open(log_path, encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        rec.pop("time_unix")
        rec["request_id"] = ids[rec["request_id"]]
    outcomes = [(r.status, r.reject_reason, list(r.tokens), r.queue_wait_s, r.ttft_s,
                 r.per_token_s) for r in reqs]
    metrics = {}
    for m in reg.snapshot():
        if m["name"].startswith("serving.") and m["name"] != "serving.slo_burn_rate":
            key = (m["name"], tuple(sorted(m["labels"].items())))
            metrics[key] = ({k: m[k] for k in ("count", "sum") if k in m}
                            if m["type"] == "histogram" else m["value"])
    return summary, outcomes, records, metrics


def test_engine_parity_with_jax(tmp_path):
    """Prompts of 3-14 tokens, 2 slots, a queue of 3 that sheds twice, an
    SLO some requests break, a preemption raised from a token callback
    mid-run, a submit after the drain: both engines give equal summaries,
    statuses, reject reasons, tokens, latency fields (injected clocks),
    request-log records and ``serving.*`` counters, gauges and histogram
    counts and sums."""
    from fluxmpi_tpu import runtime as jrt
    from fluxmpi_tpu.models import TransformerLM as JaxLM
    from fluxmpi_tpu.serving import engine as jeng
    from fluxmpi_tpu.serving import observe as jobs
    from fluxmpi_tpu.telemetry import MetricsRegistry as JaxRegistry

    jlm = JaxLM(**CFG)
    params = jlm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32), train=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    try:
        want = _drive({"engine": jeng, "observe": jobs, "runtime": jrt,
                       "registry": JaxRegistry()}, (jlm, params), tmp_path / "jax.jsonl")
    finally:
        jeng.shutdown()
    got = _drive({"engine": serving.engine, "observe": observe, "runtime": runtime,
                  "registry": MetricsRegistry()}, (tlm,), tmp_path / "port.jsonl")
    summary, outcomes, records, metrics = got
    assert summary == want[0]
    assert summary["preempted"] and summary["slo_violations"] > 0
    assert summary["rejected"] >= 4 and summary["completed"] >= 3
    assert outcomes == want[1]
    reasons = {o[1] for o in outcomes}
    assert {"queue_full", "preempted", "draining"} <= reasons
    assert records == want[2]
    assert metrics == want[3]
