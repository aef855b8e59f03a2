"""The port's public callables take the JAX package's arguments, by the
same names, in the same positional order, with the same literal defaults.

For every name that a module of the port exports (its ``__all__``) and the
counterpart module of the JAX package exports too (its ``__all__``, or its
public attributes where it has none), every JAX call must be a valid port
call: the JAX positional parameters come in the same order, every JAX
keyword is accepted by name, a default given by both is the same literal,
and the port adds no parameter of its own. The allow-list holds only:

- the port's deliberate extras: ``device=`` (torch places tensors on a
  device, JAX on a mesh) and ``generator=`` (torch draws weights from a
  generator, flax from a PRNG key), ``init(timeout=)``, the
  ``torch.distributed`` process group's timeout, and ``in_features=`` of
  ``MLP``, ``CNN``, ``ResNet`` (and its blocks), ``DEQ``, ``ViT`` and
  ``UNet``, ``image_size=`` of ``ViT`` and ``UNet``, and ``d_model=`` of
  ``MoEMLP`` (a torch module is built with its shapes; flax infers the
  input width, the position table's length and where the UNet's attention
  blocks sit at the first call);
- the TPU-only arguments ``block_q``, ``block_k`` and ``interpret`` where
  the port does not take them (the port has no Pallas tiling);
- ``mesh`` and ``axis_name`` only where ``MESH_NOT_TAKEN`` names the
  callable (none left since the checkpoints' ``mesh``, ROADMAP A.5, was
  ported). The port takes them everywhere (the layouts, the steps, the
  loader, the in-step and the eager collectives, the gradient all-reduce,
  the sync-BN models, the manifest and the elastic restore) and they are
  compared;
- the arguments that the port takes through ``**waiting`` and still
  refuses with ``NotImplementedError``, each named in ``REFUSED`` (and
  shown to raise). Arguments that the port spells as parameters but
  refuses when set are named in ``REFUSED_WHEN_SET`` and shown to raise
  too;
- flax's own module fields (``parent``, ``name``; also through a
  ``functools.partial`` such as ``ResNet50``) and the flax ``params``
  beside a ``model`` where the port leaves it out: a torch module holds
  its own weights (where the port takes it, as ``ddpm_loss`` and
  ``ddim_sample`` do to run a model with other weights such as the EMA's,
  it is compared).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import time

import pytest

flax_linen = pytest.importorskip("flax.linen")

MODULES = ["", ".comm", ".config", ".data", ".errors", ".faults", ".logging",
           ".optimizer", ".runtime", ".sync", ".models", ".models.cnn", ".models.deq",
           ".models.generate", ".models.moe", ".models.resnet", ".models.transformer",
           ".models.unet", ".models.vit",
           ".ops", ".ops.flash_attention", ".ops.fused_ce", ".parallel",
           ".parallel.autotune", ".parallel.collectives", ".parallel.loop", ".parallel.plan",
           ".parallel.sharding", ".parallel.train", ".serving", ".serving.cache",
           ".serving.engine", ".serving.observe", ".models.hf_gpt2", ".utils", ".utils.checkpoint", ".utils.ema",
           ".utils.manifest", ".utils.precision", ".utils.profiling", ".utils.flops",
           ".telemetry", ".telemetry.registry", ".telemetry.sinks",
           ".telemetry.tracing", ".telemetry.flight_recorder", ".telemetry.watchdog",
           ".telemetry.memory", ".telemetry.monitor", ".telemetry.goodput",
           ".telemetry.schema", ".telemetry.anomaly", ".telemetry.compileplane",
           ".telemetry.modelstats", ".telemetry.export", ".telemetry.fleet"]
# Public callables the JAX module defines but leaves out of its __all__,
# compared all the same: (module, name).
UNLISTED = [(".models.transformer", "EncoderBlock")]

EXTRAS = {"device", "generator"}
TPU_ONLY = {"block_q", "block_k", "interpret"}
# Callables whose JAX signature takes mesh=/axis_name= and the port's does
# not yet: none.
MESH_NOT_TAKEN: dict = {}
FLAX_FIELDS = {"parent", "name"}
# Port-only parameters beyond EXTRAS, by callable.
PORT_ONLY = {"init": {"timeout"},
             **{name: {"in_features"} for name in (
                 "MLP", "CNN", "DEQ", "ResNet", "ResNet18", "ResNet34", "ResNet50",
                 "ResNet101", "BottleneckBlock", "BasicBlock")},
             **{name: {"in_features", "image_size"} for name in ("ViT", "UNet")},
             "MoEMLP": {"d_model"}}
# Arguments the port takes through **waiting and refuses, by callable.
REFUSED = {
    "init": set(),
    "make_train_step": set(),
    "make_eval_step": set(),
}
# Parameters the port spells as the JAX package does but refuses with
# NotImplementedError when set: (module, callable) -> {argument: a value}.
REFUSED_WHEN_SET = {
    (".models.transformer", "TransformerLM"): {"decode": True},
    (".models.transformer", "TransformerEncoder"): {"decode": True},
    (".models.transformer", "EncoderBlock"): {"decode": True},
}
# The smallest positional arguments each of them takes.
_REFUSED_ARGS = {"TransformerLM": (), "TransformerEncoder": (),
                 "EncoderBlock": (32, 4, 64, 0.0, None)}
LITERALS = (type(None), bool, int, float, str)


def _exports(module, port: bool) -> set[str]:
    names = getattr(module, "__all__", None)
    if names is None and not port:
        names = [n for n in dir(module) if not n.startswith("_")]
    return set(names or ())


def _pairs():
    seen = set()
    for suffix in MODULES:
        port = importlib.import_module("fluxmpi_tpu_torch" + suffix)
        ref = importlib.import_module("fluxmpi_tpu" + suffix)
        for name in sorted(_exports(port, True) & _exports(ref, False)):
            p, r = getattr(port, name), getattr(ref, name)
            if inspect.ismodule(p) or not callable(p) or not callable(r):
                continue
            if (id(p), id(r)) in seen:
                continue
            seen.add((id(p), id(r)))
            yield f"{suffix or '.'}:{name}", name, p, r
    for suffix, name in UNLISTED:
        p = getattr(importlib.import_module("fluxmpi_tpu_torch" + suffix), name)
        r = getattr(importlib.import_module("fluxmpi_tpu" + suffix), name)
        yield f"{suffix}:{name}", name, p, r


PAIRS = list(_pairs())


def test_the_comparison_covers_the_ported_surface():
    names = {name for _, name, _, _ in PAIRS}
    for expected in ("init", "synchronize", "allreduce", "barrier",
                     "DistributedDataLoader", "make_train_step", "train_loop",
                     "RequestRejectedError", "InferenceEngine", "generate",
                     "restore_checkpoint", "CheckpointManager",
                     "flash_attention", "TransformerLM",
                     # Slice 5: the rest of the FluxMPI surface and the
                     # vision models.
                     "Request", "iallreduce", "ibcast", "host_allreduce",
                     "host_allgather", "host_bcast", "cpu", "device",
                     "local_device_count", "TopologyMismatchError",
                     "FluxModelWrapper", "FlatParamVector", "load_preference",
                     "set_preference", "delete_preference",
                     "disable_device_collectives", "env_int", "CNN", "ResNet",
                     "ResNet18", "ResNet34", "ResNet50", "ResNet101",
                     "BottleneckBlock", "BasicBlock", "DEQ", "fixed_point_solve",
                     # Slice 6: the zoo's ViT and UNet through the flash
                     # kernels' attention_fn hook, and the EMA.
                     "TransformerEncoder", "EncoderBlock", "flash_attention_fn", "ViT",
                     "UNet", "cosine_beta_schedule", "ddpm_loss", "ddim_sample",
                     "EMAState", "ema_init", "ema_update", "ema_params",
                     # Slice 7: the telemetry planes' core.
                     "MetricsRegistry", "Counter", "Gauge", "Histogram",
                     "get_registry", "set_registry", "JSONLSink", "MemorySink",
                     "ConsoleSink", "NullSink", "Tracer", "span", "instant",
                     "add_complete_event", "name_track", "FlightRecorder",
                     "diff_flight_dumps", "Watchdog", "arm_watchdog", "notify_progress",
                     "progress_value", "device_memory_stats", "record_hbm",
                     "census", "is_oom_error", "write_oom_bundle",
                     "TrainingMonitor", "GoodputTracker", "segment", "configure",
                     "shutdown", "step_timer", "chip_peak_flops", "mfu",
                     "validate_record", "validate_watchdog_dump",
                     # Slice 8: the rest of serving.
                     "ServingConfig", "configure", "enabled", "get_engine",
                     "set_engine", "ServingRequest", "RequestLog", "SLOBurnTracker",
                     "RequestObserver", "get_request_observer",
                     "set_request_observer", "beam_search", "lm_from_gpt2",
                     # Slice 10: the run-health and live-export planes.
                     "AnomalyDetector", "get_anomaly_detector",
                     "set_anomaly_detector", "CompileMonitor",
                     "get_compile_monitor", "ModelStats", "group_paths",
                     "compute_stats", "stats_zeros", "noise_scale",
                     "resolve_step_spec", "Exporter", "render_prometheus",
                     "mangle_name", "demangle_name", "FleetCollector",
                     "profile_trace", "AutoProfiler", "maybe_auto_capture",
                     "configure_auto_profiler", "enable_compile_cache"):
        assert expected in names, expected
    assert len(PAIRS) >= 120


def _mismatches(name, port, ref):
    try:
        sp, sr = inspect.signature(port), inspect.signature(ref)
    except (TypeError, ValueError):
        return []
    pp, rp = dict(sp.parameters), dict(sr.parameters)
    var_kw = any(p.kind is p.VAR_KEYWORD for p in pp.values())
    # A TPU-only argument that the port does take (axis_name of the
    # sync-BN models) is compared like any other.
    skip = {n for n in TPU_ONLY | MESH_NOT_TAKEN.get(name, set()) if n not in pp}
    base = ref.func if isinstance(ref, functools.partial) else ref
    if inspect.isclass(base) and issubclass(base, flax_linen.Module):
        skip |= FLAX_FIELDS
    rnames = list(rp)
    if rnames[:2] == ["model", "params"] and "params" not in pp:
        skip.add("params")
    out = []
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ref_pos = [n for n in rnames if rp[n].kind in positional and n not in skip]
    port_pos = [n for n, p in pp.items() if p.kind in positional]
    if port_pos != ref_pos[:len(port_pos)]:
        out.append(f"positional order {port_pos} vs {ref_pos}")
    for n, r in rp.items():
        if n in skip or r.kind in (r.VAR_POSITIONAL, r.VAR_KEYWORD):
            continue
        p = pp.get(n)
        if p is None:
            if not (var_kw and n in REFUSED.get(name, ())):
                out.append(f"missing {n}")
            continue
        if p.kind is p.POSITIONAL_ONLY and r.kind is not r.POSITIONAL_ONLY:
            out.append(f"{n} is positional-only")
        if r.default is not r.empty and p.default is p.empty:
            out.append(f"{n} has no default (JAX: {r.default!r})")
        elif (r.default is not r.empty and isinstance(r.default, LITERALS)
              and isinstance(p.default, LITERALS) and p.default != r.default):
            out.append(f"{n} default {p.default!r} vs {r.default!r}")
    for n, p in pp.items():
        if n in rp or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if n not in EXTRAS | PORT_ONLY.get(name, set()):
            out.append(f"port-only {n}")
        elif p.default is p.empty:
            out.append(f"port-only {n} has no default")
    return out


@pytest.mark.parametrize("where,name,port,ref", PAIRS, ids=[w for w, *_ in PAIRS])
def test_signature_matches_the_jax_package(where, name, port, ref):
    assert _mismatches(name, port, ref) == []


def test_mesh_arguments_left_out_only_where_listed():
    """``MESH_NOT_TAKEN`` is exactly the set of callables whose JAX
    signature has ``mesh``/``axis_name`` and the port's lacks them."""
    missing = {}
    for _, name, port, ref in PAIRS:
        try:
            pp, rp = (inspect.signature(f).parameters for f in (port, ref))
        except (TypeError, ValueError):
            continue
        left = {n for n in ("mesh", "axis_name") if n in rp and n not in pp}
        if left:
            missing[name] = left
    assert missing == MESH_NOT_TAKEN


def test_refused_arguments_raise_not_implemented():
    import fluxmpi_tpu_torch as tfm
    from fluxmpi_tpu_torch.parallel import make_eval_step, make_train_step
    from fluxmpi_tpu_torch.parallel import train as ttrain

    assert REFUSED["init"] <= set(tfm.runtime._WAITING)
    assert REFUSED["make_train_step"] | REFUSED["make_eval_step"] <= set(ttrain._WAITING)
    for arg in sorted(REFUSED["init"]):
        with pytest.raises(NotImplementedError, match=arg):
            tfm.init(device="cpu", **{arg: object()})
    assert not tfm.is_initialized()
    for arg in sorted(REFUSED["make_train_step"]):
        with pytest.raises(NotImplementedError, match=arg):
            make_train_step(lambda p, s, b: (None, s), None, **{arg: object()})
    for arg in sorted(REFUSED["make_eval_step"]):
        with pytest.raises(NotImplementedError, match=arg):
            make_eval_step(lambda p, s, b: None, **{arg: object()})


def test_the_two_spellings_that_differed():
    """``synchronize(tree, ...)`` and ``RequestRejectedError(reject_reason)``
    with the JAX package's message."""
    import fluxmpi_tpu as jfm
    import fluxmpi_tpu_torch as tfm

    assert list(inspect.signature(tfm.synchronize).parameters)[0] == "tree"
    port = tfm.errors.RequestRejectedError(reject_reason="queue_full")
    ref = jfm.errors.RequestRejectedError(reject_reason="queue_full")
    assert str(port) == str(ref) == "request rejected (queue_full)"
    assert port.reject_reason == ref.reject_reason == "queue_full"


@pytest.mark.parametrize("where,name,arg", [
    (where, name, arg) for (where, name), args in REFUSED_WHEN_SET.items()
    for arg in args])
def test_parameters_refused_when_set(where, name, arg):
    """Each argument of ``REFUSED_WHEN_SET`` is a parameter of the port's
    callable with the JAX package's default, and setting it raises
    ``NotImplementedError`` naming it (before any other work: no world,
    model or device is needed)."""
    fn = getattr(importlib.import_module("fluxmpi_tpu_torch" + where), name)
    ref = getattr(importlib.import_module("fluxmpi_tpu" + where), name)
    assert arg in inspect.signature(fn).parameters
    assert arg in inspect.signature(ref).parameters
    with pytest.raises(NotImplementedError, match=arg):
        fn(*_REFUSED_ARGS[name], **{arg: REFUSED_WHEN_SET[(where, name)][arg]})


def _tiny_lm():
    import torch

    from fluxmpi_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=31, max_len=32, num_layers=1, d_model=16,
                         num_heads=2, d_ff=32, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _served(lm=None, n=4, **kw):
    """One request of ``n`` new tokens through an engine built with
    ``kw``; returns the engine's summary, the request and the engine."""
    from fluxmpi_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(lm or _tiny_lm(), slots=1, block_size=8, **kw)
    req = eng.submit([3, 1, 4, 1, 5], n)
    summary = eng.run()
    eng.close()
    return summary, req, eng


def _ported_max_len():
    summary, req, eng = _served(max_len=20)
    assert eng.max_len == 16 and req.status == "finished"
    with pytest.raises(ValueError, match="max_len 16"):
        eng.submit([1] * 10, 7)


def _ported_slo(kind):
    summary, req, _ = _served(**{f"slo_{kind}_s": 0.0})  # an objective none meets
    assert summary["slo_violations"] == 1 and req.status == "finished"


def _ported_registry():
    from fluxmpi_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    summary, _, _ = _served(registry=reg)
    counts = {m["name"]: m["value"] for m in reg.snapshot() if m["type"] == "counter"}
    assert counts["serving.requests_completed"] == 1
    assert counts["serving.tokens_generated"] == summary["tokens"] == 4


def _ported_clock():
    ticks = iter(range(100))
    _, req, _ = _served(clock=lambda: float(next(ticks)))
    assert (req.submitted_t, req.admitted_t, req.ttft_s) == (0.0, 2.0, 3.0)


def _ported_request_clock():
    from fluxmpi_tpu_torch.serving import ServingRequest

    req = ServingRequest([1], 1, clock=time.monotonic)
    assert abs(req.submitted_t - time.monotonic()) < 60


def _ported_flush_every():
    from fluxmpi_tpu_torch.serving import InferenceEngine
    from fluxmpi_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    eng = InferenceEngine(_tiny_lm(), slots=1, block_size=8, registry=reg, flush_every=4)
    eng.submit([3, 1, 4], 9)
    for _ in range(3):  # the admission's update holds its iteration's tick
        eng.step()
    steps = [m["value"] for m in reg.snapshot() if m["name"] == "serving.decode_steps"]
    eng.step()  # the 4th tick
    assert steps == [1] and [m["value"] for m in reg.snapshot()
                             if m["name"] == "serving.decode_steps"] == [4]
    eng.close()


def _ported_check_memory():
    from fluxmpi_tpu_torch.telemetry import memory

    real = memory.device_memory_stats
    memory.device_memory_stats = lambda d: {"bytes_limit": 1.0, "bytes_in_use": 0.0}
    try:
        with pytest.raises(RuntimeError, match="device memory"):
            _served()
        assert _served(check_memory=False)[1].status == "finished"
    finally:
        memory.device_memory_stats = real


def _ported_attention():
    from fluxmpi_tpu_torch.models import transformer

    calls = []
    real = transformer.flash_attention
    transformer.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        _, naive, _ = _served()
        _, flash, eng = _served(attention="flash")
    finally:
        transformer.flash_attention = real
    assert eng.attention == "flash" and len(calls) == 3  # 1 layer, 3 decode ticks
    assert flash.tokens == naive.tokens


def _ported_generate(**kw):
    import torch

    from fluxmpi_tpu_torch.models import generate

    lm = _tiny_lm()
    prompt = [[3, 1, 4, 1, 5]] * 64
    greedy = generate(lm, prompt, 1)[:, -1]
    if kw.get("prefill") == "scan":
        assert torch.equal(generate(lm, prompt, 6, prefill="scan"),
                           generate(lm, prompt, 6, prefill="batched"))
        return
    drawn = generate(lm, prompt, 1, rng=torch.Generator().manual_seed(0),
                     **{"temperature": 1.0, **kw})[:, -1]
    logits = lm(torch.tensor(prompt[:1]), train=False)[0, -1]
    assert len(set(drawn.tolist())) > 1 and greedy[0] in drawn
    if "top_k" in kw:
        assert set(drawn.tolist()) <= set(torch.topk(logits, kw["top_k"]).indices.tolist())
    if "top_p" in kw:  # the nucleus of a peaked softmax: fewer tokens
        wide = generate(lm, prompt, 1, temperature=1.0,
                        rng=torch.Generator().manual_seed(0))[:, -1]
        assert set(drawn.tolist()) < set(wide.tolist())


# Arguments the JAX package takes that the port refused until the serving
# slice ported them, each with a check of what it does now.
PORTED_IN_SERVING_SLICE = {
    (".serving.engine", "ServingRequest", "clock"): _ported_request_clock,
    (".serving.engine", "InferenceEngine", "max_len"): _ported_max_len,
    (".serving.engine", "InferenceEngine", "slo_ttft_s"): lambda: _ported_slo("ttft"),
    (".serving.engine", "InferenceEngine", "slo_token_s"): lambda: _ported_slo("token"),
    (".serving.engine", "InferenceEngine", "registry"): _ported_registry,
    (".serving.engine", "InferenceEngine", "clock"): _ported_clock,
    (".serving.engine", "InferenceEngine", "flush_every"): _ported_flush_every,
    (".serving.engine", "InferenceEngine", "check_memory"): _ported_check_memory,
    (".serving.engine", "InferenceEngine", "attention"): _ported_attention,
    (".models.generate", "generate", "temperature"): lambda: _ported_generate(),
    (".models.generate", "generate", "top_k"): lambda: _ported_generate(top_k=3),
    (".models.generate", "generate", "top_p"): lambda: _ported_generate(top_p=0.5),
    (".models.generate", "generate", "prefill"): lambda: _ported_generate(prefill="scan"),
}


@pytest.mark.parametrize("where,name,arg", list(PORTED_IN_SERVING_SLICE),
                         ids=[f"{w}-{n}-{a}" for w, n, a in PORTED_IN_SERVING_SLICE])
def test_serving_slice_arguments_take_effect(where, name, arg):
    """Each argument the serving slice ported is a parameter of both
    packages' callables with the same default, and setting it does what
    the JAX package's does (no ``NotImplementedError``)."""
    fn = getattr(importlib.import_module("fluxmpi_tpu_torch" + where), name)
    ref = getattr(importlib.import_module("fluxmpi_tpu" + where), name)
    mine, theirs = inspect.signature(fn).parameters, inspect.signature(ref).parameters
    assert arg in mine and arg in theirs
    if isinstance(theirs[arg].default, LITERALS):
        assert mine[arg].default == theirs[arg].default
    PORTED_IN_SERVING_SLICE[(where, name, arg)]()
