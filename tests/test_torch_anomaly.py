"""The port's anomaly detector (``fluxmpi_tpu_torch.telemetry.anomaly``)
against the JAX package's, on the CPU.

- The rule engine: both detectors get the same sequences of flush
  observations, made from a seed with numpy (losses with a spike and a NaN,
  gradient norms with an Inf, step times with a regression, loader waits
  with a stall, retraces, per-layer norms with an explosion and a dead
  layer, SLO burn rates, straggler verdicts), and must emit the same
  events, in the same order, with the same policies and values (exact:
  the arithmetic is the same Python).
- Configuration: the spec forms and ``FLUXMPI_TPU_ANOMALY`` /
  ``FLUXMPI_TPU_ANOMALY_DIR`` give the same detectors; the bundle is a
  watchdog-dump record with the ``anomaly`` section, valid in both.
- ``train_loop`` with a ``"halt"`` policy: an MLP whose second layer's
  gradient (only) turns NaN on a sentinel batch halts both packages at the
  same flush with ``summary["anomaly"] == "nan_grad"`` and the event names
  the same layer (the model-stats plane's NaN provenance).
- Serving's ``slo_burn`` rule: the port's counterparts of the JAX package's
  ``test_slo_burn_anomaly_rule`` and
  ``test_slo_burn_anomaly_fires_on_regression_silent_when_healthy``.
"""

import json
import warnings

import numpy as np
import optax
import pytest
import torch

import jax

import fluxmpi_tpu as jfm
import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import MLP, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

torch.set_num_threads(1)

PACKAGES = {"jax": jtel, "port": ttel}


@pytest.fixture()
def quiet_detectors():
    """No detector or model-stats plane installed around a test (both
    packages), restoring what was there."""
    prev = {n: (m.anomaly.set_anomaly_detector(None), m.modelstats.set_model_stats(None))
            for n, m in PACKAGES.items()}
    yield
    for n, (det, ms) in prev.items():
        PACKAGES[n].anomaly.set_anomaly_detector(det)
        PACKAGES[n].modelstats.set_model_stats(ms)


def _observations(seed: int = 0):
    """One run's flush observations: a healthy warmup, then each rule's
    trigger, interleaved with healthy flushes."""
    rng = np.random.default_rng(seed)
    obs = []
    layers = {"params/dense_0": 1.0, "params/dense_1": 0.5, "params/dense_2": 0.2}
    for i in range(40):
        norms = {k: v * float(rng.uniform(0.9, 1.1)) for k, v in layers.items()}
        o = dict(loss=float(2.0 - 0.01 * i + rng.normal(0, 0.01)),
                 grad_norm=float(rng.uniform(0.5, 1.5)),
                 step_seconds=float(0.1 + rng.normal(0, 0.002)),
                 fetch_seconds=float(rng.uniform(0.0, 0.01)),
                 layer_grad_norms=norms, step=(i + 1) * 4)
        if i == 10:
            o["loss"] = 50.0  # a spike
        if i == 14:
            o["step_seconds"] = 1.0  # a regression
        if i == 17:
            o["fetch_seconds"] = 0.09  # input-bound
        if i == 20:
            o["retraces"], o["retraced"] = 2, "train_loop.window"
        if i == 23:
            o["layer_grad_norms"] = dict(norms, **{"params/dense_1": 40.0})
        if 25 <= i < 30:
            o["layer_grad_norms"] = dict(norms, **{"params/dense_2": 0.0})
        if i == 31:
            o["grad_norm"] = float("inf")
            o["nonfinite_layer"] = "params/dense_1"
        if i == 33:
            o["loss"] = float("nan")
            o["nonfinite_layer"] = "params/dense_0"
        if i in (35, 36):
            o["slo_burn"] = 1.5 if i == 35 else 3.0
        obs.append(o)
    return obs


def _drive(tel, obs, stragglers, **kw):
    det = tel.AnomalyDetector(dump=False, registry=tel.MetricsRegistry(), **kw)
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for o in obs:
            events += det.observe(**o)
        for host in stragglers:
            events += det.observe_straggler(host, step=99)
    counts = {m["labels"]["rule"]: m["value"] for m in det._registry.snapshot()
              if m["name"] == "anomaly.triggered"}
    return events, counts


@pytest.mark.parametrize("policies", [None, {"loss_spike": "halt", "data_stall": "off"},
                                      {"nan_grad": "warn", "dead_layer": "off"}])
@pytest.mark.parametrize("seed", [0, 1])
def test_both_detectors_emit_the_same_events(policies, seed):
    obs = _observations(seed)
    stragglers = ["h1", "h1", None, "h2", "h2", "h2", "h2", "h1"]
    got, want = (_drive(tel, obs, stragglers, policies=policies)
                 for tel in (ttel, jtel))
    assert got == want
    rules = [e["rule"] for e in got[0]]
    for rule in ("loss_spike", "step_time_regression", "steady_state_retrace",
                 "layer_grad_explosion", "nan_grad", "nan_loss", "slo_burn",
                 "persistent_straggler"):
        if (policies or {}).get(rule) != "off":
            assert rule in rules, rule
    nan_grad = [e for e in got[0] if e["rule"] == "nan_grad"]
    assert nan_grad[0]["layer"] == "params/dense_1" and nan_grad[0]["value"] is None


def test_default_policies_rules_and_validation_equal():
    t, j = ttel.anomaly, jtel.anomaly
    assert t.RULES == j.RULES and t.POLICIES == j.POLICIES
    assert t._DEFAULT_POLICIES == j._DEFAULT_POLICIES
    assert t._PROFILE_TRIGGER_RULES == j._PROFILE_TRIGGER_RULES
    for kw, match in (({"policies": {"bogus": "warn"}}, "unknown anomaly rule"),
                      ({"policies": {"nan_loss": "explode"}}, "policy must be"),
                      ({"ewma_alpha": 0.0}, "ewma_alpha"), ({"warmup": 0}, "warmup"),
                      ({"dead_layer_flushes": 0}, "dead_layer_flushes"),
                      ({"persistent_straggler_intervals": 0}, "persistent_straggler")):
        for tel in (ttel, jtel):
            with pytest.raises(ValueError, match=match):
                tel.AnomalyDetector(**kw)


def test_configure_forms_and_env_match(monkeypatch, tmp_path, quiet_detectors):
    for tel in (ttel, jtel):
        an = tel.anomaly
        monkeypatch.setenv("FLUXMPI_TPU_ANOMALY_DIR", str(tmp_path))
        assert an.configure() is None  # env unset: no-op
        monkeypatch.setenv("FLUXMPI_TPU_ANOMALY", "1")
        det = an.configure()
        assert det.policies["nan_loss"] == "halt" and det.dump_dir == str(tmp_path)
        assert an.configure(True) is det  # idempotent replay
        warn = an.configure("warn")
        assert set(warn.policies.values()) == {"warn"} and warn is not det
        assert an.configure(True) is not warn  # True means the halting defaults
        with pytest.raises(ValueError, match="anomaly spec"):
            an.configure(3.5)
        assert an.configure(False) is None and an.get_anomaly_detector() is None
        monkeypatch.delenv("FLUXMPI_TPU_ANOMALY")


def test_bundle_is_a_valid_watchdog_record_in_both(tmp_path, quiet_detectors):
    sections = {}
    for name, tel in PACKAGES.items():
        det = tel.AnomalyDetector(dump_dir=str(tmp_path / name),
                                  registry=tel.MetricsRegistry())
        with pytest.warns(UserWarning, match="nan_grad"):
            (ev,) = det.observe(grad_norm=float("nan"), nonfinite_layer="params/x",
                                step=7)
        assert det.last_dump_path == str(tmp_path / name / "fluxmpi_anomaly.0.json")
        rec = json.loads((tmp_path / name / "fluxmpi_anomaly.0.json").read_text())
        assert tel.validate_watchdog_dump(rec) == []
        assert jtel.validate_watchdog_dump(rec) == []
        assert rec["reason"] == "anomaly:nan_grad"
        sections[name] = rec["anomaly"]
    assert sections["port"] == sections["jax"] == {
        "rule": "nan_grad", "action": "halt", "value": None, "value_repr": "nan",
        "step": 7, "layer": "params/x"}


# ---------------------------------------------------------------------------
# train_loop halts on a NaN gradient in one layer
# ---------------------------------------------------------------------------


def _mlp_data(n=256, sentinel_from=192):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    y = (x ** 2).astype(np.float32)
    x[sentinel_from] = 1000.0  # the batch whose dense_1 gradient turns NaN
    return x, y


def _jax_halting_run(tmp_path, x, y):
    model = JaxMLP(features=(8, 8, 1))

    @jax.custom_vjp
    def poison(w, flag):
        return w

    poison.defvjp(lambda w, flag: (w, flag),
                  lambda flag, g: (jax.numpy.where(flag, jax.numpy.nan, g), None))

    def loss_fn(p, ms, b):
        bx, by = b
        flag = jax.numpy.any(bx > 100.0)
        inner = dict(p["params"])
        inner["dense_1"] = dict(inner["dense_1"], kernel=poison(inner["dense_1"]["kernel"],
                                                                flag))
        bx = jax.numpy.where(jax.numpy.abs(bx) > 100.0, 0.0, bx)
        return jax.numpy.mean((model.apply({"params": inner}, bx) - by) ** 2), ms

    params = jax.device_get(model.init(jax.random.PRNGKey(0), np.zeros((2, 1), np.float32)))
    opt = optax.adam(1e-3)
    jtel.modelstats.configure(True)
    det = jtel.AnomalyDetector(dump_dir=str(tmp_path / "jax"), registry=jtel.MetricsRegistry())
    jtel.anomaly.set_anomaly_detector(det)
    step = jax_make_train_step(loss_fn, opt)
    loader = jfm.DistributedDataLoader(jfm.ArrayDataset((x, y)), 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, summary = jax_train_loop(step, replicate(JaxTrainState.create(params, opt, None)),
                                    loader, epochs=2, flush_every=2, fuse=False)
    return params, summary, det


class _Poison(torch.autograd.Function):
    """Identity on the weight; its gradient turns NaN when ``flag``."""

    @staticmethod
    def forward(ctx, w, flag):
        ctx.save_for_backward(flag)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        (flag,) = ctx.saved_tensors
        return torch.where(flag, torch.full_like(g, float("nan")), g), None


def _port_halting_run(tmp_path, params, x, y, fuse):
    model = MLP((8, 8, 1), device="cpu")
    load_flax_params(model, params)

    def loss_fn(p, ms, b):
        bx, by = b
        flag = (bx > 100.0).any()
        w = dict(p)
        w["dense_1.kernel"] = _Poison.apply(p["dense_1.kernel"], flag)
        bx = torch.where(bx.abs() > 100.0, torch.zeros_like(bx), bx)
        out = torch.func.functional_call(model, w, (bx,))
        return ((out - by) ** 2).mean(), ms

    opt = optim.adam(1e-3)
    ttel.modelstats.configure(True)
    det = ttel.AnomalyDetector(dump_dir=str(tmp_path / "port"), registry=ttel.MetricsRegistry())
    ttel.anomaly.set_anomaly_detector(det)
    step = make_train_step(loss_fn, opt)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 64, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, summary = train_loop(step, TrainState.create(model, opt), loader, epochs=2,
                                flush_every=2, fuse=fuse)
    return summary, det


@pytest.mark.parametrize("fuse", [False, "window"])
def test_train_loop_halts_on_nan_grad_like_the_jax_loop(world, tmp_path, fuse,
                                                        quiet_detectors):
    """Tolerance: none — the rule, the step, the layer and the counters are
    equal; the loss before the halt within 1e-5."""
    x, y = _mlp_data()
    params, jsum, jdet = _jax_halting_run(tmp_path, x, y)
    tfm.init(device="cpu")
    try:
        tsum, tdet = _port_halting_run(tmp_path, params, x, y, fuse)
    finally:
        tfm.shutdown()
    assert jsum["anomaly"] == tsum["anomaly"] == "nan_grad"
    assert jsum["updates"] == tsum["updates"] == 4
    jev = [e for e in jdet.triggered if e["rule"] == "nan_grad"]
    tev = [e for e in tdet.triggered if e["rule"] == "nan_grad"]
    assert tev == jev and tev[0]["layer"] == "params/dense_1" and tev[0]["step"] == 4
    assert [e["rule"] for e in tdet.triggered] == [e["rule"] for e in jdet.triggered]
    bundle = json.loads((tmp_path / "port" / "fluxmpi_anomaly.0.json").read_text())
    assert bundle["anomaly"]["layer"] == "params/dense_1"
    assert jtel.validate_watchdog_dump(bundle) == []
    np.testing.assert_allclose(tsum["loss"], jsum["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# Serving's slo_burn rule
# ---------------------------------------------------------------------------


def _tiny_lm():
    from fluxmpi_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=31, max_len=32, num_layers=1, d_model=16,
                         num_heads=2, d_ff=32, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _prompt(rng, n):
    return rng.integers(1, 31, size=n).tolist()


def test_slo_burn_anomaly_rule(quiet_detectors):
    """Counterpart of the JAX package's ``test_slo_burn_anomaly_rule``."""
    reg = ttel.get_registry()
    reg.reset()
    det = ttel.AnomalyDetector(dump=False)
    assert det.policies["slo_burn"] == "warn"
    assert det.observe(slo_burn=1.5, step=1) == []  # below the 2.0 default
    with pytest.warns(UserWarning, match="slo_burn"):
        events = det.observe(slo_burn=2.5, step=2)
    assert [e["rule"] for e in events] == ["slo_burn"] and events[0]["action"] == "warn"
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in reg.snapshot()}
    assert snap[("anomaly.triggered", (("rule", "slo_burn"),))] == 1
    reg.reset()


def test_slo_burn_anomaly_fires_on_regression_silent_when_healthy(quiet_detectors):
    """Counterpart of the JAX package's
    ``test_slo_burn_anomaly_fires_on_regression_silent_when_healthy``: an SLO
    floor no request can meet trips ``slo_burn`` through the engine's flush;
    a healthy run with the same wiring stays silent."""
    from fluxmpi_tpu_torch.serving import InferenceEngine, observe

    reg = ttel.get_registry()
    reg.reset()
    ttel.anomaly.set_anomaly_detector(ttel.AnomalyDetector(dump=False))
    observe.configure(True)
    try:
        eng = InferenceEngine(_tiny_lm(), slots=2, block_size=8, slo_ttft_s=1e-9)
        rng = np.random.default_rng(4)
        for _ in range(3):
            eng.submit(_prompt(rng, 4), 4)
        with pytest.warns(UserWarning, match="slo_burn"):
            eng.run()
        eng.close()
        snap = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
                for m in reg.snapshot() if m["type"] == "counter"}
        assert snap[("anomaly.triggered", (("rule", "slo_burn"),))] >= 1
        observe.shutdown()
        observe.configure(True)
        ttel.anomaly.set_anomaly_detector(ttel.AnomalyDetector(dump=False))
        reg.reset()
        eng2 = InferenceEngine(_tiny_lm(), slots=2, block_size=8)
        for _ in range(3):
            eng2.submit(_prompt(rng, 4), 4)
        eng2.run()
        eng2.close()
        assert not any(m["name"] == "anomaly.triggered" for m in reg.snapshot())
    finally:
        observe.shutdown()
        reg.reset()
