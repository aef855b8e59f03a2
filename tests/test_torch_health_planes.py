"""The run-health and live-export planes as a whole, in the port against
the JAX package, on the CPU.

- C.12: the port's fused ``train_loop`` summary carries every key of the
  JAX package's (``window_compile_seconds`` beside ``window_cache``), the
  tiny LM fused through both; ``window_compile_seconds`` is the sum of the
  run's CUDA-graph capture seconds (0.0 on the CPU, where nothing is
  captured; the capture seconds of a program patched to report a build
  on its first call, as a capture does on the card).
- Planes on against off: the tiny LM trains with the anomaly detector, the
  compile monitor, the model stats, the exporter, the fleet collector
  (scraping that exporter), goodput and the auto-profiler on, and again
  with every plane off: every parameter, adam moment and count
  bit-identical, pipelined and fused.
- ``init``'s environment: ``FLUXMPI_TPU_ANOMALY``, ``_MODEL_STATS``,
  ``_COMPILEPLANE``, ``_PROFILE_DIR``, ``_COMPILE_CACHE``, ``_EXPORT_PORT``
  (with ``_ADDR``) and ``_FLEET`` wire the same planes in both packages,
  and ``shutdown`` tears every one down.
- Every plane off (the default): the loop and the step call none of them
  and compute no stats, pipelined and fused.
"""

import socket
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fluxmpi_tpu as jfm
import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate
from fluxmpi_tpu.utils import profiling as jprof
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.parallel import train as ttrain
from fluxmpi_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)


@pytest.fixture(scope="module")
def lm_params():
    jlm = JaxLM(**CFG, attention="flash")
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False)
    return jlm, jax.tree_util.tree_map(np.asarray, params)


def _corpus(n=32, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 97, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % 97)
    return np.concatenate(seqs, axis=1).astype(np.int32)


def _port_run(params, fuse, steps=8, flush_every=4):
    corpus = _corpus()
    loader = tfm.DistributedDataLoader(
        tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
        shuffle=True, device="cpu")
    tlm = TransformerLM(**CFG, attention="flash", device="cpu")
    load_flax_params(tlm, params)
    opt = optim.adamw(1e-3)
    step = make_train_step(lambda p, ms, b: (
        tlm(b[0], targets=b[1], loss_chunk=64).mean(), ms), opt)
    state, summary = train_loop(step, TrainState.create(tlm, opt), loader, steps=steps,
                                flush_every=flush_every, fuse=fuse)
    return state, summary, step


def test_c12_fused_summary_carries_every_jax_key(world, lm_params, monkeypatch):
    jlm, params = lm_params
    corpus = _corpus()
    loader = jfm.DistributedDataLoader(
        jfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
        shuffle=True)
    opt = optax.adamw(1e-3)
    step = jax_make_train_step(lambda p, ms, b: (
        jlm.apply(p, b[0], train=False, targets=b[1], loss_chunk=64).mean(), ms), opt)
    _, jsum = jax_train_loop(step, replicate(JaxTrainState.create(params, opt)), loader,
                             steps=8, flush_every=4, fuse="window")
    assert jsum["window_compile_seconds"] > 0
    tfm.init(device="cpu")
    try:
        _, tsum, _ = _port_run(params, "window")
        assert set(jsum) <= set(tsum)
        assert tsum["window_compile_seconds"] == 0.0  # the CPU captures nothing
        assert tsum["window_cache"] == jsum["window_cache"]
        real_run = ttrain.WindowProgram._run

        def run(self, *args):
            first = not getattr(self, "_reported", False)
            self._reported = True
            out = real_run(self, *args)
            if first:  # a build reported as the card's capture would be
                self.last_compile_seconds = 0.125
                self.capture_seconds += 0.125
            return out

        monkeypatch.setattr(ttrain.WindowProgram, "_run", run)
        _, tsum, step = _port_run(params, "window", steps=8, flush_every=2)
        captured = sum(p.capture_seconds for p in step.__fluxmpi_window_cache__.values())
        assert tsum["window_compile_seconds"] == captured == 0.125
    finally:
        tfm.shutdown()


def _leaves(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
    out["count"] = state.opt_state["count"]
    return out


@pytest.mark.parametrize("fuse", [False, "window"])
def test_planes_on_against_off_are_bit_identical(lm_params, tmp_path, fuse):
    _, params = lm_params
    tfm.init(device="cpu")
    try:
        off, off_sum, _ = _port_run(params, fuse)
    finally:
        tfm.shutdown()
    exp = ttel.Exporter(0, "127.0.0.1", deadline=3600.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tfm.init(device="cpu", anomaly=ttel.AnomalyDetector(dump_dir=str(tmp_path)),
                 model_stats=3, compileplane=True, export=exp, goodput=True,
                 profile=str(tmp_path / "profile"))
        target = f"127.0.0.1:{exp.port}"
        tfm.init(fleet=ttel.FleetCollector([target], interval=0.05))
        try:
            on, on_sum, _ = _port_run(params, fuse)
            snap = ttel.get_fleet_collector().collect_once()
        finally:
            tfm.shutdown()
    assert on_sum["anomaly"] is None and "goodput" in on_sum
    assert snap["hosts"][target]["alive"]
    a, b = _leaves(on), _leaves(off)
    same = [k for k in b if torch.equal(a[k], b[k])]
    assert len(same) == len(b) > 100
    assert [f["loss"] for f in on_sum["flushes"]] == [f["loss"] for f in off_sum["flushes"]]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wired(tel, prof):
    return dict(
        anomaly=tel.anomaly.get_anomaly_detector() is not None,
        model_stats=getattr(tel.modelstats.get_model_stats(), "depth", None),
        compileplane=tel.compileplane.get_compile_monitor() is not None,
        profile=getattr(prof.get_auto_profiler(), "logdir", None),
        export=getattr(tel.export.get_exporter(), "running", False),
        fleet=tel.fleet.enabled() and tel.fleet.get_fleet_collector() is not None)


def test_init_environment_wires_the_same_planes_in_both(world, tmp_path, monkeypatch):
    env = {"FLUXMPI_TPU_ANOMALY": "1", "FLUXMPI_TPU_MODEL_STATS": "3",
           "FLUXMPI_TPU_COMPILEPLANE": "1", "FLUXMPI_TPU_PROFILE_DIR": str(tmp_path),
           "FLUXMPI_TPU_COMPILE_CACHE": str(tmp_path / "cache"),
           "FLUXMPI_TPU_EXPORT_ADDR": "127.0.0.1", "FLUXMPI_TPU_FLEET": "1",
           "FLUXMPI_TPU_FLEET_INTERVAL": "60"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for name, tel, prof, init in (("port", ttel, tprof, lambda: tfm.init(device="cpu")),
                                  ("jax", jtel, jprof, jfm.init)):
        monkeypatch.setenv("FLUXMPI_TPU_EXPORT_PORT", str(_free_port()))
        with pytest.warns(UserWarning, match="compile cache skipped"):
            init()
        try:
            got[name] = _wired(tel, prof)
            assert tel.fleet.get_fleet_collector().targets == (
                f"127.0.0.1:{tel.export.get_exporter().port}",)
        finally:
            if name == "port":
                tfm.shutdown()
            else:
                tel.shutdown()
        assert _wired(tel, prof) == dict(anomaly=False, model_stats=None,
                                         compileplane=False, profile=None,
                                         export=False, fleet=False)
    assert got["port"] == got["jax"] == dict(
        anomaly=True, model_stats=3, compileplane=True, profile=str(tmp_path),
        export=True, fleet=True)


@pytest.mark.parametrize("fuse", [False, "window"])
def test_every_plane_off_costs_nothing(lm_params, monkeypatch, fuse):
    """Off (the default), the loop and the step touch none of the new
    planes: no detector, compile monitor, exporter or model-stats call and
    no stats computed (each patched to raise)."""
    from fluxmpi_tpu_torch.telemetry import modelstats

    _, params = lm_params

    def boom(*a, **k):
        raise AssertionError("a plane was touched with every plane off")

    for cls, name in ((ttel.AnomalyDetector, "observe"),
                      (ttel.CompileMonitor, "observe_flush"),
                      (ttel.CompileMonitor, "note_aot_compile"),
                      (ttel.Exporter, "note_status"),
                      (ttel.ModelStats, "observe_flush")):
        monkeypatch.setattr(cls, name, boom)
    monkeypatch.setattr(modelstats, "stats_tensor", boom)
    tfm.init(device="cpu")
    try:
        assert ttel.get_anomaly_detector() is None and ttel.get_exporter() is None
        _, summary, step = _port_run(params, fuse, steps=4, flush_every=2)
    finally:
        tfm.shutdown()
    assert summary["updates"] == 4 and summary["anomaly"] is None
    assert step.__fluxmpi_window_meta__["aux"] == ("loss",)
