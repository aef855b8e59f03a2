"""The port's model-internals plane (``fluxmpi_tpu_torch.telemetry.
modelstats`` and ``make_train_step(model_stats=)``) against the JAX
package's, on the CPU.

- ``group_paths``/``compute_stats``: the tiny LM (2 layers, d 32, vocab 97,
  the JAX package's weights), one update's gradients, pre-update
  parameters and adamw updates from the port, handed as numpy to JAX's
  ``compute_stats``: the same groups at depths 1-4, every norm within 1e-5
  relative, the same nonfinite counts, NaN provenance naming the same
  group.
- ``ModelStats.observe_flush``, ``noise_scale``, ``resolve_step_spec`` and
  ``configure``: the same summaries, gauges and forms in both packages.
- ``train_loop``: both packages' loops with the plane on (depth 3), the
  flushed ``model.*`` records equal within 1e-5 relative (gradient and
  parameter norms; the update-to-weight ratios within 1e-4, see the
  test) and exactly (counts), pipelined and fused.
- The noise scale: a 2-rank gloo world (``FileStore``) runs the port's MLP
  step with ``model_stats=True`` on each rank's half of a batch of 8; the
  ingredients (the ranks' mean pre-all-reduce sq-norm, the reduced
  gradient's sq-norm) and B_simple equal JAX's ``style="shard_map"`` step
  on 2 of its CPU devices within 1e-5 relative, with ``grad_reduce``
  ``"mean"`` and ``"sum"``.
"""

import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import fluxmpi_tpu as jfm
import fluxmpi_tpu.telemetry as jtel
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.telemetry as ttel
from fluxmpi_tpu.models import MLP as JaxMLP
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.train import replicate, shard_batch
from fluxmpi_tpu.telemetry import modelstats as jms
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.telemetry import modelstats as tms

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=97, max_len=32, num_layers=2, d_model=32, num_heads=4, d_ff=64)
RTOL = 1e-5
UPDATE_RTOL = 1e-4
JOIN_TIMEOUT = 240


@pytest.fixture()
def planes_off():
    prev = [(m.modelstats.set_model_stats(None), m.anomaly.set_anomaly_detector(None))
            for m in (jtel, ttel)]
    yield
    for m, (ms, det) in zip((jtel, ttel), prev):
        m.modelstats.set_model_stats(ms)
        m.anomaly.set_anomaly_detector(det)


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


def _nest(flat: dict) -> dict:
    """``{"a.b.c": tensor}`` → the JAX package's ``{"params": {"a": ...}}``
    tree of numpy arrays."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return {"params": out}


def _one_update(lm_params, nan_in=None):
    """The port's tiny LM: (grads, pre-update params, updates) of one adamw
    update on a batch of the corpus (``nan_in``: that gradient's first
    element set to NaN)."""
    _, params = lm_params
    tlm = TransformerLM(**CFG, attention="flash", device="cpu")
    load_flax_params(tlm, params)
    corpus = torch.from_numpy(_corpus()[:8]).long()
    p = dict(tlm.named_parameters())
    loss = tlm(corpus[:, :-1], targets=corpus[:, 1:]).mean()
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    if nan_in is not None:
        grads[nan_in].view(-1)[0] = float("nan")
    opt = optim.adamw(1e-3)
    updates, _ = opt.update(grads, opt.init(p), p)
    return grads, {k: v.detach() for k, v in p.items()}, updates


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_compute_stats_matches_jax(lm_params, depth):
    grads, params, updates = _one_update(lm_params)
    got = tms.compute_stats(grads, params, updates, depth=depth)["layers"]
    want = jms.compute_stats(_nest(grads), _nest(params), _nest(updates),
                             depth=depth)["layers"]
    assert list(got) == list(want)  # the same groups in the same order
    assert list(tms.group_paths(params, depth)) == list(
        jms.group_paths(_nest(params), depth))
    for name in want:
        for stat in ("grad_norm", "param_norm", "update_norm"):
            np.testing.assert_allclose(float(got[name][stat]), float(want[name][stat]),
                                       rtol=RTOL, err_msg=f"{name} {stat}")
        assert float(got[name]["nonfinite"]) == float(want[name]["nonfinite"]) == 0.0
    zeros = tms.stats_zeros(params, depth=depth, noise=True)
    assert set(zeros["layers"]) == set(want) and set(zeros["noise"]) == {
        "local_sqnorm", "global_sqnorm"}


def test_nan_provenance_names_the_same_group(lm_params):
    grads, params, updates = _one_update(lm_params, nan_in="encoder.block_1.ff1.kernel")
    got = tms.compute_stats(grads, params, updates, depth=3)
    want = jms.compute_stats(_nest(grads), _nest(params), _nest(updates), depth=3)
    tsum = tms.ModelStats(registry=ttel.MetricsRegistry(), depth=3).observe_flush(
        tms.stats_tree(list(got["layers"]), torch.stack(
            [torch.stack(list(v.values())) for v in got["layers"].values()])))
    jsum = jms.ModelStats(registry=jtel.MetricsRegistry(), depth=3).observe_flush(
        jax.device_get(want))
    assert tsum["nonfinite_layer"] == jsum["nonfinite_layer"] == "params/encoder/block_1"
    assert tsum["nonfinite_total"] == jsum["nonfinite_total"] == 1


def test_observe_flush_noise_scale_and_forms_match(planes_off, monkeypatch):
    stats = {"layers": {
        "params/a": {"grad_norm": 2.0, "param_norm": 4.0, "update_norm": 0.2,
                     "nonfinite": 0.0},
        "params/b": {"grad_norm": 1.0, "param_norm": 2.0, "update_norm": 0.1,
                     "nonfinite": 2.0},
        "params/c": {"grad_norm": 0.0, "param_norm": 0.0, "update_norm": 0.0,
                     "nonfinite": 0.0}},
        "noise": {"local_sqnorm": 3.0, "global_sqnorm": 1.0}}
    out = {}
    for name, tel in (("port", ttel), ("jax", jtel)):
        reg = tel.MetricsRegistry()
        summary = tel.modelstats.ModelStats(registry=reg, top_k=2).observe_flush(
            stats, step=5, batch_examples=64, workers=4)
        recs = sorted((m["name"], tuple(sorted(m["labels"].items())), m["value"])
                      for m in reg.snapshot())
        out[name] = (summary, recs)
    assert out["port"] == out["jax"]
    assert out["port"][0]["noise_scale"] is not None
    for args in ((3.0, 1.0), (1.0, 3.0), (float("nan"), 1.0), (2.0, 2.0)):
        for workers in (1, 2, 8):
            assert tms.noise_scale(*args, batch_examples=64, workers=workers) == \
                jms.noise_scale(*args, batch_examples=64, workers=workers)
    for ms in (tms, jms):
        assert ms.resolve_step_spec(None) is None and ms.resolve_step_spec(True) == 2
        assert ms.resolve_step_spec(3) == 3 and ms.resolve_step_spec(False) is None
        with pytest.raises(ValueError, match="model_stats must be"):
            ms.resolve_step_spec(0)
        assert ms.configure() is None
        monkeypatch.setenv("FLUXMPI_TPU_MODEL_STATS", "1")
        monkeypatch.setenv("FLUXMPI_TPU_MODEL_STATS_DEPTH", "3")
        monkeypatch.setenv("FLUXMPI_TPU_MODEL_STATS_TOPK", "7")
        plane = ms.configure()
        assert (plane.depth, plane.top_k) == (3, 7) and ms.configure("1") is plane
        assert ms.resolve_step_spec(None) == 3
        assert ms.configure(4).depth == 4
        with pytest.raises(ValueError, match="model_stats spec"):
            ms.configure("deep")
        assert ms.configure(False) is None and ms.get_model_stats() is None
        for var in ("", "_DEPTH", "_TOPK"):
            monkeypatch.delenv(f"FLUXMPI_TPU_MODEL_STATS{var}")


# ---------------------------------------------------------------------------
# train_loop: the flushed model.* records of both packages
# ---------------------------------------------------------------------------


def _model_records(reg):
    return {(m["name"], m["labels"].get("layer")): m["value"] for m in reg.snapshot()
            if m["name"].startswith("model.")}


@pytest.mark.parametrize("fuse", [False, "window"])
def test_train_loop_model_records_match_jax(world, lm_params, fuse, planes_off):
    jlm, params = lm_params
    corpus = _corpus()
    jreg, treg = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    jtel.modelstats.configure(3)
    loader = jfm.DistributedDataLoader(
        jfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8)

    def jloss(p, ms, b):
        return jlm.apply(p, b[0], train=False, targets=b[1], loss_chunk=64).mean(), ms

    jopt = optax.adamw(1e-3)
    jstep = jax_make_train_step(jloss, jopt, metrics=jreg)
    _, jsum = jax_train_loop(jstep, replicate(JaxTrainState.create(params, jopt)), loader,
                             steps=4, flush_every=2, fuse=fuse)
    tfm.init(device="cpu")
    try:
        ttel.modelstats.configure(3)
        tlm = TransformerLM(**CFG, attention="flash", device="cpu")
        load_flax_params(tlm, params)
        tloader = tfm.DistributedDataLoader(
            tfm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8,
            device="cpu")
        topt = optim.adamw(1e-3)
        tstep = make_train_step(lambda p, ms, b: (
            tlm(b[0], targets=b[1], loss_chunk=64).mean(), ms), topt, metrics=treg)
        _, tsum = train_loop(tstep, TrainState.create(tlm, topt), tloader, steps=4,
                             flush_every=2, fuse=fuse)
    finally:
        tfm.shutdown()
    assert tsum["fused_window"] == jsum["fused_window"]
    got, want = _model_records(treg), _model_records(jreg)
    # The port's step is the JAX package's shard_map step, whose all-reduce
    # gives the noise ingredients (JAX's default "auto" step has none); in
    # a world of one worker the local sq-norm is the global one.
    noise = {("model.grad_sqnorm_local", None), ("model.grad_sqnorm_global", None)}
    assert got[("model.grad_sqnorm_local", None)] == got[("model.grad_sqnorm_global", None)]
    got = {k: v for k, v in got.items() if k not in noise}
    assert set(got) == set(want) and len(want) == 4 * 5  # five groups at depth 3
    for key, value in want.items():
        if key[0] == "model.nonfinite":
            assert got[key] == value == 0.0
        else:
            # A key bias's gradient is 0 in exact arithmetic and rounding
            # noise in both frameworks; adam divides that noise by its own
            # size, so each side moves those entries by up to lr in either
            # direction, which reaches the update norms at ~1e-5.
            tol = UPDATE_RTOL if key[0] == "model.update_ratio" else RTOL
            np.testing.assert_allclose(got[key], value, rtol=tol, err_msg=str(key))


# ---------------------------------------------------------------------------
# The noise scale at 2 gloo ranks against JAX's shard_map step
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store_path, out, data_path = (int(sys.argv[1]), int(sys.argv[2]),
                                               sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
    from fluxmpi_tpu_torch.telemetry import modelstats

    fm.init(device="cpu")
    data = np.load(data_path)
    params = {k[len("params/"):].replace("/", "."): torch.from_numpy(data[k])
              for k in data.files if k.startswith("params/")}
    per = data["x"].shape[0] // world
    x = torch.from_numpy(data["x"][rank * per:(rank + 1) * per])
    y = torch.from_numpy(data["y"][rank * per:(rank + 1) * per])
    res = {}
    for reduce in ("mean", "sum"):
        model = MLP((8, 8, 1), device="cpu")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])

        def loss_fn(p, ms, b):
            out = torch.func.functional_call(model, p, (b[0],))
            return ((out - b[1]) ** 2).mean(), ms

        opt = optim.sgd(0.1)
        step = make_train_step(loss_fn, opt, grad_reduce=reduce, model_stats=True)
        _, (loss, gnorm, (table, noise)) = step.__fluxmpi_compiled__(
            TrainState.create(model, opt), (x, y))
        res[f"{reduce}/noise"] = noise.numpy()
        res[f"{reduce}/table"] = table.numpy()
    np.savez(out, **res)
    fm.shutdown()
    # No rank tears its group down while a peer's last collective is in
    # flight with it.
    dist.barrier()
    dist.destroy_process_group()
''')


def _run_world(tmp, world, data_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), str(tmp / "store"),
             str(tmp / f"rank{rank}.npz"), str(data_path)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(world))
    assert not hung, f"a rank hung past {JOIN_TIMEOUT}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _jax_noise(params, x, y, reduce, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    model = JaxMLP(features=(8, 8, 1))

    def loss_fn(p, ms, b):
        return jnp.mean((model.apply(p, b[0]) - b[1]) ** 2), ms

    opt = optax.sgd(0.1)
    step = jax_make_train_step(loss_fn, opt, mesh=mesh, axis_name="dp", style="shard_map",
                               grad_reduce=reduce, donate=False, model_stats=True)
    state = replicate(JaxTrainState.create(params, opt, None), mesh)
    _, aux = step.__fluxmpi_compiled__(state, shard_batch((jnp.asarray(x),
                                                           jnp.asarray(y)), mesh))
    return jax.device_get(aux[2])


def test_noise_scale_at_two_gloo_ranks_matches_jax_shard_map(world, tmp_path, planes_off):
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, size=(8, 1)).astype(np.float32)
    y = (x ** 2).astype(np.float32)
    params = jax.device_get(JaxMLP(features=(8, 8, 1)).init(
        jax.random.PRNGKey(1), np.zeros((2, 1), np.float32)))
    flat = {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    np.savez(tmp_path / "data.npz", x=x, y=y, **flat)
    ranks = _run_world(tmp_path, 2, tmp_path / "data.npz")
    for reduce in ("mean", "sum"):
        want = _jax_noise(params, x, y, reduce, 2)
        wl, wg = float(want["noise"]["local_sqnorm"]), float(want["noise"]["global_sqnorm"])
        for r in ranks:
            local, glob = r[f"{reduce}/noise"]
            np.testing.assert_allclose([local, glob], [wl, wg], rtol=RTOL)
            got = tms.noise_scale(float(local), float(glob), batch_examples=8, workers=2)
            ref = jms.noise_scale(wl, wg, batch_examples=8, workers=2)
            assert (got is None) == (ref is None)
            if ref is not None:
                np.testing.assert_allclose(got, ref, rtol=1e-4)
            names = list(want["layers"])
            for i, name in enumerate(names):
                np.testing.assert_allclose(
                    r[f"{reduce}/table"][i, :3],
                    [float(want["layers"][name][s]) for s in
                     ("grad_norm", "param_norm", "update_norm")], rtol=RTOL, err_msg=name)
        assert np.array_equal(ranks[0][f"{reduce}/noise"], ranks[1][f"{reduce}/noise"])
        # The ranks' own gradients differ: the local mean is above the
        # reduced gradient's sq-norm.
        assert wl > wg
