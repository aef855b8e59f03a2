"""The layout autotuner (``fluxmpi_tpu_torch.parallel.autotune``) against the
JAX package's (``tests/test_autotune.py``'s tests, held to the port).

In one process (the port's plans are plain data, so a search resolves over
8 workers as JAX's does over its 8 CPU devices):

- enumeration for the LM, the MoE LM, ViT and the MLP at two
  ``fsdp_min_size`` values: the same candidates in the same order (so the
  same dropped layouts), and the d_model-6 model whose tp=4/8 layouts drop;
- the memory model: the bytes oracle, and every candidate's
  ``mem_bytes_per_device`` equal to JAX's exactly under adamw and under
  sgd with momentum; ``model_fingerprint`` equal to JAX's;
- the prune verdicts given the same scores (pure dp kept; memory kills
  even pure dp), the static cost folding the attention kernels' work, and
  the score ranking a layout that moves more bytes no better than pure dp
  at equal FLOPs;
- the deterministic pick under a stubbed ``_run_trial`` (every candidate
  trialed): the JAX package's winner; the bank (an exploding trial on a
  hit), the file bank, a corrupt file, a topology change, the
  batch-divisibility and memory-limit errors;
- ``init(parallel="auto")``, ``FLUXMPI_TPU_PARALLEL=auto``, an unknown
  string, ``make_train_step(parallel="auto")`` before a tune; the
  partition-spec memo; the record validator's accept/reject matrix in
  both packages.

In a 4-rank gloo world (``tests/_torch_autotune_worker.py``, ``FileStore``,
one thread each): the end-to-end search with real trials (at least half
the candidates pruned statically, at most the budget trialed, zero steady
compiles, the same winner on every rank, installed, then trained through
``make_train_step(parallel="auto")``), the bank hit with an exploding
trial, the deterministic stub pick on every rank against JAX's, the file
bank shared through rank 0, the topology re-tune (2 workers against 4),
the sidecar and the manifest's fingerprint under a winner that does not
shard, ``train_loop(checkpoint=)`` saving and resuming a sharding winner's
state (one file per worker, the sidecar beside it), and the
eager collectives over ``dp`` and ``fsdp`` of a 2x2 mesh against JAX's.
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import fluxmpi_tpu.parallel.autotune  # noqa: F401
import fluxmpi_tpu_torch as tfm
import fluxmpi_tpu_torch.parallel.autotune  # noqa: F401
from fluxmpi_tpu_torch import optim

jat = sys.modules["fluxmpi_tpu.parallel.autotune"]
tat = sys.modules["fluxmpi_tpu_torch.parallel.autotune"]

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_autotune_worker.py"
JOIN_TIMEOUT = 300
DEVS = list(range(8))
LM = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64)
VIT = dict(num_classes=10, patch=4, num_layers=2, d_model=32, num_heads=4, d_ff=64)
MODELS = ("lm", "moe", "vit", "mlp")


def _models(name):
    """``(JAX variables, port model)`` of model ``name``, same shapes."""
    from fluxmpi_tpu import models as jm
    from fluxmpi_tpu.models import moe as jmoe
    from fluxmpi_tpu_torch import models as tm

    key = jax.random.PRNGKey(0)
    if name == "lm":
        j, x, t = jm.TransformerLM(**LM), jnp.zeros((2, 8), jnp.int32), tm.TransformerLM(
            **LM, device="cpu")
    elif name == "moe":
        j, x = jmoe.MoETransformerLM(**LM, num_experts=4), jnp.zeros((2, 8), jnp.int32)
        t = tm.MoETransformerLM(**LM, num_experts=4, device="cpu")
    elif name == "vit":
        j, x = jm.ViT(**VIT), jnp.zeros((2, 16, 16, 3))
        t = tm.ViT(**VIT, image_size=16, device="cpu")
    else:
        j, x = jm.MLP((64, 64, 64, 1)), jnp.zeros((2, 8))
        t = tm.MLP((64, 64, 64, 1), in_features=8, device="cpu")
    params = jax.eval_shape(lambda: j.init(key, x, **({} if name == "mlp" else
                                                       {"train": False}))["params"])
    return {"params": params}, t


def _axes(cands):
    return [tuple(c.axes[a] for a in ("dp", "fsdp", "tp")) for c in cands]


@pytest.mark.parametrize("min_size", [64, 1024])
@pytest.mark.parametrize("name", MODELS)
def test_enumerate_candidates_equal_jax(name, min_size):
    """The same candidate layouts in the same order (dp descending), so
    the same layouts dropped: a tp axis that divides nothing it matches,
    or an fsdp axis with no leaf of ``fsdp_min_size`` elements."""
    jvars, port = _models(name)
    want = _axes(jat.enumerate_candidates(jvars, jax.devices(), fsdp_min_size=min_size))
    got = _axes(tat.enumerate_candidates(port, DEVS, fsdp_min_size=min_size))
    assert got == want
    assert got[0] == (8, 1, 1)
    assert all(d * f * t == 8 for d, f, t in got)


def test_enumerate_drops_tp_that_cannot_divide():
    """d_model 6: tp=4 and tp=8 divide no matched dim, so those layouts
    drop, as in JAX."""
    rng = np.random.default_rng(0)
    shapes = {"attn.query.kernel": (6, 6, 1), "attn.out.kernel": (6, 1, 6)}
    port = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}
    jparams = {"attn": {"query": {"kernel": jnp.zeros((6, 6, 1))},
                        "out": {"kernel": jnp.zeros((6, 1, 6))}}}
    got = _axes(tat.enumerate_candidates(port, DEVS, fsdp_min_size=1))
    assert got and all(t not in (4, 8) for _, _, t in got)
    assert got == _axes(jat.enumerate_candidates({"params": jparams}, jax.devices(),
                                                 fsdp_min_size=1))


def test_tree_bytes_per_device_oracle():
    from fluxmpi_tpu_torch.parallel.sharding import P

    plan = tfm.ParallelConfig(dp=1, fsdp=8, fsdp_min_size=1).resolve(DEVS)
    leaf = torch.zeros((8, 16))  # 512 bytes
    assert tat._tree_bytes_per_device({"w": leaf}, {"w": P("fsdp", None)}, plan.mesh) == 64
    assert tat._tree_bytes_per_device({"w": leaf}, {"w": P(None, None)}, plan.mesh) == 512
    # Non-divisible shard: ceil, never undercount.
    assert tat._tree_bytes_per_device({"w": torch.zeros(9)}, {"w": P("fsdp")},
                                      plan.mesh) == 5


@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum"])
@pytest.mark.parametrize("name", MODELS)
def test_layout_bytes_equal_jax(name, opt):
    """Every candidate's static memory floor, byte for byte: the state on
    the meta device counted as optax's (adamw: mu, nu and one int32
    count; sgd with momentum: the trace) plus one gradient."""
    jvars, port = _models(name)
    jopt, topt = {"adamw": (optax.adamw(1e-3), optim.adamw(1e-3)),
                  "sgd_momentum": (optax.sgd(1e-2, momentum=0.9),
                                   optim.sgd(1e-2, momentum=0.9))}[opt]
    jtemplate = jat.state_template(jvars, jopt)
    ttemplate = tat.state_template(port, topt)
    assert all(t.device.type == "meta" for t in ttemplate.params.values())
    jc = jat.enumerate_candidates(jvars, jax.devices(), fsdp_min_size=64)
    tc = tat.enumerate_candidates(port, DEVS, fsdp_min_size=64)
    got = [tat.layout_bytes(ttemplate, c.plan) for c in tc]
    assert got == [jat.layout_bytes(jtemplate, c.plan) for c in jc]
    assert got[0] == max(got)  # replicated pure dp is the largest


@pytest.mark.parametrize("name", MODELS)
def test_model_fingerprint_equals_jax(name):
    jvars, port = _models(name)
    assert tat.model_fingerprint(port) == jat.model_fingerprint(jvars)
    assert tat.model_fingerprint(dict(port.named_parameters())) == tat.model_fingerprint(port)


def _candidates(fsdp_min_size=64):
    jvars, port = _models("lm")
    return (jat.enumerate_candidates(jvars, jax.devices(), fsdp_min_size=fsdp_min_size),
            tat.enumerate_candidates(port, DEVS, fsdp_min_size=fsdp_min_size))


def _verdict(cands, survivors):
    return ([c.pruned for c in cands], _axes(survivors))


def test_prune_verdicts_equal_jax_and_keep_pure_dp():
    """The same scores give the same verdicts; pure dp survives even
    ranked last."""
    jc, tc = _candidates()
    for cands in (jc, tc):
        for c in cands:
            c.mem_bytes_per_device = 1024
            c.score = float(c.axes["dp"])  # pure dp ranked LAST
    want = _verdict(jc, jat._prune(jc, bytes_limit=None, max_trials=3))
    survivors = tat._prune(tc, bytes_limit=None, max_trials=3)
    assert _verdict(tc, survivors) == want
    assert len(survivors) == 3 and (8, 1, 1) in _axes(survivors)
    assert sum(c.pruned == "dominated" for c in tc) == len(tc) - 3


def test_prune_memory_kills_infeasible_even_pure_dp():
    """The real memory model makes pure dp the largest layout; a budget
    below it prunes it ``"memory"``, as JAX's verdict does."""
    jvars, port = _models("lm")
    jc, tc = _candidates()
    jt = jat.state_template(jvars, optax.adamw(1e-3))
    tt = tat.state_template(port, optim.adamw(1e-3))
    for c in jc:
        c.mem_bytes_per_device, c.score = jat.layout_bytes(jt, c.plan), 1.0
    for c in tc:
        c.mem_bytes_per_device, c.score = tat.layout_bytes(tt, c.plan), 1.0
    limit = sorted(c.mem_bytes_per_device for c in tc)[-2]
    want = _verdict(jc, jat._prune(jc, bytes_limit=limit, max_trials=3))
    survivors = tat._prune(tc, bytes_limit=limit, max_trials=3)
    assert _verdict(tc, survivors) == want
    assert tc[0].pruned == "memory" and tc[0] not in survivors
    assert all(c.mem_bytes_per_device <= limit for c in survivors)


def _tiny_lm():
    from fluxmpi_tpu_torch.models import TransformerLM

    model = TransformerLM(**LM, device="cpu")

    def loss_fn(p, ms, b):
        out = torch.func.functional_call(model, p, (b["x"],), {"targets": b["y"]})
        return out.mean(), ms

    return model, loss_fn


def _batch(gbs=16, seq=8):
    rng = np.random.default_rng(1)
    return {"x": rng.integers(0, LM["vocab_size"], (gbs, seq)).astype(np.int64),
            "y": rng.integers(0, LM["vocab_size"], (gbs, seq)).astype(np.int64)}


def test_trial_that_does_not_fuse_raises_naming_its_layout(monkeypatch):
    """Every candidate is timed on the fused path: a trial whose run did not
    fuse (here a staging budget too small for the loader's device gather)
    raises, naming the candidate, instead of timing it pipelined."""
    from fluxmpi_tpu_torch.parallel import ParallelConfig

    model, loss_fn = _tiny_lm()
    plan = ParallelConfig().resolve([0])
    tfm.init(device="cpu")
    try:
        monkeypatch.setenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES", "1")
        with pytest.raises(RuntimeError,
                           match=r"the trial of layout \{.*'dp': 1.*\} ran pipelined"):
            tat._run_trial(loss_fn, optim.adamw(1e-3), model, None, _batch(), plan,
                           window=2, epochs=1, seed=0)
        monkeypatch.delenv("FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES")
        trial = tat._run_trial(loss_fn, optim.adamw(1e-3), model, None, _batch(), plan,
                               window=2, epochs=1, seed=0)
    finally:
        tfm.shutdown()
    assert trial["fused_window"] == 2 and trial["updates"] == 2


def test_static_cost_counts_kernel_work_and_ranks_bytes():
    """The kernels' FLOPs count (a flash-attention loss costs more than
    its twin without it, as ``test_static_cost_folds_pallas_kernel_work``
    asks of JAX), and at equal FLOPs a layout that moves more bytes scores
    no better than pure dp."""
    from fluxmpi_tpu_torch.ops import flash_attention

    plan = tfm.ParallelConfig(dp=8).resolve(DEVS)
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32) * 0.1)
              .requires_grad_()}
    batch = {"x": rng.normal(size=(8, 32, 2, 16)).astype(np.float32)}
    opt = optim.adamw(1e-3)
    template = tat.state_template(params, opt)

    def base(p, ms, b):
        return ((b["x"] @ p["w"]) ** 2).mean(), ms

    def flash(p, ms, b):
        q = b["x"] @ p["w"]
        return (flash_attention(q, q, q) ** 2).mean(), ms

    costs = [tat._static_cost(fn, opt, template, batch, plan, params=params)
             for fn in (base, flash)]
    assert costs[1]["flops"] > costs[0]["flops"] > 0
    assert costs[1]["bytes_accessed"] == costs[0]["bytes_accessed"]

    model, loss_fn = _tiny_lm()
    _, tc = _candidates()
    template = tat.state_template(model, opt)
    flops = tat._update_flops(loss_fn, model, None, _batch(), 8)
    scored = {}
    for c in tc:
        cost = tat._static_cost(loss_fn, opt, template, _batch(), c.plan, flops=flops)
        scored[_axes([c])[0]] = (cost, tat._score(cost))
    dp_cost, dp_score = scored[(8, 1, 1)]
    for cost, score in scored.values():
        assert cost["flops"] == dp_cost["flops"]
        if cost["bytes_accessed"] >= dp_cost["bytes_accessed"]:
            assert score >= dp_score
    # tp moves activations (their all-reduces grow with the tokens); a
    # layout without tp moves none.
    longer = _batch(seq=16)
    for axes, grows in [((4, 1, 2), True), ((4, 2, 1), False)]:
        plan = next(c.plan for c in tc if _axes([c])[0] == axes)
        more = tat._static_cost(loss_fn, opt, template, longer, plan, flops=flops)
        assert (more["bytes_accessed"] > scored[axes][0]["bytes_accessed"]) is grows


def _fake_trial(eps_fn, calls=None):
    """A deterministic ``_run_trial`` stand-in: throughput a pure function
    of the candidate's axes (``tests/test_autotune.py``'s)."""

    def fake(loss_fn, optimizer, host_params, model_state, sample_batch, plan, *,
             window, epochs, seed):
        axes = {a: plan.sizes.get(a, 1) for a in ("dp", "fsdp", "tp")}
        if calls is not None:
            calls.append(axes)
        return {"examples_per_sec": float(eps_fn(axes)), "updates": window * epochs,
                "compile_seconds": 0.01, "steady_compiles": 0, "retraces": 0,
                "seconds": 0.02}

    return fake


@contextlib.contextmanager
def _trial_as(module, fn):
    orig = module._run_trial
    module._run_trial = fn
    try:
        yield
    finally:
        module._run_trial = orig
        module.clear_bank()


def _eps(axes):
    return 100.0 * axes["fsdp"] + 10.0 * axes["tp"] + axes["dp"]


def test_deterministic_pick_equals_jax_under_a_stub():
    """Every candidate trialed under the same stub: the port's pick is the
    JAX package's, and two forced runs agree on the whole table."""
    from fluxmpi_tpu.models import TransformerLM as JaxLM

    model, loss_fn = _tiny_lm()
    jmodel = JaxLM(**LM)
    jvars = {"params": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                                   train=False)["params"]}

    def jloss(p, ms, b):
        return jnp.mean(jmodel.apply(p, b["x"], train=False, targets=b["y"])), ms

    kw = dict(fsdp_min_size=64, window=2, trial_epochs=1, trials=10, force=True)
    with _trial_as(jat, _fake_trial(_eps)):
        want = jat.autotune(jloss, optax.adamw(1e-3), jvars, _batch(), **kw)
    with _trial_as(tat, _fake_trial(_eps)):
        r1 = tat.autotune(loss_fn, optim.adamw(1e-3), model, _batch(), devices=DEVS, **kw)
        r2 = tat.autotune(loss_fn, optim.adamw(1e-3), model, _batch(), devices=DEVS, **kw)
    assert r1.record["winner"]["axes"] == want.record["winner"]["axes"] == {
        "dp": 1, "fsdp": 8, "tp": 1}
    assert r1.record["model_fingerprint"] == want.record["model_fingerprint"]
    assert r1.record["topology"]["n_devices"] == want.record["topology"]["n_devices"]
    strip = [{k: v for k, v in c.items() if k != "trial"} for c in r1.record["candidates"]]
    assert strip == [{k: v for k, v in c.items() if k != "trial"}
                     for c in r2.record["candidates"]]
    assert [c["mem_bytes_per_device"] for c in r1.record["candidates"]] == [
        c["mem_bytes_per_device"] for c in want.record["candidates"]]


def test_bank_file_topology_and_errors(tmp_path):
    """The bank answers a repeated search with no trial; the file bank
    survives a dropped in-process bank; a corrupt file re-tunes; another
    worker set re-tunes and the first is answered again; an indivisible
    batch and an impossible budget raise JAX's errors."""
    from fluxmpi_tpu.telemetry.schema import validate_autotune_record as jvalidate
    from fluxmpi_tpu_torch.telemetry.schema import validate_autotune_record

    model, loss_fn = _tiny_lm()
    bank = str(tmp_path / "bank.json")
    calls = []
    kw = dict(fsdp_min_size=64, window=2, trial_epochs=1, bank=bank)
    opt = optim.adamw(1e-3)

    def boom(*a, **k):  # pragma: no cover - must not run
        raise AssertionError("a trial ran on a bank hit")

    with _trial_as(tat, _fake_trial(lambda a: float(a["dp"]), calls)):
        r8 = tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, **kw)
        assert not r8.from_bank and calls
        assert validate_autotune_record(r8.record) == [] == jvalidate(r8.record)
        with open(bank) as f:
            assert json.load(f)["model_fingerprint"] == r8.record["model_fingerprint"]
        n8 = len(calls)
        r4 = tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS[:4], **kw)
        assert not r4.from_bank and len(calls) > n8
        assert r4.record["topology"]["n_devices"] == 4
        tat._run_trial = boom
        back = tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, **kw)
        assert back.from_bank and back.record["winner"] == r8.record["winner"]
        tat._BANK.clear()  # a "new process": only the file remains (the 4-worker tune)
        tat._bank_store(r8.record, bank)
        tat._BANK.clear()
        assert tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, **kw).from_bank
        tat._BANK.clear()
        with open(bank, "w") as f:
            f.write("{not json")
        tat._run_trial = _fake_trial(lambda a: float(a["dp"]), calls)
        assert not tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, **kw).from_bank
        with pytest.raises(ValueError, match="leading dim"):
            tat.autotune(loss_fn, opt, model, _batch(gbs=12), devices=DEVS)
        template = tat.state_template(model, opt)
        mems = sorted(tat.layout_bytes(template, c.plan)
                      for c in tat.enumerate_candidates(model, DEVS, fsdp_min_size=64))
        res = tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, fsdp_min_size=64,
                           bytes_limit=mems[len(mems) // 2], force=True)
        assert any(c["pruned"] == "memory" for c in res.record["candidates"])
        assert all(c["mem_bytes_per_device"] <= mems[len(mems) // 2]
                   for c in res.record["candidates"] if c["trial"])
        with pytest.raises(RuntimeError, match="does not fit"):
            tat.autotune(loss_fn, opt, model, _batch(), devices=DEVS, fsdp_min_size=64,
                         bytes_limit=1, force=True)


def test_init_parallel_auto_env_var_and_unknown_string(monkeypatch):
    """``init(parallel="auto")`` and ``FLUXMPI_TPU_PARALLEL=auto`` arm the
    autotuner with no plan installed yet; ``make_train_step(parallel=
    "auto")`` raises JAX's errors before a tune; an unknown string raises;
    ``shutdown`` disarms."""
    from fluxmpi_tpu_torch.parallel import make_train_step

    _, loss_fn = _tiny_lm()
    try:
        tfm.init(device="cpu", parallel="auto")
        assert tfm.runtime.auto_parallel() and tfm.global_plan() is None
        assert tfm.global_mesh().shape == {"dp": 1}
        with pytest.raises(ValueError, match="autotune"):
            make_train_step(loss_fn, optim.adamw(1e-3), parallel="auto")
        with pytest.raises(ValueError, match="auto"):
            make_train_step(loss_fn, optim.adamw(1e-3), parallel="fastest")
    finally:
        tfm.shutdown()
    assert not tfm.runtime.auto_parallel()
    try:
        tfm.init(device="cpu")
        assert not tfm.runtime.auto_parallel()
    finally:
        tfm.shutdown()
    monkeypatch.setenv("FLUXMPI_TPU_PARALLEL", "auto")
    try:
        tfm.init(device="cpu")
        assert tfm.runtime.auto_parallel()
    finally:
        tfm.shutdown()
    with pytest.raises(ValueError, match="auto"):
        tfm.init(device="cpu", parallel="fastest")
    assert not tfm.is_initialized()


def test_partition_specs_memoized():
    model, _ = _tiny_lm()
    plan = tfm.ParallelConfig(dp=4, fsdp=2, fsdp_min_size=256).resolve(DEVS)
    params = dict(model.named_parameters())
    specs1 = plan.partition_specs(params)
    assert (plan.spec_cache_misses, plan.spec_cache_hits) == (1, 0)
    hits1 = dict(plan.rule_hits)
    assert plan.partition_specs(params) is not None
    assert (plan.spec_cache_misses, plan.spec_cache_hits) == (1, 1)
    assert plan.rule_hits == hits1
    plan.partition_specs({"solo": torch.zeros(512)})
    assert plan.spec_cache_misses == 2
    assert plan.partition_specs(params) == specs1 and plan.spec_cache_hits == 2


def _minimal_record():
    return {
        "schema": "fluxmpi_tpu.autotune/v1", "time_unix": 1.7e9,
        "model_fingerprint": "abc123",
        "topology": {"n_devices": 8, "device_kind": "cpu", "process_count": 1},
        "fsdp_min_size": 256,
        "winner": {"axes": {"dp": 8}, "axis_names": {"dp": "dp"}},
        "trials": 1,
        "candidates": [
            {"axes": {"dp": 8}, "mem_bytes_per_device": 1024, "score": 10.0,
             "pruned": None, "trial": {"examples_per_sec": 100.0, "compile_seconds": 0.5,
                                       "steady_compiles": 0, "seconds": 1.0}},
            {"axes": {"dp": 4, "tp": 2}, "mem_bytes_per_device": 512, "score": None,
             "pruned": "dominated", "trial": None},
        ],
    }


@pytest.mark.parametrize("mutate, needle", [
    (None, None),
    (lambda r: r.update(schema="nope/v0"), "schema"),
    (lambda r: r.update(trials=2), "trials"),
    (lambda r: r["winner"].update(axes={"dp": 2}), "winner"),
    (lambda r: r["candidates"][1].update(pruned="vibes"), "pruned"),
    (lambda r: r["candidates"][1].update(trial={"examples_per_sec": 1.0,
                                                "compile_seconds": 0.0,
                                                "steady_compiles": 0, "seconds": 0.1}),
     "pruned"),
    (lambda r: r["candidates"][0]["trial"].update(steady_compiles=-1), "steady_compiles"),
    (lambda r: r.update(candidates=[]), "candidates"),
    (lambda r: r["topology"].update(n_devices=0), "n_devices"),
], ids=["accepts", "schema", "trials", "winner", "pruned", "pruned_trial",
        "steady_compiles", "candidates", "n_devices"])
def test_validate_autotune_record_matrix_equals_jax(mutate, needle):
    from fluxmpi_tpu.telemetry.schema import validate_autotune_record as jvalidate
    from fluxmpi_tpu_torch.telemetry.schema import validate_autotune_record

    rec = _minimal_record()
    if mutate is not None:
        mutate(rec)
    errors = validate_autotune_record(rec)
    assert errors == jvalidate(rec)
    if needle is None:
        assert errors == []
    else:
        assert any(needle in e for e in errors), errors


# ---------------------------------------------------------------------------
# A 4-rank gloo world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Each rank's results (a dict) in the 4-rank world."""
    tmp = tmp_path_factory.mktemp("autotune4")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.pop("FLUXMPI_TPU_PARALLEL", None)
    env.pop("FLUXMPI_TPU_AUTOTUNE_BANK", None)
    procs, logs = [], []
    for rank in range(4):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), "4", str(tmp / "store"),
             str(tmp / f"rank{rank}.json"), str(tmp)],
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
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(4))
    assert not hung, f"a rank hung past {JOIN_TIMEOUT}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]


def test_world_e2e_search_same_winner_on_every_rank(world4):
    """Real trials in a 4-rank world: at least half the candidates pruned
    statically, at most the budget (2) trialed with zero steady compiles
    and retraces, the slowest rank's rate of the global batch, the same
    table and winner on every rank, the winner installed and trained
    through ``make_train_step(parallel="auto")``."""
    first = world4[0]["e2e"]
    cands = first["record"]["candidates"]
    assert len(cands) == len(_axes(tat.enumerate_candidates(
        _tiny_lm()[0], list(range(4)), fsdp_min_size=64)))
    assert sum(bool(c["pruned"]) for c in cands) >= len(cands) / 2
    trialed = [c for c in cands if c["trial"]]
    assert 1 <= len(trialed) <= 2 == first["record"]["trials"]
    assert any(c["axes"] == {"dp": 4, "fsdp": 1, "tp": 1} for c in trialed)
    for c in trialed:
        assert c["trial"]["steady_compiles"] == 0 and c["trial"]["retraces"] == 0
        assert c["trial"]["examples_per_sec"] > 0
        # Every trial ran fused windows across the workers (width: the
        # search's window of 2), whatever its layout.
        assert c["trial"]["fused_window"] == 2, c
    # The search trials a sharded layout too, on the fused path.
    assert any(c["axes"]["fsdp"] > 1 or c["axes"]["tp"] > 1 for c in trialed)
    best = max(trialed, key=lambda c: c["trial"]["examples_per_sec"])
    assert first["record"]["winner"]["axes"] == best["axes"]
    for res in world4:
        e2e = res["e2e"]
        assert e2e["armed"] and e2e["plan_before"] is None and "autotune" in e2e["early"]
        assert e2e["installed"] and not e2e["from_bank"]
        assert e2e["record"]["winner"] == first["record"]["winner"]
        assert [c["pruned"] for c in e2e["record"]["candidates"]] == [
            c["pruned"] for c in cands]
        assert [c["trial"]["examples_per_sec"] for c in e2e["record"]["candidates"]
                if c["trial"]] == [c["trial"]["examples_per_sec"] for c in trialed]
        assert e2e["gauges"] == [len(cands), 2]
        assert e2e["auto_plan_axes"] == first["record"]["winner"]["axes"]
        assert len(e2e["losses"]) == 2 and all(np.isfinite(e2e["losses"]))
        assert e2e["losses"] == world4[0]["e2e"]["losses"]
        assert res["bank_hit"] == {"from_bank": True,
                                   "winner": first["record"]["winner"]["axes"]}
        # A trial ranks the global batch's rate: this worker's rows per
        # second times the plan's data shards.
        rate = res["trial_rate"]
        assert rate["shards"] == 4
        assert rate["global"] == round(rate["local"] * 4, 3)


def test_world_stub_pick_equals_jax_and_file_bank(world4):
    """The stub pick on every rank is the JAX package's (every candidate
    trialed); the file bank written by rank 0 answers every rank; a corrupt
    file re-tunes; 2 workers against 4 re-tune."""
    from fluxmpi_tpu.models import TransformerLM as JaxLM

    jmodel = JaxLM(**LM)
    jvars = {"params": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                                   train=False)["params"]}

    def jloss(p, ms, b):
        return jnp.mean(jmodel.apply(p, b["x"], train=False, targets=b["y"])), ms

    with _trial_as(jat, _fake_trial(_eps)):
        want = jat.autotune(jloss, optax.adamw(1e-3), jvars, _batch(),
                            devices=jax.devices()[:4], fsdp_min_size=64, window=2,
                            trial_epochs=1, trials=10, force=True)
    for res in world4:
        assert res["stub"]["winner"] == want.record["winner"]["axes"]
        assert res["stub"]["fingerprint"] == want.record["model_fingerprint"]
        assert res["file_bank"] == {"first": False, "second": True, "corrupt": False,
                                    "two": False, "two_devices": 2, "back": True}


def test_world_sidecar_manifest_and_sharded_refusal(world4):
    """Under a winner that does not shard, a checkpoint save writes
    ``<path>.autotune.json`` (valid in both packages) and the manifest's
    ``parallel.autotune_fingerprint``; under a sharding winner,
    ``train_loop(checkpoint=)`` commits sharded steps, one file per
    worker, with the sidecar, and a resume into a fresh placement of the
    winner's layout restores every block and moment bit for bit."""
    from fluxmpi_tpu.telemetry.schema import validate_autotune_record as jvalidate
    from fluxmpi_tpu_torch.telemetry.schema import validate_autotune_record

    side = world4[0]["sidecar"]
    rec = side["record"]
    assert validate_autotune_record(rec) == [] == jvalidate(rec)
    assert rec["winner"]["axes"] == {"dp": 4, "fsdp": 1, "tp": 1}
    assert side["manifest_fp"] == rec["model_fingerprint"]
    assert side["manifest_axes"] == {"dp": 4}
    srec = side["sharded_record"]
    assert validate_autotune_record(srec) == [] == jvalidate(srec)
    assert srec["winner"]["axes"]["fsdp"] > 1
    for res in world4:
        s = res["sidecar"]
        assert s["sharded_axes"].get("fsdp", 1) > 1
        last, updates = s["sharded_steps"]
        assert last == updates >= 1
        assert s["sharded_files"] == [f"shard_{r}.pt" for r in range(4)]
        assert s["sharded_layout"] == "sharded"
        assert s["sharded_resumed"] == [last, updates]
        assert s["sharded_equal"] is True


def test_world_eager_collectives_over_a_mesh_axis_equal_jax(world4):
    """``allreduce`` (sum, mean, max), ``bcast`` from member 1, ``reduce``
    to member 0 and ``iallreduce`` over ``dp`` and over ``fsdp`` of a 2x2
    mesh (each other coordinate its own result), on the device path and
    staged through host memory, against the JAX package's collectives
    over the same axis; ``allreduce_gradients`` and
    ``DistributedOptimizer`` with ``axis_name``."""
    import fluxmpi_tpu as jfm

    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "fsdp"))
    vals = np.asarray(world4[0]["coll"]["inputs"], np.float32)  # [dp, fsdp, 3]
    for axis in ("dp", "fsdp"):
        for j in range(2):
            x = vals[:, j] if axis == "dp" else vals[j, :]
            want = {
                **{f"allreduce_{op}": np.asarray(jfm.allreduce(x, op, mesh=mesh,
                                                               axis_name=axis))
                   for op in ("sum", "mean", "max")},
                "bcast": np.asarray(jfm.bcast(x, 1, mesh=mesh, axis_name=axis)),
                "reduce": np.asarray(jfm.reduce(x, "sum", 0, mesh=mesh, axis_name=axis)),
                "iallreduce": np.asarray(jfm.iallreduce(x, mesh=mesh,
                                                        axis_name=axis)[1].wait()),
            }
            for i in range(2):
                coords = (i, j) if axis == "dp" else (j, i)
                res = world4[coords[0] * 2 + coords[1]]["coll"]
                for path in ("device", "host"):
                    for name, arr in want.items():
                        np.testing.assert_allclose(res[path][axis][name], arr[i],
                                                   rtol=1e-6, err_msg=f"{path} {axis} {name}")
    for r, res in enumerate(world4):
        i, j = divmod(r, 2)
        np.testing.assert_allclose(res["coll"]["grads_fsdp"], vals[i].sum(0), rtol=1e-6)
        np.testing.assert_allclose(res["coll"]["opt_dp"], -0.1 * vals[:, j].mean(0),
                                   rtol=1e-6)
