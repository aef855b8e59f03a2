"""One-program flush windows across workers under the ``ep`` and ``sp``
plan axes (``train_loop(fuse="auto")`` in a world of several workers whose
plan runs the MoE layers' all-to-alls, the ring's point-to-point exchanges
or Ulysses' all-to-alls inside the update), in 2- and 4-rank gloo worlds of
``tests/_torch_fused_seq_ep_worker.py``, on the CPU, where a window runs
eagerly (on the cards each window is one CUDA graph per card with those
exchanges inside: ``tests/test_torch_cuda.py``).

Models: the dense ``TransformerLM`` and the ``MoETransformerLM`` of
``tests/test_torch_sequence_step.py`` (vocabulary 32, 2 layers of width 16,
2 heads, 4 experts; the MoE loss adds 0.1 x the balance loss and 0.01 x the
router z-loss, ``tests/_torch_compose.py``), sgd(0.1), 2 epochs of 4 global
batches of 8 in windows of 2. Plans: on 2 ranks the MoE LM under ``ep=2``
(top-1 and top-2), the dense LM under ``sp=2`` (the plain ring, the flash
ring through the kernels' plain versions, ``ulysses_attention_fn``), the
dense ring's dropout 0.1 under ``sp=2``, and an ``MoEMLP`` with router
noise under ``ep=2``; on 4 ranks the MoE LM under ``dp=2 x ep=2`` and
``sp=2 x ep=2``, the dense LM under ``dp=2 x sp=2`` and ``sp=2 x tp=2``.

- Per plan, on every rank, fused against ``fuse=False`` bit for bit:
  every block and count, the flushes, ``updates``, ``dispatches ==
  updates / width`` and ``fused_window == width``; the step's
  ``across_workers`` is None.
- Per plan but the two with a generator's draws, the fused run against
  the JAX package's ``train_loop(fuse="window")`` under the same
  ``ParallelConfig`` on as many CPU devices (JAX's fused path takes every
  one of these plans): per-window losses (last, mean, max) and every
  block, whose shape must equal JAX's addressable shard, within 2e-5 (the
  tolerance ``tests/test_torch_sequence_step.py`` holds these plans to);
  the loader's rows against JAX's addressable shards; ``device_epoch()``
  against ``iter()`` at every cursor. The dropout and router-noise plans
  draw from the port's generators, which JAX's keys do not reproduce:
  they are held fused against pipelined, and the dropout run must drop.
- Every subgroup a window uses is warmed once its eager first window ran:
  a 1-update window's second call, run under a pretended capture, asks
  for none that nobody warmed (the ep exchange's and the MoE layer's sp
  axis among those warmed on 4 ranks); a made but unwarmed subgroup asked
  for then raises.
- A fused ``dp=2 x ep=2`` run killed inside a window resumes fused from
  its sharded checkpoint (``shard_<rank>.pt``) to the uninterrupted run's
  bits.
- The MoE layer notes its router-noise generator for CUDA-graph windows
  (ROADMAP C.30).
"""

import json
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_compose as compose
from _torch_worlds import join_world, start_world

WORKER = Path(__file__).resolve().parent / "_torch_fused_seq_ep_worker.py"
LM = compose.LM
LR = 0.1
ATOL = 2e-5
CASES = {
    2: {"moe_ep": dict(kind="moe", plan=dict(ep=2)),
        "moe_ep_top2": dict(kind="moe", plan=dict(ep=2), moe=dict(top_k=2)),
        "lm_sp_ring": dict(kind="lm", plan=dict(sp=2)),
        "lm_sp_flash": dict(kind="lm", plan=dict(sp=2), attention="flash"),
        "lm_sp_ulysses": dict(kind="lm", plan=dict(sp=2), fn="ulysses"),
        "lm_sp_dropout": dict(kind="lm", plan=dict(sp=2), dropout=0.1),
        "moe_ep_noise": dict(kind="noise", plan=dict(ep=2))},
    4: {"moe_dp_ep": dict(kind="moe", plan=dict(dp=2, ep=2)),
        "moe_sp_ep": dict(kind="moe", plan=dict(sp=2, ep=2)),
        "lm_dp_sp": dict(kind="lm", plan=dict(dp=2, sp=2)),
        "lm_sp_tp": dict(kind="lm", plan=dict(sp=2, tp=2))},
}
ALL = [(n, c) for n in (2, 4) for c in CASES[n]]
# The subgroups each 4-rank case's update runs a collective over.
WARMED = {"moe_dp_ep": {"ep"}, "moe_sp_ep": {"ep", "sp"}, "lm_sp_tp": {"tp"}}
DRAWN = ("lm_sp_dropout", "moe_ep_noise")
WITH_JAX = [(n, c) for n, c in ALL if c not in DRAWN]


def _ids(pairs):
    return [f"{n}-{c}" for n, c in pairs]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shard(arr, device_id):
    """The addressable shard of ``arr`` on device ``device_id``."""
    (s,) = [s for s in arr.addressable_shards if s.device.id == device_id]
    return np.asarray(s.data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.models import TransformerLM as JaxLM

    rng = np.random.default_rng(0)
    lm = JaxLM(**LM).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
                          train=False)["params"]
    # Off their init (zero biases, unit scales): every gradient is live.
    lm = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32), lm)
    moe = compose.moe_weights(rng)
    d = dict(tokens=rng.integers(0, 32, (32, 16)).astype(np.int32),
             targets=rng.integers(0, 32, (32, 16)).astype(np.int32))
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"fused_seq_ep{n}") / "data.npz"
        np.savez(path, **d, **{f"lm/{k}": v for k, v in _flat(lm).items()},
                 **{f"moe/{k}": v for k, v in _flat(moe).items()},
                 cases=np.array(json.dumps(CASES[n])))
        paths[n] = path
    return dict(d, lm=lm, moe=moe, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """The ``plans`` worlds at 2 and 4 ranks, started together, JAX's
    references computed while they run: each rank's results."""
    started = {n: start_world("plans", tmp_path_factory.mktemp(f"seqep{n}"), n,
                              data["paths"][n], worker=WORKER) for n in (2, 4)}
    try:
        for n, case in WITH_JAX:
            _jax_fused(data, n, case)
    finally:
        joined = {n: join_world(*w) for n, w in started.items()}
    return joined


_JAX: dict = {}


def _jax_fused(data, n, case):
    """JAX's ``train_loop(fuse="window")`` under the case's plan on ``n``
    of its CPU devices, once per plan and model: ``(state, summary, flush
    records, loader rows)``. The dense cases that differ only in the
    port's attention path (the rings, Ulysses) share one run."""
    import fluxmpi_tpu as jfm
    from fluxmpi_tpu.models import (MoETransformerLM, TransformerLM, collect_moe_losses,
                                    expert_parallel_rules)
    from fluxmpi_tpu.parallel import ParallelConfig, TrainState, make_train_step, train_loop

    spec = CASES[n][case]
    key = (n, spec["kind"], json.dumps(spec["plan"], sort_keys=True),
           json.dumps(spec.get("moe", {}), sort_keys=True))
    if key not in _JAX:
        kw = dict(spec["plan"])
        ep = "ep" in kw
        if ep:
            kw["rules"] = expert_parallel_rules()
        plan = ParallelConfig(**kw).resolve(jax.devices()[:n])
        if spec["kind"] == "moe":
            model = MoETransformerLM(**compose.MOE, **spec.get("moe", {}),
                                     mesh=plan.mesh if ep else None)
            weights = data["moe"]

            def loss_fn(p, ms, batch):
                ce, mut = model.apply(p, batch["x"], train=True, targets=batch["y"],
                                      mutable=["losses"])
                aux, z = collect_moe_losses(mut["losses"])
                return jnp.mean(ce) + compose.AUX * aux + compose.Z * z, ms
        else:
            model = TransformerLM(**LM)
            weights = data["lm"]

            def loss_fn(p, ms, batch):
                return jnp.mean(model.apply(p, batch["x"], train=False,
                                            targets=batch["y"])), ms

        opt = optax.sgd(LR)
        state, _ = plan.shard_state(TrainState.create({"params": weights}, opt))

        def loader():
            return jfm.DistributedDataLoader(
                jfm.ArrayDataset({"x": data["tokens"], "y": data["targets"]}), 8,
                mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True, seed=11)

        records = []
        state, summary = train_loop(make_train_step(loss_fn, opt, parallel=plan), state,
                                    loader(), epochs=2, flush_every=2, fuse="window",
                                    metrics=records.append)
        _JAX[key] = (state, summary, records, [b["x"] for b in loader()])
    return _JAX[key]


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_fused_plan_bit_identical_to_pipelined(worlds, n, case):
    """Under the plan ``fuse="auto"`` engages a 2-update window on every
    rank (4 batches an epoch, 2 epochs: 4 dispatches against 8) and ends
    on the pipelined run's bits."""
    for res in worlds[n]:
        assert str(res[f"{case}/across"]) == "None"
        assert int(res[f"{case}/same"]) == int(res[f"{case}/leaves"]) > 5, case
        np.testing.assert_array_equal(res[f"{case}/flushes_fused"],
                                      res[f"{case}/flushes_pipelined"], err_msg=case)
        for key in ("updates", "examples", "epochs"):
            assert res[f"{case}/{key}_fused"] == res[f"{case}/{key}_pipelined"], key
        assert int(res[f"{case}/fused_window"]) == 2
        assert int(res[f"{case}/fused_window_pipelined"]) == 0
        assert int(res[f"{case}/updates_fused"]) == 8
        assert int(res[f"{case}/dispatches_fused"]) == 8 // 2
        assert int(res[f"{case}/dispatches_pipelined"]) == 8


@pytest.mark.parametrize("n,case", WITH_JAX, ids=_ids(WITH_JAX))
def test_fused_plan_matches_jax_fused_window(world, worlds, data, n, case):
    """The port's fused run on every rank against JAX's
    ``train_loop(fuse="window")`` under the same plan: counters,
    per-window losses, every block (shape and values) on its mesh
    coordinate, and the loader's rows."""
    jstate, jsum, records, rows = _jax_fused(data, n, case)
    assert jsum["fused_window"] == 2  # JAX fuses the plan too
    want = _flat(jstate.params["params"])
    for r, res in enumerate(worlds[n]):
        for key in ("updates", "epochs", "dispatches"):
            assert int(res[f"{case}/{key}_fused"]) == jsum[key], key
        flushes = res[f"{case}/flushes_fused"]
        assert len(flushes) == len(records) == 4
        for f, rec in zip(flushes, records):
            np.testing.assert_allclose(f[1], rec["loss"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[2], rec["loss_window_mean"], atol=ATOL, rtol=0)
            np.testing.assert_allclose(f[3], rec["loss_window_max"], atol=ATOL, rtol=0)
        for name, arr in want.items():
            got = res[f"{case}/param/{name.replace('/', '.')}"]
            ref = _shard(arr, r)
            assert got.shape == ref.shape, (r, name, got.shape, ref.shape)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{r} {name}")
        for b, batch in enumerate(rows):
            np.testing.assert_array_equal(res[f"{case}/rows"][b], _shard(batch, r))


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_device_epoch_follows_iteration_under_the_plan(worlds, n, case):
    """Workers sharing a data block (ep and sp peers) read the same rows in
    a window as ``iter()`` yields them, from every cursor."""
    ranks = worlds[n]
    for res in ranks:
        assert int(res[f"{case}/cursor_batches"]) == 4
        assert int(res[f"{case}/cursor_agree"]) == 4
    if "dp" not in CASES[n][case]["plan"]:  # one data block: every rank's rows alike
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[f"{case}/rows"], ranks[0][f"{case}/rows"])


@pytest.mark.parametrize("n,case", ALL, ids=_ids(ALL))
def test_window_groups_warmed_before_the_capture(worlds, n, case):
    """After a program's eager first window, a window run under a
    pretended capture asks for no subgroup that was not warmed. On 4 ranks
    the subgroups warmed include the MoE layers' ep exchange, the sp axis
    the MoE layer gathers its group's router probabilities over, and the
    tp axis; the ring's exchanges run point to point over the world's
    communicator, so dp x sp warms no sp subgroup. On 2 ranks every group
    is the world's."""
    for res in worlds[n]:
        assert str(res[f"{case}/pretend_capture"]) == "", res[f"{case}/pretend_capture"]
        warmed = set(res[f"{case}/warmed"].tolist())
        assert WARMED.get(case, set()) <= warmed, (case, warmed)
        if n == 2:
            assert warmed == set()


def test_unwarmed_subgroup_refused_under_capture(worlds):
    for res in worlds[4]:
        err = str(res["unwarmed/error"])
        assert "mesh axes ('ep',)" in err and "no window program warmed it" in err, err


def test_dense_dropout_draws_under_sp(worlds):
    """The dense ring's dropout under ``sp=2`` drops: its first window's
    loss differs from the same run's without dropout."""
    res = worlds[2][0]
    assert abs(float(res["lm_sp_dropout/flushes_fused"][0][1])
               - float(res["lm_sp_ring/flushes_fused"][0][1])) > 1e-4


def test_fused_dp_ep_resume_from_sharded_checkpoints(worlds):
    for res in worlds[4]:
        # Killed on the fifth update, inside the third window: the second
        # window's boundary (update 4) is banked, one shard file a worker.
        assert bool(res["kill/raised"]) and int(res["kill/banked"]) == 4
        assert set(res["kill/shard_files"]) == {f"shard_{r}.pt" for r in range(4)}
        assert (int(res["kill/resumed_from"]), int(res["kill/updates"]),
                int(res["kill/fused_window"]), int(res["kill/dispatches"])) == (4, 8, 2, 2)
        assert list(res["kill/flush_updates"]) == [6, 8]
        assert int(res["kill/same"]) == int(res["kill/leaves"])


def test_moe_router_noise_notes_its_generator(monkeypatch):
    """C.30: the MoE layer's router noise draws from the generator the
    caller passes; the layer notes it (``runtime.note_graph_generator``),
    so a captured window registers it and every replay draws afresh (an
    unnoted CUDA generator drawn from under capture fails the capture)."""
    from fluxmpi_tpu_torch import runtime
    from fluxmpi_tpu_torch.models import MoEMLP

    noted = []
    monkeypatch.setattr(runtime, "note_graph_generator", noted.append)
    layer = MoEMLP(num_experts=4, d_ff=8, d_model=8, router_noise=0.1, device="cpu")
    rng = torch.Generator().manual_seed(0)
    layer(torch.ones(2, 4, 8), train=True, rng=rng)
    assert noted and all(g is rng for g in noted)
