"""The port's checkpoints: the commit protocol, the manager and the
manifest, on the CPU.

Checked: a save and restore round-trips every leaf bit for bit (f32 and
bf16 tensors, int counters, an optimizer's state) and refuses another
structure or shape; the manifest passes the JAX package's
``validate_manifest`` and names the same leaf paths, shapes and dtypes as
the JAX package's manifest of the same ``TrainState`` payload converted to
JAX; a fault at ``ckpt.write``, ``ckpt.manifest`` or ``ckpt.commit`` leaves
the previous committed step the latest, and a new manager quarantines the
partial; write retries; keep-k retention and the local tier's promotion;
async coalescing (``superseded``), a failed background write raised on
the next call, and an async save whose state the next updates change in
place restoring the bytes of the saved step; and, in a two-rank gloo
world (``FileStore`` under the test's temporary directory, one thread per
rank), the lead rank writes, a step disagreement raises
``CheckpointDesyncError`` on both ranks, and after a restore rank 1 holds
rank 0's state, and ``train_loop`` saves from the lead and resumes on
both ranks."""

import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.telemetry.schema import validate_manifest as jax_validate_manifest
from fluxmpi_tpu.utils import manifest as jax_manifest
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.models import MLP
from fluxmpi_tpu_torch.parallel import TrainState
from fluxmpi_tpu_torch.utils import (CheckpointManager, build_manifest,
                                     read_manifest, restore_checkpoint,
                                     save_checkpoint)
from fluxmpi_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 180


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


def _state(seed=0, updates=1):
    """An MLP's TrainState after ``updates`` adamw updates."""
    model = MLP(features=(8, 1), device="cpu",
                generator=torch.Generator().manual_seed(seed))
    opt = optim.adamw(1e-2)
    state = TrainState.create(model, opt)
    x = torch.linspace(-1, 1, 16)[:, None]
    for _ in range(updates):
        loss = ((model(x) - x ** 2) ** 2).mean()
        grads = dict(zip(state.params, torch.autograd.grad(
            loss, list(state.params.values()))))
        upd, state.opt_state = opt.update(grads, state.opt_state, state.params)
        optim.apply_updates(state.params, upd)
        state.step += 1
    return model, state


def _payload(state, updates=1):
    return {
        "state": state,
        "loop": {k: torch.tensor(v, dtype=torch.int64)
                 for k, v in (("updates", updates), ("examples", 32 * updates),
                              ("epochs", 0))},
        "loader": {k: torch.tensor(v, dtype=torch.int64)
                   for k, v in (("epoch", 0), ("cursor", updates), ("seed", 7),
                                ("process_count", 1), ("global_batch_size", 32),
                                ("num_batches", 4), ("elastic_order", 0))},
        "extra": {"bf16": torch.randn(3, 5).to(torch.bfloat16), "count": 7},
    }


def _zeros_like(tree):
    """The same structure with every tensor zeroed and every int 0."""
    from fluxmpi_tpu_torch.utils.manifest import map_with_path

    return map_with_path(lambda p, x: torch.zeros_like(x) if torch.is_tensor(x)
                         else 0 if isinstance(x, int) else x, tree)


def _leaves(tree):
    from fluxmpi_tpu_torch.utils.manifest import leaf_tensor, named_leaves

    return {p: leaf_tensor(x) for p, x in named_leaves(tree)
            if leaf_tensor(x) is not None}


def test_round_trip_is_bit_for_bit_and_refuses_other_structures(tmp_path):
    _, state = _state(updates=2)
    payload = _payload(state, updates=2)
    path = str(tmp_path / "ck")
    save_checkpoint(path, payload, step=2)
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.fluxmpi_layout",
                                            "ck.manifest.json"]
    like = _zeros_like(payload)
    out = restore_checkpoint(path, like)
    want, got = _leaves(payload), _leaves(out)
    assert set(got) == set(want) and len(want) > 10
    for p in want:
        assert got[p].dtype == want[p].dtype, p
        assert torch.equal(got[p], want[p]), p
    assert out["state"].step == 2 and isinstance(out["state"].step, int)
    assert out["state"].opt_state["count"] == 2
    assert out["extra"]["bf16"].dtype == torch.bfloat16
    assert all(torch.count_nonzero(t) == 0 for t in _leaves(like).values()
               if t.is_floating_point())  # the template is not written into
    with pytest.raises(FileExistsError):
        save_checkpoint(path, payload, force=False)
    bad = _zeros_like(payload)
    bad["state"].params["dense_0.kernel"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="dense_0/kernel"):
        restore_checkpoint(path, bad)
    other = _zeros_like(payload)
    other["extra"]["missing"] = torch.zeros(1)
    with pytest.raises(ValueError, match="extra/missing"):
        restore_checkpoint(path, other)


def _to_jax_payload(payload):
    """The same payload as the JAX package holds it: the flax params tree,
    optax's adamw state, int32 step and count, numpy leaves."""
    st = payload["state"]

    def nest(flat):
        out = {}
        for name, t in flat.items():
            node = out
            *head, last = name.split(".")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = t.detach().numpy()
        return {"params": out}

    params = nest(st.params)
    opt = optax.adamw(1e-2).init(params)
    adam = opt[0]._replace(count=np.int32(st.opt_state["count"]),
                           mu=nest(st.opt_state["mu"]),
                           nu=nest(st.opt_state["nu"]))
    jstate = JaxTrainState(step=np.int32(st.step), params=params,
                           opt_state=(adam,) + tuple(opt[1:]), model_state=None)
    return {"state": jstate,
            "loop": {k: v.numpy() for k, v in payload["loop"].items()},
            "loader": {k: v.numpy() for k, v in payload["loader"].items()}}


def test_manifest_is_valid_for_the_jax_validator_and_names_jax_leaves(
        world, tmp_path):
    _, state = _state()
    payload = _payload(state)
    del payload["extra"]
    path = str(tmp_path / "ck")
    save_checkpoint(path, payload, step=1)
    man = read_manifest(path)
    assert man is not None and jax_validate_manifest(man) == []
    with open(path + ".manifest.json") as f:
        assert jax_validate_manifest(json.load(f)) == []
    assert man["step"] == 1 and man["process_count"] == 1
    assert man["counters"] == {"updates": 1, "examples": 32, "epochs": 0}
    assert man["loader"]["cursor"] == 1 and man["loader"]["num_batches"] == 4
    jman = jax_manifest.build_manifest(_to_jax_payload(payload),
                                       layout="replicated", step=1)
    assert jax_validate_manifest(jman) == []

    def leaves(m):
        return {(x["path"], tuple(x["shape"]), x["dtype"]) for x in m["leaves"]}

    assert leaves(man) == leaves(jman)
    assert ("state/opt_state/0/mu/params/dense_0/kernel", (1, 8), "float32") \
        in leaves(man)
    assert all(x["spec"] is None for x in man["leaves"])
    assert man["counters"] == jman["counters"] and man["loader"] == jman["loader"]
    # build_manifest alone gives the same record (bar the clock and step).
    assert leaves(build_manifest(payload)) == leaves(man)


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.manifest", "ckpt.commit"])
def test_commit_protocol_fault_keeps_the_previous_step(tmp_path, monkeypatch, site):
    monkeypatch.setattr(ckpt, "_retry_sleep", lambda s: None)
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    mgr.save(2, _payload(state))
    times = 4 if site == "ckpt.write" else 1  # past the three retries
    with faults.scope(f"{site}@step=1:times={times}"):
        with pytest.raises(tfm.FaultInjectedError):
            mgr.save(4, _payload(state, updates=4))
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
    with pytest.warns(UserWarning, match="quarantined") if site != "ckpt.write" \
            else contextlib.nullcontext():
        fresh = CheckpointManager(str(tmp_path / "run"), async_save=False)
    if site == "ckpt.write":
        assert fresh.quarantined == []  # the failed staging dir is removed
    else:
        assert fresh.quarantined == ["step_00000004"]
        assert os.path.isdir(tmp_path / "run" / "_quarantine" / "step_00000004")
    step, restored = fresh.restore(_payload(_zeros_like(state)))
    assert step == 2 and restored["loop"]["updates"] == 1


def test_write_retries_then_succeeds(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(ckpt, "_retry_sleep", slept.append)
    _, state = _state()
    with faults.scope("ckpt.write@step=1:times=2"):
        with pytest.warns(UserWarning, match="retrying"):
            save_checkpoint(str(tmp_path / "ck"), _payload(state))
        assert faults.injected_count() == 2
    assert slept == [0.1, 0.2]
    assert ckpt._read_layout_marker(str(tmp_path / "ck")) == "replicated"


def test_keep_k_retention_and_local_tier_promotion(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "durable"), max_to_keep=2,
                            local_dir=str(tmp_path / "local"),
                            local_max_to_keep=1, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _payload(state, updates=s))
    assert mgr._steps_in(mgr.directory) == [3, 4]
    assert mgr._steps_in(mgr.local_dir) == [4]
    assert mgr.all_steps() == [3, 4]
    assert mgr.tier_of(4) == "local" and mgr.tier_of(3) == "durable"
    assert mgr.tier_of(1) is None
    assert read_manifest(mgr._step_path(4))["step"] == 4  # promoted with it
    step, out = mgr.restore(_payload(_zeros_like(state)), step=3)
    assert step == 3 and int(out["loop"]["updates"]) == 3
    assert len(mgr.write_seconds) == 4


def test_async_coalescing_and_a_failed_background_write(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=None)
    with faults.scope("ckpt.async_write@step=1:delay=0.5"):
        for s in (1, 2, 3, 4):
            mgr.save(s, _payload(state, updates=s))
        mgr.wait_until_finished()
    # 1 was in flight; 2 was queued and then replaced by 3, 3 by 4.
    assert mgr.superseded == 2 and mgr.all_steps() == [1, 4]
    with faults.scope("ckpt.async_write@step=1"):
        mgr.save(5, _payload(state, updates=5))
        with pytest.raises(tfm.FaultInjectedError):
            mgr.wait_until_finished()
    assert mgr.latest_step() == 4
    mgr.save(6, _payload(state, updates=6))  # the error was raised once
    mgr.close()
    assert mgr.latest_step() == 6


def test_async_save_keeps_the_saved_steps_bytes(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "run"))
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    with faults.scope("ckpt.async_write@step=1:delay=0.3"):
        mgr.save(1, _payload(state))
        with torch.no_grad():  # the next updates change the tensors in place
            for p in state.params.values():
                p.add_(1.0)
        mgr.wait_until_finished()
    _, out = mgr.restore(_payload(_zeros_like(state)))
    for k in saved:
        assert torch.equal(out["state"].params[k], saved[k]), k
        assert not torch.equal(state.params[k], saved[k]), k
    mgr.close()


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store_path, ckdir, out = (int(sys.argv[1]), int(sys.argv[2]),
                                           sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState
    from fluxmpi_tpu_torch.utils import CheckpointManager

    fm.init(device="cpu")
    res = {}
    model = MLP(features=(8, 1), device="cpu",
                generator=torch.Generator().manual_seed(100 + rank))
    opt = optim.adam(1e-2)
    state = TrainState.create(model, opt)
    state.step = 10 + rank
    mgr = CheckpointManager(ckdir, async_save=True)
    mgr.save(5, {"state": state})
    mgr.wait_until_finished()
    res["writes"] = len(mgr.write_seconds)
    try:
        mgr.save(6 + rank, {"state": state})
        res["desync_raised"] = False
    except fm.CheckpointDesyncError:
        res["desync_raised"] = True
    fm.barrier()
    res["latest"] = mgr.latest_step()
    other = MLP(features=(8, 1), device="cpu",
                generator=torch.Generator().manual_seed(7))
    like = {"state": TrainState.create(other, opt)}
    step, restored = mgr.restore(like)
    res["step"] = step
    res["restored_step"] = restored["state"].step
    for name, t in restored["state"].params.items():
        res["restored/" + name] = t.numpy()
    for name, p in model.named_parameters():
        res["own/" + name] = p.detach().numpy()

    # train_loop's saves and resume across the two ranks.
    from fluxmpi_tpu_torch.parallel import make_train_step, train_loop

    X = np.random.default_rng(0).uniform(-2, 2, (64, 1)).astype(np.float32)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((X, X ** 2))),
        global_batch_size=16, device="cpu")

    def run(**kw):
        m = MLP(features=(8, 1), device="cpu", generator=torch.Generator().manual_seed(3))
        loss = lambda p, ms, b: (((m(b[0]) - b[1]) ** 2).mean(), ms)
        st = TrainState.create(m, opt)
        return train_loop(make_train_step(loss, opt), st, loader, flush_every=2, **kw)

    loop_mgr = CheckpointManager(ckdir + "_loop", async_save=False)
    run(steps=4, checkpoint=loop_mgr, save_every=2)
    st, summary = run(steps=6, checkpoint=loop_mgr, save_every=2, resume=True)
    res["loop_resumed_from"] = summary["resumed_from"]
    res["loop_updates"] = summary["updates"]
    res["loop_steps"] = np.array(loop_mgr.all_steps())
    np.savez(out, **res)
    mgr.close()
    fm.shutdown()
    dist.destroy_process_group()
''')


def test_two_rank_world_lead_writes_steps_agree_and_root_wins(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(2):
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), "2",
             str(tmp_path / "store"), str(tmp_path / "ck"),
             str(tmp_path / f"out{rank}.npz")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
    finally:
        for log in logs:
            log.close()
    text = "\n".join((tmp_path / f"rank{r}.log").read_text() for r in range(2))
    assert [p.returncode for p in procs] == [0, 0], text
    r0 = dict(np.load(tmp_path / "out0.npz"))
    r1 = dict(np.load(tmp_path / "out1.npz"))
    assert int(r0["writes"]) == 1 and int(r1["writes"]) == 0  # the lead writes
    assert bool(r0["desync_raised"]) and bool(r1["desync_raised"])
    assert int(r0["latest"]) == int(r1["latest"]) == 5  # nothing mixed banked
    assert int(r0["step"]) == int(r1["step"]) == 5
    assert int(r0["restored_step"]) == int(r1["restored_step"]) == 10
    names = [k for k in r0 if k.startswith("own/")]
    for k in names:
        name = k[len("own/"):]
        np.testing.assert_array_equal(r1["restored/" + name], r0["own/" + name])
        np.testing.assert_array_equal(r0["restored/" + name], r0["own/" + name])
    assert any(not np.array_equal(r0[k], r1[k]) for k in names)  # they differed
    for r in (r0, r1):
        assert int(r["loop_resumed_from"]) == 4 and int(r["loop_updates"]) == 6
        assert list(r["loop_steps"]) == [2, 4, 6]
