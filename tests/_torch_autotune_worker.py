"""One rank of the autotuner tests' 4-rank gloo world (run by
``tests/test_torch_autotune.py``): ``python _torch_autotune_worker.py RANK
WORLD STORE OUT TMP``. Runs the eager collectives over a 2x2 mesh, then
the layout autotuner under ``init(parallel="auto")`` (real trials, the
bank, a stubbed pick, the file bank, a topology change, the checkpoint
sidecar, and a sharded save and its restore under a winner that shards),
and writes this rank's results to
``OUT`` (JSON)."""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store_path, out, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                        world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
import fluxmpi_tpu_torch.parallel.autotune  # noqa: E402,F401
from fluxmpi_tpu_torch import config, optim, telemetry  # noqa: E402
from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader  # noqa: E402
from fluxmpi_tpu_torch.models import TransformerLM  # noqa: E402
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_train_step, train_loop)
from fluxmpi_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from fluxmpi_tpu_torch.utils import manifest  # noqa: E402
from fluxmpi_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint  # noqa: E402

at = sys.modules["fluxmpi_tpu_torch.parallel.autotune"]
LM = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64)
res = {}

# -- The eager collectives over each axis of a 2x2 (dp, fsdp) mesh, on the
# device path and staged through host memory.
fm.init(device="cpu", parallel=ParallelConfig(dp=2, fsdp=2, fsdp_min_size=1))
mesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "fsdp"))
vals = (np.arange(24, dtype=np.float32).reshape(2, 2, 3, 2)[..., 0] / 4
        - (np.arange(12) % 5).reshape(2, 2, 3))
i, j = divmod(rank, 2)
x = torch.from_numpy(np.ascontiguousarray(vals[i, j]))
coll = {"inputs": vals.tolist()}
for path in ("device", "host"):
    config.DEVICE_COLLECTIVES_DISABLED = path == "host"
    by_axis = {}
    for axis in ("dp", "fsdp"):
        r = {f"allreduce_{op}": fm.allreduce(x, op, mesh=mesh, axis_name=axis).tolist()
             for op in ("sum", "mean", "max")}
        r["bcast"] = fm.bcast(x, 1, mesh=mesh, axis_name=axis).tolist()
        r["reduce"] = fm.reduce(x, "sum", 0, mesh=mesh, axis_name=axis).tolist()
        _, req = fm.iallreduce(x, mesh=mesh, axis_name=axis)
        r["iallreduce"] = req.wait().tolist()
        by_axis[axis] = r
    coll[path] = by_axis
config.DEVICE_COLLECTIVES_DISABLED = False
coll["grads_fsdp"] = fm.allreduce_gradients({"g": x}, axis_name="fsdp")["g"].tolist()
dopt = fm.DistributedOptimizer(optim.sgd(0.1), axis_name="dp", reduce_op="mean")
upd, _ = dopt.update({"g": x.clone()}, dopt.init({"g": x}), {"g": x})
coll["opt_dp"] = upd["g"].tolist()
res["coll"] = coll
fm.shutdown()

# -- The autotuner under init(parallel="auto").
reg = telemetry.MetricsRegistry()
telemetry.set_registry(reg)
fm.init(device="cpu", parallel="auto", compileplane=True)
model = TransformerLM(**LM, device="cpu")  # the same seeded weights on every rank


def loss_fn(p, ms, b):
    out = torch.func.functional_call(model, p, (b["x"],), {"targets": b["y"]})
    return out.mean(), ms


rng = np.random.default_rng(1)
batch = {"x": rng.integers(0, 64, (16, 8)).astype(np.int64),
         "y": rng.integers(0, 64, (16, 8)).astype(np.int64)}
KW = dict(fsdp_min_size=64, window=2, trial_epochs=1, seed=0)
e2e = {"armed": fm.runtime.auto_parallel(),
       "plan_before": None if fm.global_plan() is None else str(fm.global_plan().sizes)}
try:
    make_train_step(loss_fn, optim.adamw(1e-3), parallel="auto")
    e2e["early"] = ""
except ValueError as exc:
    e2e["early"] = str(exc)
at.clear_bank()
r = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, trials=2, **KW)
e2e.update(record=r.record, from_bank=r.from_bank, installed=fm.global_plan() is r.plan,
           gauges=[reg.gauge("autotune.candidates_total").value,
                   reg.gauge("autotune.trials").value])


def fresh_state(plan, opt):
    state = TrainState.create({k: v.detach().clone().requires_grad_()
                               for k, v in model.named_parameters()}, opt)
    if plan.shards_parameters:
        state, _ = plan.shard_state(state)
    return state


def loader_for(plan, data):
    axes = plan.data_axes
    return DistributedDataLoader(ArrayDataset(data), 16, mesh=plan.mesh, device="cpu",
                                 axis_name=axes[0] if len(axes) == 1 else list(axes))


plan = fm.global_plan()
opt = optim.adamw(1e-3)
state = fresh_state(plan, opt)
step = make_train_step(loss_fn, opt, parallel="auto")
e2e["auto_plan_axes"] = {a: plan.sizes.get(a, 1) for a in ("dp", "fsdp", "tp")}
losses = []
for _, b in zip(range(2), loader_for(plan, {k: np.concatenate([v, v]) for k, v in
                                           batch.items()})):
    state, loss = step(state, b)
    losses.append(float(loss))
e2e["losses"] = losses
res["e2e"] = e2e

real_trial = at._run_trial

# A trial's rate is the global batch's: this worker's rows per second
# (what the loop counts) times the plan's data shards.
from fluxmpi_tpu_torch.parallel import loop as _loop  # noqa: E402

summaries = []
_train_loop = _loop.train_loop


def _recording_loop(*a, **k):
    out = _train_loop(*a, **k)
    summaries.append(out[1])
    return out


_loop.train_loop = _recording_loop
pure_dp = ParallelConfig(dp=4, fsdp_min_size=64).resolve()
trial = real_trial(loss_fn, optim.adamw(1e-3), model, None, batch, pure_dp, window=2,
                   epochs=1, seed=0)
_loop.train_loop = _train_loop
res["trial_rate"] = {"global": trial["examples_per_sec"],
                     "local": summaries[-1]["examples_per_sec"],
                     "shards": pure_dp.data_parallel_size}


def boom(*a, **k):
    raise AssertionError("a trial ran on a bank hit")


at._run_trial = boom
r2 = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, trials=2, **KW)
res["bank_hit"] = {"from_bank": r2.from_bank, "winner": r2.record["winner"]["axes"]}


def fake(eps):
    def trial(loss_fn, optimizer, host_params, model_state, sample_batch, plan, *,
              window, epochs, seed):
        axes = {a: plan.sizes.get(a, 1) for a in ("dp", "fsdp", "tp")}
        return {"examples_per_sec": float(eps(axes)), "updates": window * epochs,
                "compile_seconds": 0.01, "steady_compiles": 0, "retraces": 0,
                "seconds": 0.02}

    return trial


# -- The deterministic pick under a stub, every candidate trialed.
at._run_trial = fake(lambda a: 100.0 * a["fsdp"] + 10.0 * a["tp"] + a["dp"])
r = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, trials=10, force=True, **KW)
res["stub"] = {"winner": r.record["winner"]["axes"],
               "fingerprint": r.record["model_fingerprint"]}

# -- The file bank through rank 0, a corrupt file, a topology change.
bank = os.path.join(tmp, "bank.json")
at.clear_bank()
at._run_trial = fake(lambda a: float(a["dp"]))
fb = {"first": at.autotune(loss_fn, optim.adamw(1e-3), model, batch, bank=bank,
                           **KW).from_bank}
at.clear_bank()
at._run_trial = boom
fb["second"] = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, bank=bank,
                           **KW).from_bank
at.clear_bank()
if rank == 0:
    with open(bank, "w") as f:
        f.write("{not json")
dist.barrier()
at._run_trial = fake(lambda a: float(a["dp"]))
fb["corrupt"] = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, bank=bank,
                            devices=[0, 1, 2, 3], **KW).from_bank
two = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, bank=bank, devices=[0, 1],
                  **KW)
fb.update(two=two.from_bank, two_devices=two.record["topology"]["n_devices"])
at._run_trial = boom
fb["back"] = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, bank=bank,
                         devices=[0, 1, 2, 3], **KW).from_bank
res["file_bank"] = fb

# -- The checkpoint sidecar and the manifest under a winner that does not
# shard; a sharded save, its sidecar and its restore under one that does.
at._run_trial = fake(lambda a: float(a["dp"]))
r = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, force=True, **KW)
ckpt = os.path.join(tmp, "ckpt")
save_checkpoint(ckpt, fresh_state(fm.global_plan(), opt))
dist.barrier()
side = {}
if rank == 0:
    with open(ckpt + ".autotune.json") as f:
        side["record"] = json.load(f)
    man = manifest.read_manifest(ckpt)
    side["manifest_fp"] = man["parallel"]["autotune_fingerprint"]
    side["manifest_axes"] = man["parallel"]["axes"]
at._run_trial = fake(lambda a: 100.0 * a["fsdp"])
r = at.autotune(loss_fn, optim.adamw(1e-3), model, batch, force=True, **KW)
plan = fm.global_plan()
state = fresh_state(plan, opt)
step = make_train_step(loss_fn, opt, parallel="auto")
sharded = os.path.join(tmp, "sharded")
mgr = CheckpointManager(sharded)
state, summary = train_loop(step, state, loader_for(plan, batch), epochs=1,
                            flush_every=1, checkpoint=mgr, save_every=1)
last = mgr.latest_step()
side["sharded_axes"] = plan.sizes
side["sharded_steps"] = [last, summary["updates"]]
side["sharded_files"] = sorted(os.listdir(os.path.join(sharded, f"step_{last:08d}")))
side["sharded_layout"] = manifest.read_manifest(os.path.join(sharded, f"step_{last:08d}"))["layout"]
if rank == 0:
    with open(os.path.join(sharded, f"step_{last:08d}.autotune.json")) as f:
        side["sharded_record"] = json.load(f)
# The restore into a fresh placement of the winner's layout.
back, again = train_loop(step, fresh_state(plan, opt), loader_for(plan, batch), epochs=1,
                         flush_every=1, checkpoint=CheckpointManager(sharded), resume=True)
side["sharded_resumed"] = [again["resumed_from"], again["updates"]]
side["sharded_equal"] = all(torch.equal(back.params[k], state.params[k])
                            for k in state.params) and all(
    torch.equal(back.opt_state[m][k], state.opt_state[m][k])
    for m in ("mu", "nu") for k in state.params)
res["sidecar"] = side
at._run_trial = real_trial
at.clear_bank()

with open(out, "w") as f:
    json.dump(res, f)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
