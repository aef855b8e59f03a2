"""One rank of ``tests/test_torch_fused_plans.py``'s gloo worlds: ``python
_torch_fused_plans_worker.py GROUP RANK WORLD STORE OUT DATA`` (the
arguments of ``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the
test writes: the dense LM's flax weights (``lmparams/...``) and its
tokens and targets. ``GROUP`` picks the cases:

- ``plans``: under each dp x fsdp x tp plan of the world (``fsdp=2`` on 2
  ranks; ``dp=2 x fsdp=2``, ``dp=2 x tp=2``, ``fsdp=2 x tp=2`` and
  ``tp=4`` on 4), ``train_loop(fuse="auto")`` beside ``fuse=False`` (3
  epochs of 4 batches in windows of 2), the fused run's flushes and
  blocks for the JAX comparison, ``device_epoch()`` against ``iter()`` at
  every cursor, the step's ``across_workers``; a 1-update window whose
  second call runs under a pretended capture, so any process group first
  asked for then raises; on the fsdp x tp plan the model stats of both
  paths; on 2 ranks a fused fsdp run killed inside a window and a
  pipelined one killed mid-window, each resumed fused from its sharded
  checkpoint;
- ``agree``: a capture that fails on worker 1 alone, agreed through the
  window program's outcome exchange; the ep, sp and pp plans'
  ``across_workers`` (None for each: every plan axis fuses).

Each rank writes its results to ``OUT`` (an npz keyed ``case/name``)."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
group = sys.argv[1]
rank, world, store_path, out, data_path = (
    int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader  # noqa: E402
from fluxmpi_tpu_torch.models import MLP, TransformerLM, load_flax_params  # noqa: E402
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_train_step, make_window_program, train_loop)
from fluxmpi_tpu_torch.parallel import sharding as _sharding  # noqa: E402
from fluxmpi_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from fluxmpi_tpu_torch.telemetry import modelstats as _modelstats  # noqa: E402
from fluxmpi_tpu_torch.utils import CheckpointManager  # noqa: E402
from fluxmpi_tpu_torch.utils.manifest import named_leaves  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=4, d_ff=32)
LR = 1e-3
GBS, WIDTH, EPOCHS = 8, 2, 3
PLANS = {2: {"fsdp": dict(fsdp=2, fsdp_min_size=64)},
         4: {"dp_fsdp": dict(dp=2, fsdp=2, fsdp_min_size=64),
             "dp_tp": dict(dp=2, tp=2),
             "fsdp_tp": dict(fsdp=2, tp=2, fsdp_min_size=64),
             "tp": dict(tp=4)}}
lm_params = {k[len("lmparams/"):]: v for k, v in D.items() if k.startswith("lmparams/")}
tokens, targets = D["tokens"], D["targets"]
res = {}


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value)


class Killed(Exception):
    pass


def build(kw, kill_at=None, model_stats=None):
    """A fresh dense LM placed under the plan, its step and its loader;
    ``kill_at``: the loss raises on that call."""
    plan = ParallelConfig(**kw).resolve()
    model = load_flax_params(TransformerLM(**LM, device="cpu"), lm_params)
    opt = optim.adamw(LR)
    state, _ = plan.shard_state(TrainState.create(model, opt))
    calls = [0]

    def loss_fn(p, ms, batch):
        calls[0] += 1
        if calls[0] == kill_at:
            raise Killed(calls[0])
        out = torch.func.functional_call(model, p, (batch["x"],), {"targets": batch["y"]})
        return out.mean(), ms

    step = make_train_step(loss_fn, opt, parallel=plan, model_stats=model_stats)
    return plan, step, state, loader_for(plan)


def loader_for(plan):
    return DistributedDataLoader(ArrayDataset({"x": tokens, "y": targets}), GBS,
                                 mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True,
                                 seed=11, device="cpu")


def leaves(state):
    return {p: v.detach().clone() for p, v in named_leaves(state)
            if torch.is_tensor(v)}


def flushes(summary):
    return np.array([(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                     for f in summary["flushes"]])


def same(got, want):
    return sum(torch.equal(got[k], want[k]) for k in want)


class Recorder(_modelstats.ModelStats):
    """The model-stats plane, keeping each flush's stats tree."""

    def __init__(self):
        super().__init__(registry=MetricsRegistry(), depth=2)
        self.seen = []

    def observe_flush(self, stats, **kw):
        self.seen.append(json.dumps(stats, sort_keys=True, default=float))
        return super().observe_flush(stats, **kw)


if group == "plans":
    for case, kw in PLANS[world].items():
        runs = {}
        for fuse in (False, "auto"):
            recorder = None
            if case == "fsdp_tp":
                recorder = Recorder()
                _modelstats.set_model_stats(recorder)
            plan, step, state, loader = build(kw, model_stats=2 if recorder else None)
            state, summary = train_loop(step, state, loader, epochs=EPOCHS,
                                        flush_every=WIDTH, fuse=fuse)
            if recorder is not None:
                _modelstats.set_model_stats(None)
                put(case, f"stats_{fuse or 'pipelined'}", recorder.seen)
            runs[fuse] = (leaves(state), summary, step)
        (want, pipe, _), (got, fused, step) = runs[False], runs["auto"]
        put(case, "leaves", len(want))
        put(case, "same", same(got, want))
        put(case, "across", str(step.__fluxmpi_window_meta__["across_workers"]))
        put(case, "flushes_pipelined", flushes(pipe))
        put(case, "flushes_fused", flushes(fused))
        for key in ("updates", "examples", "dispatches", "epochs"):
            put(case, f"{key}_pipelined", pipe[key])
            put(case, f"{key}_fused", fused[key])
        put(case, "fused_window", fused["fused_window"] or 0)
        put(case, "fused_window_pipelined", pipe["fused_window"] or 0)
        for p, v in got.items():
            if p.startswith("params/params/"):
                put(case, "param/" + p[len("params/params/"):].replace("/", "."), v.numpy())
        # device_epoch() against iter() at every cursor, resumed ones
        # included: the rows a window gathers are the ones iter() yields.
        ref = [b["x"].numpy() for b in loader_for(plan)]
        agree = 0
        for c in range(len(ref)):
            loader = loader_for(plan)
            loader.load_state_dict({"epoch": 0, "cursor": c, "seed": 11})
            staged, perm, start = loader.device_epoch()
            lbs = loader.local_batch_size
            agree += start == c and all(
                np.array_equal(staged["x"][perm[b * lbs:(b + 1) * lbs].long()].numpy(),
                               ref[b]) for b in range(c, len(ref)))
        put(case, "cursor_agree", agree)
        put(case, "cursor_batches", len(ref))
        put(case, "rows", np.stack(ref))
        # A 1-update window: the first update settles the tp blocks and the
        # second runs on them. Its second call runs under a pretended
        # capture: a process group the eager first window did not make
        # raises there.
        plan, step, state, loader = build(kw)
        state, _ = train_loop(step, state, loader, steps=1, flush_every=1, fuse="window")
        capturing = _sharding._capturing
        _sharding._capturing = lambda: True
        try:
            train_loop(step, state, loader, steps=2, flush_every=1, fuse="window")
            put(case, "pretend_capture", "")
        except RuntimeError as exc:
            put(case, "pretend_capture", str(exc))
        finally:
            _sharding._capturing = capturing
        # A new subgroup asked for under the pretended capture does raise.
        fresh = ParallelConfig(**kw).resolve().mesh
        sub = [(a,) for a, n in fresh.shape.items() if 1 < n < world]
        put(case, "new_group", "no subgroup")
        if sub:
            _sharding._capturing = lambda: True
            try:
                fresh.group(sub[0])
                put(case, "new_group", "")
            except RuntimeError as exc:
                put(case, "new_group", str(exc))
            finally:
                _sharding._capturing = capturing

    if world == 2:
        ck = Path(out).parent / "ckpt"
        kw = PLANS[2]["fsdp"]
        plan, step, state, loader = build(kw)
        state, _ = train_loop(step, state, loader, steps=8, flush_every=WIDTH, fuse="auto")
        want = leaves(state)
        # A fused run killed inside its third window (the loss raises on its
        # fifth call); every window boundary banks shard_<rank>.pt.
        for case, kill_at, fuse, every in (("kill_fused", 5, "auto", 2),
                                           ("kill_pipelined", 5, False, 3)):
            plan, step, state, loader = build(kw, kill_at=kill_at)
            mgr = CheckpointManager(str(ck / case), async_save=False)
            try:
                train_loop(step, state, loader, steps=8, flush_every=WIDTH, fuse=fuse,
                           checkpoint=mgr, save_every=every)
                put(case, "raised", False)
            except Killed:
                put(case, "raised", True)
            put(case, "banked", mgr.latest_step())
            mgr.close()
            put(case, "shard_files", sorted(
                p.name for p in (ck / case).rglob("shard_*.pt")))
            plan, step, state, loader = build(kw)
            mgr = CheckpointManager(str(ck / case), async_save=False)
            state, s = train_loop(step, state, loader, steps=8, flush_every=WIDTH,
                                  fuse="window", checkpoint=mgr, resume=True)
            mgr.close()
            put(case, "same", same(leaves(state), want))
            put(case, "leaves", len(want))
            for key in ("resumed_from", "updates", "dispatches", "fused_window"):
                put(case, key, s[key])
            put(case, "flush_updates", [f["updates"] for f in s["flushes"]])

elif group == "agree":
    # A capture that fails on worker 1 alone: every worker raises.
    plan = ParallelConfig(fsdp=2, fsdp_min_size=64).resolve()
    model = load_flax_params(TransformerLM(**LM, device="cpu"), lm_params)
    opt = optim.adamw(LR)
    state, _ = plan.shard_state(TrainState.create(model, opt))
    step = make_train_step(lambda p, ms, b: (p[next(iter(p))].sum(), ms), opt,
                           parallel=plan)
    program = make_window_program(step, width=WIDTH, lbs=GBS // 2)

    def failing(*args):
        raise RuntimeError("operation not permitted when stream is capturing")

    program._capture = failing if rank == 1 else (lambda *args: None)
    try:
        program._capture_agreed(state, None, None)
        put("capture", "error", "")
    except RuntimeError as exc:
        put("capture", "error", str(exc))
    put("capture", "graph", program.graph is None)
    # Each plan axis's across_workers: ep, sp and pp fuse.
    for case, kw in (("ep", dict(ep=2)), ("sp", dict(sp=2)), ("pp", dict(pp=2))):
        plan = ParallelConfig(**kw).resolve()
        mlp = MLP(features=(16, 16, 1), device="cpu")
        state, _ = plan.shard_state(TrainState.create(mlp, opt))
        step = make_train_step(lambda p, ms, b: (p[next(iter(p))].sum(), ms), opt,
                               parallel=plan)
        put(case, "across", str(step.__fluxmpi_window_meta__["across_workers"]))

np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
