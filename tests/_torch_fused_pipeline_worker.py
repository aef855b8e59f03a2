"""One rank of ``tests/test_torch_fused_pipeline.py``'s gloo worlds: ``python
_torch_fused_pipeline_worker.py GROUP RANK WORLD STORE OUT DATA`` (the
arguments of ``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the
test writes: the pipeline loss's inputs, targets and head, its stacked
stage sets (``pp``: 2 stages; ``pp2``: 4 chunks over 2 stages,
``interleave=2``; ``pp4``: 4 stages) and ``cases`` (the JSON table of this
world's cases). ``GROUP`` is ``plans``: for each case,
``train_loop(fuse="auto")`` beside ``fuse=False`` (2 epochs of 4 batches
in windows of 2), the fused run's flushes and blocks, the pipeline's
exchanges per update, ``device_epoch()`` against ``iter()`` at every
cursor in the loader's three views, the step's ``across_workers``, and a
1-update window whose second call runs under a pretended capture (a
subgroup nobody warmed raises there), with the subgroups the window
program warmed; on 4 ranks a fused ``dp=2 x pp=2`` run killed inside a
window and resumed fused from its sharded checkpoint, and a made but
unwarmed pp subgroup asked for under a pretended capture.

Each rank writes its results to ``OUT`` (an npz keyed ``case/name``)."""

import json
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
from fluxmpi_tpu_torch import _collective_ops, optim  # noqa: E402
from fluxmpi_tpu_torch.data import (ArrayDataset, DistributedDataContainer,  # noqa: E402
                                    DistributedDataLoader)
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_pipeline_fn, make_train_step, train_loop)
from fluxmpi_tpu_torch.parallel import sharding as _sharding  # noqa: E402
from fluxmpi_tpu_torch.parallel.sharding import P  # noqa: E402
from fluxmpi_tpu_torch.utils import CheckpointManager  # noqa: E402
from fluxmpi_tpu_torch.utils.manifest import named_leaves  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
CASES = json.loads(str(D.pop("cases")))
LR = 0.1
GBS, WIDTH, EPOCHS, MICROBATCHES = 8, 2, 2, 4
res = {}


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value)


class Killed(Exception):
    pass


# Every call of the exchanges' point-to-point step (forward and backward).
exchanges = [0]
_send_recv = _collective_ops._send_recv


def counted_send_recv(*args):
    exchanges[0] += 1
    return _send_recv(*args)


_collective_ops._send_recv = counted_send_recv


def stage_fn(p, x):
    return torch.nn.functional.gelu(x @ p["w"] + p["b"], approximate="tanh")


def rules(spec):
    """Stage leaves over pp (and, with ``stage_axis``, their last dim over
    that axis too, so the step gathers them over it); the head
    replicated."""
    extra = spec.get("stage_axis")

    def rule(path, shape):
        if "stages" not in path:
            return P()
        tail = [None] * (len(shape) - 1)
        if extra is not None:
            tail[-1] = extra
        return P("pp", *tail)

    return rule


def loader_for(plan, view="array"):
    """The loader over the plan's mesh in one of three views: the dataset
    itself, a ``DistributedDataContainer`` (read whole in the mesh view),
    and the container under ``elastic_order=True``."""
    ds = ArrayDataset({"x": D["pp_x"], "y": D["pp_y"]})
    kw = dict(mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True, seed=11, device="cpu")
    if view == "container":
        return DistributedDataLoader(DistributedDataContainer(ds), GBS, **kw)
    if view == "elastic":
        return DistributedDataLoader(DistributedDataContainer(ds), GBS, elastic_order=True,
                                     **kw)
    return DistributedDataLoader(ds, GBS, **kw)


def build(spec, kill_at=None):
    """A fresh pipeline state placed under the case's plan, its step and
    its loader; ``kill_at``: the loss raises on that call."""
    plan = ParallelConfig(**spec["plan"], rules=rules(spec)).resolve()
    w = spec["w"]
    params = {k: torch.from_numpy(D[name]).clone().requires_grad_() for k, name in (
        ("stages.w", f"{w}_w"), ("stages.b", f"{w}_b"), ("head", "pp_head"))}
    pipe = make_pipeline_fn(stage_fn, plan.mesh, n_microbatches=MICROBATCHES,
                            axis_name="pp", interleave=spec.get("interleave", 1),
                            remat_stages=spec.get("remat", False))
    calls = [0]

    def loss_fn(p, ms, batch):
        calls[0] += 1
        if calls[0] == kill_at:
            raise Killed(calls[0])
        y = pipe({"w": p["stages.w"], "b": p["stages.b"]}, batch["x"])
        return ((y @ p["head"] - batch["y"]) ** 2).mean(), ms

    opt = optim.sgd(LR)
    state, _ = plan.shard_state(TrainState.create(params, opt))
    return plan, make_train_step(loss_fn, opt, parallel=plan), state, loader_for(plan)


def leaves(state):
    return {p: v.detach().clone() for p, v in named_leaves(state) if torch.is_tensor(v)}


def flushes(summary):
    return np.array([(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                     for f in summary["flushes"]])


def same(got, want):
    return sum(torch.equal(got[k], want[k]) for k in want)


def warmed(mesh):
    """The subgroups (neither one worker nor the world) warmed on ``mesh``."""
    return sorted(",".join(a) for a in mesh._warm if 1 < mesh.group_size(a) < mesh.size)


capturing = _sharding._capturing
if group == "plans":
    fused_leaves = {}
    for case, spec in CASES.items():
        runs = {}
        for fuse in (False, "auto"):
            plan, step, state, loader = build(spec)
            exchanges[0] = 0
            state, summary = train_loop(step, state, loader, epochs=EPOCHS,
                                        flush_every=WIDTH, fuse=fuse)
            runs[fuse] = (leaves(state), summary, step, exchanges[0])
        (want, pipe, _, _), (got, fused, step, sent) = runs[False], runs["auto"]
        fused_leaves[case] = got
        put(case, "leaves", len(want))
        put(case, "same", same(got, want))
        put(case, "across", str(step.__fluxmpi_window_meta__["across_workers"]))
        put(case, "exchanges", [runs[False][3], sent])
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
        # device_epoch() against iter() at every cursor, in each view.
        for view in ("array", "container", "elastic"):
            ref = [b["x"].numpy() for b in loader_for(plan, view)]
            agree = 0
            for c in range(len(ref)):
                loader = loader_for(plan, view)
                loader.load_state_dict({"epoch": 0, "cursor": c, "seed": 11})
                staged, perm, start = loader.device_epoch()
                lbs = loader.local_batch_size
                agree += start == c and all(
                    np.array_equal(staged["x"][perm[b * lbs:(b + 1) * lbs].long()].numpy(),
                                   ref[b]) for b in range(c, len(ref)))
            put(case, f"cursor_agree/{view}", agree)
            put(case, f"rows/{view}", np.stack(ref))
        put(case, "cursor_batches", len(ref))
        put(case, "dp_index", plan.mesh.coords(rank).get("dp", 0))
        # A 1-update window, then its second call under a pretended
        # capture: every subgroup the update asks for (the pp axis's
        # shard/unshard gathers, the stage blocks' gradient sums, the
        # stage leaves' gathers over tp or ep, the batch axes) must have
        # been warmed after the eager first window.
        plan, step, state, loader = build(spec)
        state, _ = train_loop(step, state, loader, steps=1, flush_every=1, fuse="window")
        _sharding._capturing = lambda: True
        try:
            train_loop(step, state, loader, steps=2, flush_every=1, fuse="window")
            put(case, "pretend_capture", "")
        except RuntimeError as exc:
            put(case, "pretend_capture", str(exc))
        finally:
            _sharding._capturing = capturing
        put(case, "warmed", warmed(plan.mesh))

    if world == 4:
        # A made pp subgroup nobody warmed, asked for under a pretended
        # capture.
        fresh = ParallelConfig(dp=2, pp=2).resolve().mesh
        fresh.group(("pp",))
        _sharding._capturing = lambda: True
        try:
            fresh.group(("pp",))
            put("unwarmed", "error", "")
        except RuntimeError as exc:
            put("unwarmed", "error", str(exc))
        finally:
            _sharding._capturing = capturing
        # A fused dp=2 x pp=2 run killed inside its third window (the loss
        # raises on its fifth call); every window boundary banks
        # shard_<rank>.pt. Resumed fused, it ends on the uninterrupted
        # fused run's bits.
        ck = Path(out).parent / "ckpt"
        spec = CASES["pp_dp"]
        plan, step, state, loader = build(spec, kill_at=5)
        mgr = CheckpointManager(str(ck), async_save=False)
        try:
            train_loop(step, state, loader, steps=8, flush_every=WIDTH, fuse="auto",
                       checkpoint=mgr, save_every=2)
            put("kill", "raised", False)
        except Killed:
            put("kill", "raised", True)
        put("kill", "banked", mgr.latest_step())
        mgr.close()
        put("kill", "shard_files", sorted(p.name for p in ck.rglob("shard_*.pt")))
        plan, step, state, loader = build(spec)
        mgr = CheckpointManager(str(ck), async_save=False)
        state, s = train_loop(step, state, loader, steps=8, flush_every=WIDTH,
                              fuse="window", checkpoint=mgr, resume=True)
        mgr.close()
        put("kill", "same", same(leaves(state), fused_leaves["pp_dp"]))
        put("kill", "leaves", len(fused_leaves["pp_dp"]))
        for key in ("resumed_from", "updates", "dispatches", "fused_window"):
            put("kill", key, s[key])
        put("kill", "flush_updates", [f["updates"] for f in s["flushes"]])

np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
