"""One rank of ``tests/test_torch_fused_world.py``'s gloo worlds: ``python
_torch_fused_world_worker.py GROUP RANK WORLD STORE OUT DATA`` (the
arguments of ``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the
test writes: the MLP's data (``x``, ``y``) and flax weights
(``mlp/...``), the CNN's images and labels. ``GROUP`` picks the cases:

- ``views``: ``train_loop(fuse="auto")`` beside ``fuse=False`` over the
  loader's three views (a container's shard, the mesh view, ``elastic_order``)
  for the MLP and the Conv+BN CNN (``axis_name=None``: BatchNorm's
  statistics over the batch axes inside the window); ``device_epoch()``
  against ``iter()`` from every cursor; in the mesh view also the MLP's
  fused run with ``flush_every=2`` and its epoch permutations, which the
  test holds to JAX's ``train_loop(fuse="window")``;
- ``resume``: a pipelined run killed mid-window resumed fused, and a
  preemption requested on worker 0 alone drained at a window boundary;
- ``agree``: what one worker alone cannot fuse (a shard over the staging
  budget) and a ``style="shard_map"`` step are declined on every worker,
  and ``fuse="window"`` raises the reason on every worker; a dp x pp plan
  fuses on every worker, and so does the MLP under host-staged collectives
  (bit for bit with ``fuse=False``; the flushes' agreement collectives go
  through the host, ``comm.calls`` path ``"host"``).

Each rank writes its results to ``OUT`` (an npz keyed ``case/name``)."""

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

torch.set_num_threads(1)
group = sys.argv[1]
rank, world, store_path, out, data_path = (
    int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import config, faults, optim, telemetry  # noqa: E402
from fluxmpi_tpu_torch.models import CNN, MLP, load_flax_params  # noqa: E402
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_train_step, train_loop)
from fluxmpi_tpu_torch.utils import CheckpointManager  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
MLP_PARAMS = {k[len("mlp/"):]: v for k, v in D.items() if k.startswith("mlp/")}
FEATURES = (16, 16, 1)
res = {}


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value)


def loader_for(view, x, y, gbs, **kw):
    """The loader of one of the three views over the dataset ``(x, y)``."""
    ds = fm.ArrayDataset((x, y))
    kw.setdefault("shuffle", True)
    kw.setdefault("seed", 11)
    if view == "shard":
        return fm.DistributedDataLoader(fm.DistributedDataContainer(ds), gbs,
                                        device="cpu", **kw)
    if view == "mesh":
        return fm.DistributedDataLoader(ds, gbs, mesh=fm.global_mesh(), device="cpu", **kw)
    return fm.DistributedDataLoader(fm.DistributedDataContainer(ds), gbs,
                                    elastic_order=True, device="cpu", **kw)


def mlp_run():
    model = load_flax_params(MLP(features=FEATURES, device="cpu"), MLP_PARAMS)
    opt = optim.adam(1e-3)

    def loss_fn(p, ms, batch):
        x, y = batch
        return ((torch.func.functional_call(model, p, (x,)) - y) ** 2).mean(), ms

    return model, make_train_step(loss_fn, opt), TrainState.create(model, opt)


def cnn_run():
    model = CNN(4, (4, 8), in_features=1, device="cpu",
                generator=torch.Generator().manual_seed(3))
    opt = optim.adam(1e-3)

    def loss_fn(p, ms, batch):
        logits, new = torch.func.functional_call(model, p, (batch[0], ms))
        return F.cross_entropy(logits, batch[1].long()), new

    return model, make_train_step(loss_fn, opt), TrainState.create(
        model, opt, model_state=model.init_batch_stats())


def leaves(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
    out["count"] = state.opt_state["count"]
    out.update({f"stats/{k}": v for k, v in (state.model_state or {}).items()})
    return {k: v.detach().clone() for k, v in out.items()}


def flushes(summary):
    return np.array([(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                     for f in summary["flushes"]])


def fused_beside_pipelined(case, build, loader, **kw):
    """The same run fused (``fuse="auto"``) and pipelined; records whether
    every leaf and flush is bit-identical, and both summaries' counters."""
    runs = {}
    for fuse in (False, "auto"):
        _, step, state = build()
        state, summary = train_loop(step, state, loader(), fuse=fuse, **kw)
        runs[fuse] = (leaves(state), summary)
    (want, pipe), (got, fused) = runs[False], runs["auto"]
    put(case, "leaves", len(want))
    put(case, "same", sum(torch.equal(got[k], want[k]) for k in want))
    put(case, "flushes_pipelined", flushes(pipe))
    put(case, "flushes_fused", flushes(fused))
    for key in ("updates", "examples", "dispatches", "epochs"):
        put(case, f"{key}_pipelined", pipe[key])
        put(case, f"{key}_fused", fused[key])
    put(case, "fused_window", fused["fused_window"] or 0)
    put(case, "fused_window_pipelined", pipe["fused_window"] or 0)
    return got


if group == "views":
    x, y = D["x"], D["y"]
    cx, cy = D["cnn_x"], D["cnn_y"]
    for view in ("shard", "mesh", "elastic"):
        fused_beside_pipelined(f"mlp_{view}", mlp_run,
                               lambda: loader_for(view, x, y, 64), epochs=2, flush_every=2)
        fused_beside_pipelined(f"cnn_{view}", cnn_run,
                               lambda: loader_for(view, cx, cy, 16), epochs=2, flush_every=2)
    # device_epoch() against iter() at every cursor, resumed ones included:
    # the batch the window gathers at cursor c is the one iter() yields.
    for view in ("shard", "mesh", "elastic"):
        ref = [b[0].numpy() for b in loader_for(view, x, y, 64)]
        agree = 0
        for c in range(len(ref)):
            loader = loader_for(view, x, y, 64)
            loader.load_state_dict({"epoch": 0, "cursor": c, "seed": 11})
            staged, perm, start = loader.device_epoch()
            lbs = loader.local_batch_size
            agree += start == c and all(
                np.array_equal(staged[0][perm[b * lbs:(b + 1) * lbs].long()].numpy(), ref[b])
                for b in range(c, len(ref)))
        put(f"cursor_{view}", "agree", agree)
        put(f"cursor_{view}", "batches", len(ref))
    # The mesh view against JAX: its fused run and its epoch permutations.
    model, step, state = mlp_run()
    state, summary = train_loop(step, state, loader_for("mesh", x, y, 64), epochs=3,
                                flush_every=2, fuse="window")
    put("jax_mesh", "flushes", flushes(summary))
    for key in ("updates", "epochs", "examples", "dispatches", "fused_window"):
        put("jax_mesh", key, summary[key])
    for name, p in model.named_parameters():
        put("jax_mesh", f"param/{name}", p.detach().numpy())
    perms = loader_for("mesh", x, y, 64)
    put("jax_mesh", "perms", np.stack([perms.device_epoch()[1].numpy() for _ in range(3)]))

elif group == "resume":
    x, y = D["x"], D["y"]
    ck = Path(out).parent / "ckpt"
    _, step, state = mlp_run()
    state, _ = train_loop(step, state, loader_for("shard", x, y, 64), steps=8, fuse=False,
                          flush_every=4)
    want = leaves(state)
    # A pipelined run killed at its sixth fetch (step 3 banked, inside the
    # first 4-update window), resumed fused.
    _, step, state = mlp_run()
    mgr = CheckpointManager(str(ck / "kill"), async_save=False)
    try:
        with faults.scope("data.fetch@step=6"):
            train_loop(step, state, loader_for("shard", x, y, 64, prefetch=0), steps=8,
                       fuse=False, flush_every=4, checkpoint=mgr, save_every=3)
        put("kill", "raised", False)
    except fm.FaultInjectedError:
        put("kill", "raised", True)
    put("kill", "banked", mgr.latest_step())
    mgr.close()
    _, step, state = mlp_run()
    mgr = CheckpointManager(str(ck / "kill"), async_save=False)
    state, s = train_loop(step, state, loader_for("shard", x, y, 64), steps=8,
                          fuse="window", flush_every=4, checkpoint=mgr, resume=True)
    mgr.close()
    got = leaves(state)
    put("kill", "same", sum(torch.equal(got[k], want[k]) for k in want))
    put("kill", "leaves", len(want))
    for key in ("resumed_from", "updates", "dispatches", "fused_window"):
        put("kill", key, s[key])
    put("kill", "flush_updates", [f["updates"] for f in s["flushes"]])
    # A preemption that worker 0 alone requests, drained at a window
    # boundary by every worker (async saves), then resumed fused.
    _, step, state = mlp_run()
    state, _ = train_loop(step, state, loader_for("mesh", x, y, 64), epochs=2,
                          fuse="window", flush_every=2)
    want = leaves(state)
    _, step, state = mlp_run()
    mgr = CheckpointManager(str(ck / "preempt"), async_save=True)
    if rank == 0:
        fm.request_preemption()
    _, s = train_loop(step, state, loader_for("mesh", x, y, 64), epochs=2, fuse="auto",
                      flush_every=2, checkpoint=mgr)
    fm.clear_preemption()
    mgr.wait_until_finished()
    put("preempt", "preempted", s["preempted"])
    put("preempt", "updates", s["updates"])
    put("preempt", "fused_window", s["fused_window"] or 0)
    put("preempt", "banked", mgr.latest_step())
    mgr.close()
    _, step, state = mlp_run()
    mgr = CheckpointManager(str(ck / "preempt"), async_save=True)
    state, s = train_loop(step, state, loader_for("mesh", x, y, 64), epochs=2, fuse="auto",
                          flush_every=2, checkpoint=mgr, resume=True)
    mgr.close()
    got = leaves(state)
    put("preempt", "same", sum(torch.equal(got[k], want[k]) for k in want))
    put("preempt", "leaves", len(want))
    put("preempt", "resumed_updates", s["updates"])
    put("preempt", "resumed_fused_window", s["fused_window"] or 0)

elif group == "agree":
    def attempt(case, step, state, loader, **kw):
        """The run under "auto" (its fused width), then fuse="window"'s
        error on this worker."""
        _, s = train_loop(step, state, loader, fuse="auto", **kw)
        put(case, "fused_window", s["fused_window"] or 0)
        put(case, "dispatches", s["dispatches"])
        try:
            train_loop(step, state, loader, fuse="window", **kw)
            put(case, "error", "")
        except ValueError as exc:
            put(case, "error", str(exc))

    # 255 rows: worker 0's shard holds 128, worker 1's 127 (8 bytes a row).
    x, y = D["x"][:255], D["y"][:255]
    os.environ["FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES"] = str(127 * 8 + 4)
    loader = loader_for("shard", x, y, 64)
    put("budget", "fusible", loader.fusible())
    _, step, state = mlp_run()
    attempt("budget", step, state, loader, epochs=1, flush_every=3)
    del os.environ["FLUXMPI_TPU_DEVICE_GATHER_MAX_BYTES"]
    x, y = D["x"], D["y"]
    # A dp x pp plan (fused windows across workers run every plan axis):
    # its loader and step over the plan's mesh.
    plan = ParallelConfig(dp=world // 2, pp=2).resolve()
    model = load_flax_params(MLP(features=FEATURES, device="cpu"), MLP_PARAMS)
    opt = optim.adam(1e-3)
    state, _ = plan.shard_state(TrainState.create(model, opt))

    def loss_fn(p, ms, batch):
        return ((torch.func.functional_call(model, p, (batch[0],)) - batch[1]) ** 2).mean(), ms

    step = make_train_step(loss_fn, opt, parallel=plan)
    loader = fm.DistributedDataLoader(fm.ArrayDataset((x, y)), 64, mesh=plan.mesh,
                                      axis_name=plan.data_axes, device="cpu")
    attempt("plan", step, state, loader, epochs=1, flush_every=2)
    # The explicit per-worker step.
    model, _, state = mlp_run()
    step = make_train_step(lambda p, ms, b: loss_fn(p, ms, b), optim.adam(1e-3),
                           style="shard_map")
    attempt("shard_map", step, state, loader_for("mesh", x, y, 64), epochs=1, flush_every=2)
    # Host-staged collectives stage the eager collectives only: the step's
    # reductions stay on the device, so the windows fuse on every worker.
    config.DEVICE_COLLECTIVES_DISABLED = True
    _, step, state = mlp_run()
    attempt("staged", step, state, loader_for("shard", x, y, 64), epochs=1, flush_every=2)
    reg = telemetry.MetricsRegistry()
    telemetry.set_registry(reg)
    ck = Path(out).parent / "ckpt_staged"
    bits, summaries = {}, {}
    for fuse in (False, "window"):
        # A checkpoint manager makes every flush agree on a preemption
        # (an eager all-reduce over the world).
        mgr = CheckpointManager(str(ck / str(fuse)), async_save=False)
        _, step, state = mlp_run()
        state, summaries[fuse] = train_loop(step, state, loader_for("shard", x, y, 64),
                                            epochs=2, flush_every=2, fuse=fuse,
                                            checkpoint=mgr)
        mgr.close()
        bits[fuse] = leaves(state)
    put("staged", "run_fused_window", summaries["window"]["fused_window"] or 0)
    put("staged", "same", sum(torch.equal(bits["window"][k], bits[False][k])
                              for k in bits[False]))
    put("staged", "leaves", len(bits[False]))
    put("staged", "flushes_equal", np.array_equal(flushes(summaries["window"]),
                                                  flushes(summaries[False])))
    calls = {(m["labels"]["op"], m["labels"]["path"]): m["value"]
             for m in reg.snapshot() if m["name"] == "comm.calls"}
    put("staged", "paths", ",".join(sorted({path for _, path in calls})))
    put("staged", "allreduce_calls", calls.get(("allreduce", "host"), 0))
    put("staged", "flushes", len(summaries["window"]["flushes"]))
    config.DEVICE_COLLECTIVES_DISABLED = False

np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
