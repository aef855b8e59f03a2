"""One rank of the elastic tests' gloo worlds (run by
``tests/test_torch_elastic.py``): ``python _torch_elastic_worker.py RANK WORLD
STORE OUT TMP PHASE``. Reads the weights and the dataset from
``TMP/inputs.npz`` (written by the test), runs its phase's cases and writes
this rank's results to ``OUT`` (a JSON file; the restored blocks go to
``OUT.npz``, keyed ``case/leaf path``). The phases run in order, each a new
world over the same ``TMP``:

- ``w2a`` (2 ranks): the sharded manifests and checkpoints under
  ``fsdp_rule`` and the tp table, the peer-failure abort, the moments
  of a state created from placed parameters, the
  ``elastic_order`` batches and its validation errors;
- ``w4`` (4 ranks): the same manifests and checkpoints, the restores 2→4
  and replicated→sharded, the ``elastic_order`` batches, and the first
  half of a live resize 4→2 of a tiny MLP (a request on rank 0 drains the
  world at a flush boundary);
- ``w2b`` (2 ranks): the restores 4→2 (banked specs, and a rule), and the
  second half of the resize (the resume finishes the epoch)."""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store_path, out, tmp, phase = (int(sys.argv[1]), int(sys.argv[2]),
                                            sys.argv[3], sys.argv[4], sys.argv[5],
                                            sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                        world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import faults, optim  # noqa: E402
from fluxmpi_tpu_torch.data import (ArrayDataset, DistributedDataContainer,  # noqa: E402
                                    DistributedDataLoader)
from fluxmpi_tpu_torch.fleet import resize  # noqa: E402
from fluxmpi_tpu_torch.models import MLP  # noqa: E402
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop  # noqa: E402
from fluxmpi_tpu_torch.parallel.sharding import (Mesh, fsdp_rule, shard_tree,  # noqa: E402
                                                 sharding_of, transformer_tp_rules)
from fluxmpi_tpu_torch.utils import manifest  # noqa: E402
from fluxmpi_tpu_torch.utils.checkpoint import (CheckpointManager,  # noqa: E402
                                                restore_checkpoint, save_checkpoint)

fm.init(device="cpu")
D = dict(np.load(os.path.join(tmp, "inputs.npz")))
res: dict = {}
blocks: dict = {}


def pick(prefix):
    return {k[len(prefix):]: v for k, v in D.items() if k.startswith(prefix)}


def lm_state():
    """The tiny LM's TrainState with non-trivial adamw moments."""
    params = {k: torch.tensor(v).requires_grad_() for k, v in pick("lm/").items()}
    opt = {"count": torch.tensor(3, dtype=torch.int32),
           "mu": {k: torch.tensor(v) for k, v in pick("mu/").items()},
           "nu": {k: torch.tensor(v) for k, v in pick("nu/").items()}}
    return TrainState(step=3, params=params, opt_state=opt)


def payload(st):
    return {"state": st,
            "loop": {k: torch.tensor(int(D[f"loop/{k}"]), dtype=torch.int64)
                     for k in ("updates", "examples", "epochs")},
            "loader": {k[len("loader/"):]: torch.tensor(int(v), dtype=torch.int64)
                       for k, v in D.items() if k.startswith("loader/")}}


def zeros_like_payload():
    """The payload's structure at global shapes, every tensor zero."""
    return manifest.map_with_path(
        lambda p, x: torch.zeros_like(x) if torch.is_tensor(x) else x,
        payload(lm_state()))


def mesh_for(kind, n):
    if kind == "fsdp":
        return Mesh(np.arange(n), ("dp",))
    return Mesh(np.arange(n).reshape(n // 2, 2), ("dp", "tp"))


def rule_for(kind, mesh):
    return fsdp_rule(mesh, min_size=64) if kind == "fsdp" else transformer_tp_rules()


def keep_blocks(case, tree):
    specs = {}
    for p, leaf in manifest.named_leaves(tree):
        t = manifest.leaf_tensor(leaf)
        if t is None:
            continue
        blocks[f"{case}/{p}"] = t.detach().cpu().numpy()
        if torch.is_tensor(leaf):
            sh = sharding_of(leaf)
            specs[p] = None if sh is None else manifest._encode_spec(sh.spec)
    res.setdefault("specs", {})[case] = specs


def sharded_saves():
    """Save the LM's state sharded under both rules over this world."""
    for kind in ("fsdp", "tp"):
        mesh = mesh_for(kind, world)
        st, _ = shard_tree(lm_state(), mesh, rule_for(kind, mesh))
        path = os.path.join(tmp, f"ck_{kind}_{world}")
        save_checkpoint(path, payload(st), step=5)
        if rank == 0:
            with open(path + ".manifest.json") as f:
                res.setdefault("manifest", {})[kind] = json.load(f)
        res.setdefault("shard_bytes", {})[kind] = os.path.getsize(
            os.path.join(path, f"shard_{rank}.pt"))


def layout_of(x):
    sh = sharding_of(x)
    return None if sh is None else (manifest._encode_spec(sh.spec), dict(sh.mesh.shape))


def created_moments():
    """A state built as ``TrainState.create(placed params, adamw)``: its
    moments keep the blocks' tags, so a sharded save and restore keeps
    every worker's block; moments without tags make train_loop refuse
    the checkpoint."""
    mesh = mesh_for("fsdp", world)
    rule = rule_for("fsdp", mesh)
    opt = optim.adamw(1e-3)
    placed, _ = shard_tree(lm_state().params, mesh, rule)
    st = TrainState.create(placed, opt)
    with torch.no_grad():
        for k, p in st.params.items():
            st.opt_state["mu"][k].copy_(0.5 * p)
            st.opt_state["nu"][k].copy_(p * p)
    res["created_tagged"] = all(sharding_of(m[k]) is not None for m in
                                (st.opt_state["mu"], st.opt_state["nu"]) for k in m)
    path = os.path.join(tmp, f"ck_created_{world}")
    save_checkpoint(path, payload(st), step=5)
    like = payload(TrainState.create(shard_tree(lm_state().params, mesh, rule)[0], opt))
    with torch.no_grad():
        for _, x in manifest.named_leaves(like):
            if torch.is_tensor(x):
                x.zero_()
    back = restore_checkpoint(path, like)
    res["created_restored"] = [
        p for (p, a), (_, b) in zip(manifest.named_leaves(back),
                                    manifest.named_leaves(payload(st)))
        if manifest.leaf_tensor(a) is not None and not (
            torch.equal(manifest.leaf_tensor(a), manifest.leaf_tensor(b))
            and layout_of(a) == layout_of(b))]
    if rank == 0:
        with open(path + ".manifest.json") as f:
            res["created_manifest"] = json.load(f)
    # Moments made out of place lose the tag: the loop refuses to save them.
    bare = TrainState(step=0, params=st.params, opt_state={
        "count": st.opt_state["count"],
        "mu": {k: torch.zeros_like(p) for k, p in st.params.items()},
        "nu": st.opt_state["nu"]})
    shardings = shard_tree(TrainState.create(lm_state().params, opt), mesh, rule)[1]
    step = make_train_step(lambda p, ms, b: (sum(v.sum() for v in p.values()), ms), opt,
                           mesh=mesh, state_sharding=shardings)
    try:
        train_loop(step, bare, [torch.zeros(2)], steps=1,
                   checkpoint=CheckpointManager(os.path.join(tmp, "guard"),
                                                async_save=False))
        res["guard_error"] = ""
    except ValueError as exc:
        res["guard_error"] = str(exc)


def elastic_order_batches():
    ds = ArrayDataset((D["x"], D["ids"]))
    loader = DistributedDataLoader(DistributedDataContainer(ds), 16, elastic_order=True,
                                   shuffle=True, seed=7, device="cpu", prefetch=0)
    res["order"] = [b[1].tolist() for b in loader]
    res["geometry"] = loader.geometry()
    errors = {}
    for name, kw in (("container", dict(data=ds)),
                     ("drop_last", dict(data=DistributedDataContainer(ds),
                                        drop_last=False))):
        try:
            DistributedDataLoader(kw.pop("data"), 16, elastic_order=True, device="cpu",
                                  **kw)
            errors[name] = ""
        except ValueError as exc:
            errors[name] = str(exc)
    res["order_errors"] = errors


def peer_failure_abort():
    mesh = mesh_for("fsdp", world)
    st, _ = shard_tree(lm_state(), mesh, rule_for("fsdp", mesh))
    mgr = CheckpointManager(os.path.join(tmp, "abort"), async_save=False)
    mgr.save(1, payload(st))
    with faults.scope("ckpt.write@step=1:proc=1"):
        try:
            mgr.save(2, payload(st))
            res["abort_error"] = ""
        except Exception as exc:  # noqa: BLE001 - the type is the result
            res["abort_error"] = type(exc).__name__
    res["abort_steps"] = mgr.all_steps()
    res["abort_leftovers"] = sorted(n for n in os.listdir(mgr.directory)
                                    if "step_00000002" in n)
    step, back = mgr.restore(payload(st))
    same = all(torch.equal(manifest.leaf_tensor(a), manifest.leaf_tensor(b))
               for (_, a), (_, b) in zip(manifest.named_leaves(back),
                                         manifest.named_leaves(payload(st)))
               if manifest.leaf_tensor(a) is not None)
    res["abort_restored"] = [step, same]
    mgr.close()


# -- the live resize of a tiny MLP: 4 workers drain, 2 resume -------------

calls = [0]
consumed: list = []


def mlp_pieces():
    model = MLP(features=(16, 1), device="cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.tensor(D[f"mlp/{k}"]))

    def loss_fn(p, ms, b):
        x, y, ids = b
        consumed.append(ids.tolist())  # the ids this update consumed
        calls[0] += 1
        if phase == "w4" and rank == 0 and calls[0] == 3:
            resize.request_resize(2, reason="test-shrink")
        out = torch.func.functional_call(model, p, (x,))
        return ((out - y) ** 2).mean(), ms

    opt = optim.adam(1e-3)
    state = TrainState.create({k: v.detach().clone().requires_grad_()
                               for k, v in model.named_parameters()}, opt)
    ds = ArrayDataset((D["x"], D["x"] ** 2, D["ids"]))
    loader = DistributedDataLoader(DistributedDataContainer(ds), 16, elastic_order=True,
                                   shuffle=True, seed=7, device="cpu", prefetch=0)
    return make_train_step(loss_fn, opt), state, loader


def live_resize():
    resize.configure(os.path.join(tmp, "resize_bank.jsonl"))
    step, state, loader = mlp_pieces()
    mgr = CheckpointManager(os.path.join(tmp, "rz"), async_save=False)
    state, summary = train_loop(step, state, loader, epochs=1, flush_every=2,
                                checkpoint=mgr, save_every=100, resume=phase == "w2b")
    mgr.close()
    res["resize"] = {"summary": {k: summary[k] for k in (
        "updates", "resized_to", "resumed_from", "loss", "epochs")},
        "losses": [f["loss"] for f in summary["flushes"]],
        "consumed": consumed,
        "stamp": resize.read_handoff(mgr.directory),
        "phase_seconds": resize.get_resize_coordinator().phase_seconds()}


if phase == "w2a":
    sharded_saves()
    peer_failure_abort()
    created_moments()
    elastic_order_batches()
elif phase == "w4":
    sharded_saves()
    like = zeros_like_payload()
    mesh4 = mesh_for("fsdp", 4)
    keep_blocks("2to4", restore_checkpoint(os.path.join(tmp, "ck_fsdp_2"), like,
                                           mesh=mesh4))
    save_checkpoint(os.path.join(tmp, "rep"), payload(lm_state()), step=5)
    keep_blocks("rep_to_4", restore_checkpoint(os.path.join(tmp, "rep"), like,
                                               mesh=mesh4,
                                               rule=fsdp_rule(mesh4, min_size=64)))
    elastic_order_batches()
    live_resize()
elif phase == "w2b":
    like = zeros_like_payload()
    mesh2 = mesh_for("fsdp", 2)
    ck4 = os.path.join(tmp, "ck_fsdp_4")
    keep_blocks("4to2", restore_checkpoint(ck4, like, mesh=mesh2))
    keep_blocks("4to2_rule", restore_checkpoint(ck4, like, mesh=mesh2,
                                                rule=fsdp_rule(mesh2, min_size=256)))
    live_resize()

with open(out, "w") as f:
    json.dump(res, f)
np.savez(out + ".npz", **blocks)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight.
dist.barrier()
dist.destroy_process_group()
