"""One rank of ``tests/test_torch_fused_seq_ep.py``'s gloo worlds: ``python
_torch_fused_seq_ep_worker.py GROUP RANK WORLD STORE OUT DATA`` (the
arguments of ``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the
test writes: the dense LM's and the MoE LM's flax weights (``lm/...``,
``moe/...``), the tokens and targets, and ``cases`` (the JSON table of this
world's cases). ``GROUP`` is ``plans``: for each case,
``train_loop(fuse="auto")`` beside ``fuse=False`` (2 epochs of 4 batches
in windows of 2), the fused run's flushes and blocks, ``device_epoch()``
against ``iter()`` at every cursor, the step's ``across_workers``, and a
1-update window whose second call runs under a pretended capture (a
subgroup nobody warmed raises there), with the subgroups the window
program warmed; on 4 ranks a fused ``dp=2 x ep=2`` run killed inside a
window and resumed fused from its sharded checkpoint, and a made but
unwarmed subgroup asked for under a pretended capture.

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
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader  # noqa: E402
from fluxmpi_tpu_torch.models import (MoEMLP, MoETransformerLM, TransformerLM,  # noqa: E402
                                      collect_moe_losses, expert_parallel_rules,
                                      load_flax_params)
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_train_step, train_loop, ulysses_attention_fn)
from fluxmpi_tpu_torch.parallel import sharding as _sharding  # noqa: E402
from fluxmpi_tpu_torch.utils import CheckpointManager  # noqa: E402
from fluxmpi_tpu_torch.utils.manifest import named_leaves  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
CASES = json.loads(str(D.pop("cases")))
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)
LR = 0.1
GBS, WIDTH, EPOCHS = 8, 2, 2
lm_params = {k[len("lm/"):]: v for k, v in D.items() if k.startswith("lm/")}
moe_params = {k[len("moe/"):]: v for k, v in D.items() if k.startswith("moe/")}
tokens, targets = D["tokens"], D["targets"]
res = {}


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value)


class Killed(Exception):
    pass


class NoisyMoE(torch.nn.Module):
    """Tied embedding, one residual MoE layer with router noise (drawn
    from the generator the loss passes), tied head."""

    def __init__(self, mesh):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.embedding = torch.nn.Parameter(0.3 * torch.randn(32, 8, generator=g))
        self.moe = MoEMLP(num_experts=4, d_ff=16, d_model=8, router_noise=0.1, mesh=mesh,
                          device="cpu", generator=g)

    def forward(self, x, y, rng):
        h = self.embedding[x]
        h = h + self.moe(h, train=True, rng=rng)
        logits = h @ self.embedding.T
        return torch.nn.functional.cross_entropy(logits.reshape(-1, 32), y.reshape(-1).long())


def build(spec, kill_at=None):
    """A fresh model placed under the case's plan, its step and its
    loader; ``kill_at``: the loss raises on that call."""
    kw = dict(spec["plan"])
    ep = "ep" in kw
    if ep:
        kw["rules"] = expert_parallel_rules()
    plan = ParallelConfig(**kw).resolve()
    mesh = plan.mesh if ep else None
    if spec["kind"] == "noise":
        model = NoisyMoE(mesh)
    elif spec["kind"] == "moe":
        model = load_flax_params(
            MoETransformerLM(**LM, num_experts=4, **spec.get("moe", {}), mesh=mesh,
                             attention=spec.get("attention", "naive"), device="cpu"),
            moe_params)
    else:
        fn = ulysses_attention_fn(causal=True) if spec.get("fn") == "ulysses" else None
        model = load_flax_params(
            TransformerLM(**LM, attention=spec.get("attention", "naive"), attention_fn=fn,
                          dropout=spec.get("dropout", 0.0), device="cpu"), lm_params)
    opt = optim.sgd(LR)
    state = TrainState.create(dict(model.named_parameters()), opt)
    if plan.shards_parameters:
        state, _ = plan.shard_state(state)
    # The dropout and router-noise draws, seeded alike on every path.
    gen = torch.Generator().manual_seed(11)
    calls = [0]

    def loss_fn(p, ms, batch):
        calls[0] += 1
        if calls[0] == kill_at:
            raise Killed(calls[0])
        x, y = batch["x"], batch["y"]
        if spec["kind"] == "noise":
            return torch.func.functional_call(model, p, (x, y, gen)), ms
        if spec["kind"] == "moe":
            sown = {}
            ce = torch.func.functional_call(model, p, (x,), {"targets": y, "losses": sown})
            aux, z = collect_moe_losses(sown)
            return ce.mean() + 0.1 * aux + 0.01 * z, ms
        kw = {"targets": y}
        if spec.get("dropout"):
            kw["dropout_rng"] = gen
        return torch.func.functional_call(model, p, (x,), kw).mean(), ms

    step = make_train_step(loss_fn, opt, parallel=plan)
    return plan, step, state, loader_for(plan)


def loader_for(plan):
    return DistributedDataLoader(ArrayDataset({"x": tokens, "y": targets}), GBS,
                                 mesh=plan.mesh, axis_name=plan.data_axes, shuffle=True,
                                 seed=11, device="cpu")


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
            state, summary = train_loop(step, state, loader, epochs=EPOCHS,
                                        flush_every=WIDTH, fuse=fuse)
            runs[fuse] = (leaves(state), summary, step)
        (want, pipe, _), (got, fused, step) = runs[False], runs["auto"]
        fused_leaves[case] = got
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
        # device_epoch() against iter() at every cursor.
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
        # A 1-update window, then its second call under a pretended
        # capture: every subgroup the update asks for (the MoE layers' ep
        # exchange, the ring's and Ulysses' sp axis, the batch axes) must
        # have been warmed after the eager first window.
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
        # A made subgroup nobody warmed, asked for under a pretended capture.
        fresh = ParallelConfig(dp=2, ep=2).resolve().mesh
        fresh.group(("ep",))
        _sharding._capturing = lambda: True
        try:
            fresh.group(("ep",))
            put("unwarmed", "error", "")
        except RuntimeError as exc:
            put("unwarmed", "error", str(exc))
        finally:
            _sharding._capturing = capturing
        # A fused dp=2 x ep=2 run killed inside its third window (the loss
        # raises on its fifth call); every window boundary banks
        # shard_<rank>.pt. Resumed fused, it ends on the uninterrupted
        # fused run's bits.
        ck = Path(out).parent / "ckpt"
        spec = CASES["moe_dp_ep"]
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
        put("kill", "same", same(leaves(state), fused_leaves["moe_dp_ep"]))
        put("kill", "leaves", len(fused_leaves["moe_dp_ep"]))
        for key in ("resumed_from", "updates", "dispatches", "fused_window"):
            put("kill", key, s[key])
        put("kill", "flush_updates", [f["updates"] for f in s["flushes"]])

np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
