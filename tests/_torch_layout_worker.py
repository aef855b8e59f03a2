"""One rank of the layout tests' gloo world (run by
``tests/test_torch_parallel_layouts.py``): ``python _torch_layout_worker.py
RANK WORLD STORE OUT DATA``. Reads the flax weights and the global batches
from ``DATA`` (an npz the test writes), runs every layout case of its world
and writes this rank's results to ``OUT`` (an npz keyed ``case/name``)."""

import functools
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store_path, out, data_path = (int(sys.argv[1]), int(sys.argv[2]),
                                           sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader  # noqa: E402
from fluxmpi_tpu_torch.models import (MoETransformerLM, TransformerLM,  # noqa: E402
                                      expert_parallel_rules, load_flax_params)
from fluxmpi_tpu_torch.models import transformer as _transformer  # noqa: E402
from fluxmpi_tpu_torch.ops import tp_unembed_cross_entropy  # noqa: E402
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_eval_step, make_train_step, pallreduce, pbroadcast, pmean_tree, psum_tree,
                                        shard_tree)
from fluxmpi_tpu_torch.parallel.sharding import Mesh  # noqa: E402

D = dict(np.load(data_path))
LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32,
          num_experts=4)
params = {k[len("params/"):]: v for k, v in D.items() if k.startswith("params/")}
lm_params = {k[len("lmparams/"):]: v for k, v in D.items() if k.startswith("lmparams/")}
tokens, targets = D["tokens"], D["targets"]
res = {}
LR = 1e-3

fm.init(device="cpu")


def put(case, tree):
    for k, v in tree.items():
        res[f"{case}/{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v)


def lm(mesh=None):
    model = MoETransformerLM(**LM, mesh=mesh, device="cpu")
    return load_flax_params(model, params)


def dense_lm():
    kw = {k: v for k, v in LM.items() if k != "num_experts"}
    return load_flax_params(TransformerLM(**kw, device="cpu"), lm_params)


# What the tensor-parallel cases observe from the second update on: the
# heads each attention sees, the all-gathers the step makes, and the
# gradients the optimizer gets (a Megatron "f" left out would leave the
# replicated LayerNorms' and biases' gradients short by the tp factor).
SEEN = {"heads": [], "gathers": 0, "grads": []}
_attend = _transformer.dot_product_attention
_all_gather = dist.all_gather


@functools.wraps(_attend)  # the attend filters its keywords by this signature
def _seen_attend(q, k, v, *args, **kw):
    SEEN["heads"].append(q.shape[2])
    return _attend(q, k, v, *args, **kw)


def _seen_gather(*args, **kw):
    SEEN["gathers"] += 1
    return _all_gather(*args, **kw)


_transformer.dot_product_attention = _seen_attend
dist.all_gather = _seen_gather


def recording(opt):
    def update(grads, state, params=None):
        SEEN["grads"].append({k: g.detach().clone() for k, g in grads.items()})
        return opt.update(grads, state, params)

    return optim.GradientTransformation(opt.init, update)


def loss_fn(model):
    def fn(p, mstate, batch):
        out = torch.func.functional_call(model, p, (batch["x"],),
                                         {"targets": batch["y"]})
        return out.mean(), mstate

    return fn


CASES = {2: {"fsdp": dict(fsdp=2, fsdp_min_size=64)},
         4: {"dp_tp": dict(dp=2, tp=2), "fsdp_tp": dict(fsdp=2, tp=2, fsdp_min_size=64),
             "dp_ep": dict(dp=2, ep=2), "lm_dp_tp": dict(dp=2, tp=2),
             "lm_fsdp_tp": dict(fsdp=2, tp=2, fsdp_min_size=64)}}
for case, kw in CASES[world].items():
    if "ep" in kw:
        kw = dict(kw, rules=expert_parallel_rules())
    plan = ParallelConfig(**kw).resolve()
    model = dense_lm() if case.startswith("lm_") else lm(plan.mesh if "ep" in kw else None)
    opt = recording(optim.adamw(LR))
    state, shardings = plan.shard_state(TrainState.create(model, opt))
    res[f"{case}/rule_hits"] = np.array(sorted(plan.rule_hits.items()), dtype=object).astype(str)
    # The model stats built in (depth 2): the core returns them per update.
    step = make_train_step(loss_fn(model), opt, parallel=plan, model_stats=2)
    core = step.__fluxmpi_compiled__
    loader = DistributedDataLoader(ArrayDataset({"x": tokens, "y": targets}), 8,
                                   mesh=plan.mesh, axis_name=plan.data_axes,
                                   device="cpu")
    losses = []
    for i, batch in zip(range(3), loader):
        if i == 1:
            SEEN.update(heads=[], gathers=0, grads=[])
        state, (loss, _, (table, noise)) = core(state, batch)
        losses.append(float(loss))
        if i == 1:
            res[f"{case}/stats"] = table.numpy()
            res[f"{case}/stats_noise"] = np.array(noise is None)
    res[f"{case}/stats_names"] = np.array(core.__fluxmpi_model_stats_meta__["plans"][0].names)
    res[f"{case}/losses"] = np.array(losses)
    put(f"{case}/param", state.params)
    put(f"{case}/grad", SEEN["grads"][0])
    res[f"{case}/heads"] = np.array(sorted(set(SEEN["heads"])))
    res[f"{case}/gathers"] = np.array(SEEN["gathers"])
    res[f"{case}/tp_blocks"] = np.array(sorted(step.__fluxmpi_layout__.tp_blocks), dtype=str)
    # The eval step evaluates the blocks in their training layout.
    evaluate = make_eval_step(lambda p, ms, b: loss_fn(model)(p, ms, b)[0], parallel=plan)
    res[f"{case}/eval"] = fm.allreduce(evaluate(state, batch), "mean").numpy()

# The explicit per-worker step over the dp axis of the world's mesh.
if world == 2:
    model = lm()
    opt = optim.adamw(LR)
    state = TrainState.create(model, opt)
    step = make_train_step(loss_fn(model), opt, style="shard_map")
    loader = DistributedDataLoader(ArrayDataset({"x": tokens, "y": targets}), 8,
                                   mesh=fm.global_mesh(), device="cpu")
    losses = []
    for _, batch in zip(range(3), loader):
        state, loss = step(state, batch)
        losses.append(float(loss))
    res["shard_map/losses"] = np.array(losses)
    put("shard_map/param", state.params)

# The in-step collectives and their gradients over the world's dp axis.
x = torch.from_numpy(D["coll_x"][rank]).requires_grad_()
w = torch.arange(1.0, 4.0)
for name, f in [("psum", lambda v: psum_tree(v)), ("pmean", lambda v: pmean_tree(v)),
                ("prod", lambda v: pallreduce(v, "prod")),
                ("bcast", lambda v: pbroadcast(v, world - 1))]:
    y = f(x)
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    res[f"coll/{name}"] = y.detach().numpy()
    res[f"coll/{name}_grad"] = g.numpy()
res["coll/max"] = pallreduce(x.detach(), "max").numpy()
try:
    (pallreduce(x, "max") * w).sum().backward()
    res["coll/max_grad_raises"] = np.array(False)
except NotImplementedError:
    res["coll/max_grad_raises"] = np.array(True)

# The vocab-parallel fused CE over a tp axis of the whole world: the table
# as a DTensor sharded over tp (its gradient this worker's block), and as
# the whole table (its gradient whole).
from torch.distributed.tensor import DTensor, Shard  # noqa: E402

tp_mesh = Mesh(np.arange(world), ("tp",))
h = torch.from_numpy(D["ce_h"]).requires_grad_()
W = torch.from_numpy(D["ce_W"])
v_local = W.shape[0] // world
Wl = W[rank * v_local:(rank + 1) * v_local].clone().requires_grad_()
t = torch.from_numpy(D["ce_t"]).long()
Wd = DTensor.from_local(Wl, tp_mesh.device_mesh, [Shard(0)])
ce = tp_unembed_cross_entropy(h, Wd, t, mesh=tp_mesh, axis_name="tp", chunk=4)
gh, gW = torch.autograd.grad(ce.mean(), [h, Wl])
res["ce/loss"], res["ce/dh"], res["ce/dW"] = (ce.detach().numpy(), gh.numpy(), gW.numpy())
Wf = W.clone().requires_grad_()
ce = tp_unembed_cross_entropy(h, Wf, t, mesh=tp_mesh, axis_name="tp", chunk=4)
gh, gW = torch.autograd.grad(ce.mean(), [h, Wf])
res["ce_full/loss"], res["ce_full/dh"], res["ce_full/dW"] = (
    ce.detach().numpy(), gh.numpy(), gW.numpy())

# shard_tree's local blocks, and the loader's rows over composed meshes.
if world == 4:
    from fluxmpi_tpu_torch.parallel import fsdp_rule, transformer_tp_rules, combine_rules

    mesh = Mesh(np.arange(4).reshape(2, 2), ("fsdp", "tp"))
    rule = combine_rules(transformer_tp_rules(), fsdp_rule(mesh, axis_name="fsdp", min_size=64))
    placed, _ = shard_tree(dict(lm().named_parameters()), mesh, rule)
    put("shard_tree", placed)
    data = ArrayDataset({"i": np.arange(40)})
    for name, m, axes in [("dp_tp", Mesh(np.arange(4).reshape(2, 2), ("dp", "tp")), "dp"),
                          ("dp_fsdp", Mesh(np.arange(4).reshape(2, 2), ("dp", "fsdp")),
                           ("dp", "fsdp"))]:
        loader = DistributedDataLoader(data, 8, mesh=m, axis_name=axes, shuffle=True,
                                       seed=3, device="cpu")
        res[f"loader/{name}"] = np.stack([b["i"].numpy() for b in loader])
else:
    from fluxmpi_tpu_torch.parallel import fsdp_rule

    mesh = Mesh(np.arange(2), ("fsdp",))
    placed, _ = shard_tree(dict(lm().named_parameters()), mesh,
                           fsdp_rule(mesh, axis_name="fsdp", min_size=64))
    put("shard_tree", placed)

np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
