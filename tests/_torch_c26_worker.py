"""One rank of ``tests/test_torch_c26_c27.py``'s gloo worlds: ``python
_torch_c26_worker.py eval RANK WORLD STORE OUT DATA`` (the arguments of
``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the test writes:
the global batch of the MLP (``x``, ``y``) and its flax weights
(``mlp/...``), the DEQ's (``deq_x``, ``deq_y``, ``deq/...``, ``deq_opts``).
Each rank hands ``make_eval_step`` its share of every global batch (the
rows ``rank * n / world`` on), without a plan and with a dp-only plan, and
writes the metrics it returns to ``OUT`` (an npz keyed ``case/metric``)."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store_path, out, data_path = (
    int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.models import DEQ, MLP, load_flax_params  # noqa: E402
from fluxmpi_tpu_torch.parallel import ParallelConfig, TrainState, make_eval_step  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
DEQ_OPTS = json.loads(str(D.pop("deq_opts")))
res = {}


def tree(prefix):
    return {k[len(prefix) + 1:]: v for k, v in D.items() if k.startswith(prefix + "/")}


def mine(a):
    n = a.shape[0]
    return torch.from_numpy(a[rank * n // world:(rank + 1) * n // world])


mlp = load_flax_params(MLP(features=(16, 16, 1), device="cpu"), tree("mlp"))


def mlp_metrics(p, ms, b):
    x, y = b
    pred = torch.func.functional_call(mlp, p, (x,))
    d = pred - y
    return {"mse": (d ** 2).mean(), "mae": d.abs().mean(), "sum": (d ** 2).sum(),
            "max": d.abs().max(), "count": (pred > y).sum()}


plan = ParallelConfig(dp=world).resolve()
for name, kw in (("none", {}), ("dp_plan", dict(parallel=plan))):
    state = TrainState.create(mlp, optim.sgd(0.1))
    metrics = make_eval_step(mlp_metrics, **kw)(state, (mine(D["x"]), mine(D["y"])))
    for k, v in metrics.items():
        res[f"mlp_{name}/{k}"] = v.numpy()
    for solver in ("damped", "anderson", "broyden"):
        deq = load_flax_params(
            DEQ(**DEQ_OPTS, solver=solver, in_features=D["deq_x"].shape[1], device="cpu"),
            tree("deq"))

        def deq_metric(p, ms, b, deq=deq):
            return ((torch.func.functional_call(deq, p, (b[0],)) - b[1]) ** 2).mean()

        state = TrainState.create(deq, optim.sgd(0.1))
        res[f"deq_{solver}_{name}/mse"] = make_eval_step(deq_metric, **kw)(
            state, (mine(D["deq_x"]), mine(D["deq_y"]))).numpy()

np.savez(out, **res)
fm.shutdown()
dist.barrier()
dist.destroy_process_group()
