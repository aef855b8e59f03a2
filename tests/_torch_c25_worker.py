"""One rank of ``tests/test_torch_c25.py``'s gloo worlds: ``python
_torch_c25_worker.py c25 RANK WORLD STORE OUT DATA`` (the arguments of
``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the
test writes: the global batches and the flax weights of a small CNN
(``cnn/...``) and DEQ (``deq/...``), and ``deq_opts``. Each rank takes its
share of every global batch (the rows ``rank * n / world`` on) and runs
one ``sgd`` update of each model with ``style="auto"`` (with and without
``remat=True``) and ``style="shard_map"``, and writes its loss, its
gradients (the update over the learning rate) and the CNN's new
statistics to ``OUT`` (an npz keyed ``case/name``)."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

torch.set_num_threads(1)
rank, world, store_path, out, data_path = (
    int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.models import CNN, DEQ, load_flax_params, load_flax_variables  # noqa: E402
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step  # noqa: E402

fm.init(device="cpu")
D = dict(np.load(data_path))
DEQ_OPTS = json.loads(str(D.pop("deq_opts")))
res = {}


def tree(prefix):
    out = {}
    for key, arr in D.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return out


def mine(a):
    n = a.shape[0]
    return torch.from_numpy(a[rank * n // world:(rank + 1) * n // world])


def update(case, model, loss_fn, lr, batch, ms=None, **kw):
    """One update; records the loss, the gradients and the new state."""
    opt = optim.sgd(lr)
    st = TrainState.create(model, opt, model_state=ms)
    before = {k: v.detach().clone() for k, v in st.params.items()}
    st, loss = make_train_step(loss_fn, opt, **kw)(st, batch)
    res[f"{case}/loss"] = loss.numpy()
    for k, v in st.params.items():
        res[f"{case}/grad/{k}"] = ((before[k] - v.detach()) / lr).numpy()
    for k, v in (st.model_state or {}).items():
        res[f"{case}/stats/{k}"] = v.numpy()


cnn_vars = {"params": tree("cnn/params"), "batch_stats": tree("cnn/batch_stats")}
for name, kw in (("auto", {}), ("auto_remat", dict(remat=True)),
                 ("shard_map", dict(style="shard_map"))):
    model, ms = load_flax_variables(CNN(4, (4, 8), device="cpu"), cnn_vars)

    def cnn_loss(p, ms, b, model=model):
        logits, new = model(b[0], ms, train=True)
        return F.cross_entropy(logits, b[1].long()), new

    update(f"cnn_{name}", model, cnn_loss, 1.0, (mine(D["cnn_x"]), mine(D["cnn_y"])), ms, **kw)

    for solver in ("damped", "anderson", "broyden"):
        deq = load_flax_params(
            DEQ(**DEQ_OPTS, solver=solver, in_features=D["deq_x"].shape[1], device="cpu"),
            tree("deq/params"))

        def deq_loss(p, ms, b, deq=deq):
            return ((deq(b[0]) - b[1]) ** 2).mean(), ms

        update(f"deq_{solver}_{name}", deq, deq_loss, 0.1,
               (mine(D["deq_x"]), mine(D["deq_y"])), **kw)

np.savez(out, **res)
fm.shutdown()
dist.destroy_process_group()
