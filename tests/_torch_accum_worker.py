"""One rank of ``tests/test_torch_accum_c34.py``'s gloo worlds: ``python
_torch_accum_worker.py GROUPS RANK WORLD STORE OUT DATA`` (the arguments of
``tests/_torch_worlds.py``'s workers). ``DATA`` is an npz the test writes:
the global batches and the flax weights of every model, and ``cases``, the
JSON table of what this world runs. ``GROUPS`` is a comma-separated list:

- ``parity``: for each ``(model, k)`` of the table, two ``sgd`` updates of
  ``make_train_step(grad_accum_steps=k)`` (the default ``style="auto"``)
  from the flax weights, rank ``r`` of ``W`` on rows ``r * B / W ..`` of
  each global batch: the batch-normalized MLP, the CNN with
  ``BatchNorm(axis_name=None)``, the DEQ and ``MoEMLP(n_groups=3)``; the
  losses, the parameters and the statistics;
- ``plan``: with ``grad_accum_steps=2``, three updates over the loader's
  ``mesh=`` rows of the MoE LM (``n_groups=1``) under ``ParallelConfig(dp=2,
  sp=2)`` and of two stacked pipeline stages under ``(dp=2, pp=2)``;
- ``draws``: two updates with ``grad_accum_steps=2`` of a tiny DDPM UNet
  and a tiny ViT with dropout (the flash kernels' plain versions), every
  random draw of this rank's rows recorded;
- ``fused``: the CNN and the tiny ViT with ``grad_accum_steps=2`` through
  ``train_loop(fuse="auto")`` beside ``fuse=False``.

Each rank writes its results to ``OUT`` (an npz keyed ``case/name``)."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

torch.set_num_threads(1)
groups = sys.argv[1].split(",")
rank, world, store_path, out, data_path = (
    int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.models import (CNN, DEQ, MLP, MoEMLP, UNet, ViT,  # noqa: E402
                                      cosine_beta_schedule, ddpm_loss, load_flax_params,
                                      load_flax_variables, unet, vit)
from fluxmpi_tpu_torch.models._layers import (BatchNorm, StatsContext, _Init,  # noqa: E402
                                              init_batch_stats, name_norms)
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop  # noqa: E402

fa = sys.modules["fluxmpi_tpu_torch.ops.flash_attention"]
D = dict(np.load(data_path))
CASES = json.loads(str(D.pop("cases")))
res = {}


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value.detach() if torch.is_tensor(value) else value)


def tree(prefix):
    """The nested dict of the npz keys under ``prefix/``."""
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
    """This rank's rows of a global batch."""
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


class BNMLP(torch.nn.Module):
    """The quick-start MLP of the JAX package's step tests with its
    prediction batch-normalized (flax ``BatchNorm`` over the batch)."""

    def __init__(self):
        super().__init__()
        self.mlp = MLP((8, 8, 1), in_features=2, device="cpu")
        self.bn = BatchNorm(1, init=_Init("cpu", torch.Generator().manual_seed(0)))
        name_norms(self)

    def init_batch_stats(self):
        return init_batch_stats(self)

    def forward(self, x, stats):
        ctx = StatsContext(stats, True)
        return self.bn(self.mlp(x), ctx), ctx.new


def parity_model(name):
    """``(model, loss_fn, model_state, lr)`` of a parity case, from the
    flax weights."""
    if name == "mlp_bn":
        model, ms = load_flax_variables(BNMLP(), tree("mlp_bn"))

        def loss_fn(p, ms, b):
            pred, new = model(b[0], ms)
            return ((pred - b[1]) ** 2).mean(), new
    elif name == "cnn":
        model, ms = load_flax_variables(CNN(4, (4, 8), device="cpu"), tree("cnn"))

        def loss_fn(p, ms, b):
            logits, new = model(b[0], ms, train=True)
            return F.cross_entropy(logits, b[1].long()), new
    elif name == "deq":
        opts = json.loads(str(D["deq_opts"]))
        model, ms = load_flax_params(DEQ(**opts, in_features=3, device="cpu"),
                                     tree("deq/params")), None

        def loss_fn(p, ms, b):
            return ((model(b[0]) - b[1]) ** 2).mean(), ms
    else:
        opts = json.loads(str(D["moe_opts"]))
        model = load_flax_params(MoEMLP(**opts, device="cpu"), tree("moe/params"))
        ms = None

        def loss_fn(p, ms, b):
            y = torch.func.functional_call(model, p, (b[0],))
            return ((y - b[1]) ** 2).mean(), ms
    return model, loss_fn, ms, CASES["lr"][name]


def parity_group():
    for name, k in CASES["parity"]:
        case = f"{name}_k{k}"
        model, loss_fn, ms, lr = parity_model(name)
        opt = optim.sgd(lr)
        state = TrainState.create(model, opt, model_state=ms)
        step = make_train_step(loss_fn, opt, grad_accum_steps=k)
        xs, ys = D[f"{name}_x"], D[f"{name}_y"]
        for u in range(xs.shape[0]):
            state, loss = step(state, (mine(xs[u]), mine(ys[u])))
            put(case, f"loss{u}", loss)
        for key, v in state.params.items():
            put(case, f"param/{key}", v)
        for key, v in (state.model_state or {}).items():
            put(case, f"stats/{key}", v)


def plan_group():
    from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader
    from fluxmpi_tpu_torch.models import MoETransformerLM, collect_moe_losses
    from fluxmpi_tpu_torch.parallel import ParallelConfig

    from fluxmpi_tpu_torch.parallel import make_pipeline_fn, pipeline_rules
    from fluxmpi_tpu_torch.parallel.sharding import P

    for case, spec in CASES["plan"].items():
        if "moe" in spec:
            plan = ParallelConfig(**spec["plan"]).resolve()
            model = MoETransformerLM(**CASES["lm"], num_experts=4, **spec["moe"],
                                     device="cpu")
            load_flax_params(model, tree("moe_lm"))
            params = dict(model.named_parameters())

            def loss_fn(p, ms, batch, model=model):
                sown = {}
                ce = torch.func.functional_call(model, p, (batch["x"],), {
                    "targets": batch["y"], "losses": sown}).mean()
                aux, z = collect_moe_losses(sown)
                return ce + 0.1 * aux + 0.01 * z, ms

            data = {"x": D["tokens"], "y": D["targets"]}
        else:  # two stacked stages of make_pipeline_fn over pp
            rule = pipeline_rules("pp")
            plan = ParallelConfig(**spec["plan"], rules=lambda path, shape: (
                rule(path, shape) if "stages" in path else P())).resolve()
            params = {k: torch.from_numpy(D[name]).clone().requires_grad_() for k, name in (
                ("stages.w", "pp_w"), ("stages.b", "pp_b"), ("head", "pp_head"))}
            pipe = make_pipeline_fn(
                lambda p, x: F.gelu(x @ p["w"] + p["b"], approximate="tanh"), plan.mesh,
                n_microbatches=4, axis_name="pp")

            def loss_fn(p, ms, batch, pipe=pipe):
                y = pipe({"w": p["stages.w"], "b": p["stages.b"]}, batch["x"])
                return ((y @ p["head"] - batch["y"]) ** 2).mean(), ms

            data = {"x": D["pp_x"], "y": D["pp_y"]}
        opt = optim.sgd(0.1)
        state = TrainState.create(params, opt)
        if plan.shards_parameters:
            state, _ = plan.shard_state(state)
        step = make_train_step(loss_fn, opt, parallel=plan, grad_accum_steps=spec["k"])
        loader = DistributedDataLoader(ArrayDataset(data), spec["rows"], mesh=plan.mesh,
                                       axis_name=plan.data_axes, device="cpu")
        losses = []
        for _, batch in zip(range(3), loader):
            state, loss = step(state, batch)
            losses.append(float(loss))
        put(case, "losses", np.array(losses))
        for key, v in state.params.items():
            put(case, f"param/{key}", v)


class Recorder:
    """Wraps ``module.name`` to keep, for every call, ``picks[key](result)``
    under each key."""

    def __init__(self, module, name, **picks):
        self.calls = {key: [] for key in picks}
        self.module, self.name = module, name
        self.orig = getattr(module, name)

        def wrapped(*a, **k):
            out = self.orig(*a, **k)
            for key, pick in picks.items():
                self.calls[key].append(pick(out).detach().clone())
            return out

        setattr(module, name, wrapped)

    def close(self):
        setattr(self.module, self.name, self.orig)


def perturbed(model, seed):
    """``model`` moved off its init by 0.1 N(0, 1) from a seeded generator
    (its zero-initialised kernels would stop gradients), alike on every
    rank."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def kernel_attention(query, key, value, mask=None, dropout_rng=None, dropout_rate=0.0,
                     deterministic=True):
    """Attention through the flash kernels' plain versions, dropping in
    their counter-based hash."""
    return fa.flash_attention_fn(dropout_impl="kernel")(
        query, key, value, mask=mask, dropout_rng=dropout_rng, dropout_rate=dropout_rate,
        deterministic=deterministic)


def zoo(kind, rows):
    """``(model, loss_fn, batches)`` of the tiny ``"unet"`` or ``"vit"``:
    two global batches of ``rows``."""
    if kind == "unet":
        model = perturbed(UNet(**CASES["unet"], image_size=8, device="cpu",
                               generator=torch.Generator().manual_seed(0)), 1)
        betas = cosine_beta_schedule(100, device="cpu")
        gen = torch.Generator().manual_seed(42)

        def loss_fn(p, ms, batch):
            return ddpm_loss(model, p, batch[0], gen, betas), ms

        rng = np.random.default_rng(5)
        batches = [(rng.uniform(-1, 1, (rows, 8, 8, 3)).astype(np.float32),)
                   for _ in range(2)]
    else:
        model = perturbed(ViT(**CASES["vit"], dropout=0.1, attention_fn=kernel_attention,
                              image_size=24, device="cpu",
                              generator=torch.Generator().manual_seed(0)), 2)
        gen = torch.Generator().manual_seed(44)

        def loss_fn(p, ms, batch):
            logits = torch.func.functional_call(model, p, (batch[0],), {"dropout_rng": gen})
            return F.cross_entropy(logits, batch[1]), ms

        rng = np.random.default_rng(7)
        batches = [(rng.normal(size=(rows, 24, 24, 3)).astype(np.float32),
                    rng.integers(0, 5, rows).astype(np.int64)) for _ in range(2)]
    return model, loss_fn, batches


def draws_group():
    recorders = {"unet": lambda: [Recorder(unet, "_ddpm_draws", tsteps=lambda o: o[0],
                                           eps=lambda o: o[1])],
                 "vit": lambda: [Recorder(vit, "_dropout", embed_keep=lambda o: o != 0),
                                 Recorder(fa, "_keep_mask", attn_keep=lambda o: o)]}
    for kind in ("unet", "vit"):
        case = f"draws_{kind}"
        model, loss_fn, batches = zoo(kind, CASES["draw_rows"])
        recs = recorders[kind]()
        opt = optim.sgd(0.1)
        state = TrainState.create(model, opt)
        step = make_train_step(loss_fn, opt, grad_accum_steps=2)
        for u, batch in enumerate(batches):
            state, loss = step(state, tuple(mine(a) for a in batch))
            put(case, f"loss{u}", loss)
        for rec in recs:
            rec.close()
            for name, calls in rec.calls.items():
                put(case, f"{name}_calls", len(calls))
                for i, t in enumerate(calls):
                    put(case, f"{name}{i}", t)
        for key, v in state.params.items():
            put(case, f"param/{key}", v)


def fused_group():
    for kind in ("cnn", "vit"):
        case = f"fused_{kind}"
        bits, flushes = {}, {}
        for fuse in (False, "auto"):
            if kind == "cnn":
                model, loss_fn, ms, _ = parity_model("cnn")
                data = (D["cnn_x"].reshape(-1, *D["cnn_x"].shape[2:]),
                        D["cnn_y"].reshape(-1).astype(np.int64))
                opt = optim.sgd(0.1, momentum=0.9)
            else:
                model, loss_fn, _ = zoo("vit", 8)
                ms = None
                rng = np.random.default_rng(8)
                data = (rng.normal(size=(32, 24, 24, 3)).astype(np.float32),
                        rng.integers(0, 5, 32).astype(np.int64))
                opt = optim.adam(1e-3)
            loader = fm.DistributedDataLoader(
                fm.DistributedDataContainer(fm.ArrayDataset(data)), 16 if kind == "cnn" else 8,
                shuffle=True, seed=3, device="cpu")
            step = make_train_step(loss_fn, opt, grad_accum_steps=2)
            state = TrainState.create(model, opt, model_state=ms)
            state, summ = train_loop(step, state, loader, epochs=2, flush_every=2, fuse=fuse)
            leaves = {f"params/{k}": v.detach().clone() for k, v in state.params.items()}
            leaves.update({f"stats/{k}": v.clone() for k, v in (state.model_state or {}).items()})
            bits[fuse] = leaves
            flushes[fuse] = [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                             for f in summ["flushes"]]
            put(case, f"fused_window_{fuse}", summ["fused_window"] or 0)
            put(case, f"updates_{fuse}", summ["updates"])
        put(case, "same", sum(torch.equal(bits["auto"][k], bits[False][k]) for k in bits[False]))
        put(case, "leaves", len(bits[False]))
        put(case, "flushes_equal", flushes["auto"] == flushes[False])


fm.init(device="cpu")
try:
    for g in groups:
        {"parity": parity_group, "plan": plan_group, "draws": draws_group,
         "fused": fused_group}[g]()
    np.savez(out, **res)
finally:
    fm.shutdown()
    dist.barrier()
    dist.destroy_process_group()
