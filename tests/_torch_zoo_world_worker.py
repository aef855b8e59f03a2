"""One rank of the gloo worlds of ``tests/test_torch_draws_c32.py`` and
``tests/test_torch_fused_zoo_world.py``: ``python _torch_zoo_world_worker.py
GROUP RANK WORLD STORE OUT DATA`` (the arguments of
``tests/_torch_worlds.py``'s workers; ``DATA`` is unused). Every rank
builds the same models from seeded generators and the same global batches
from ``numpy.random.default_rng``; rank ``r`` of ``W`` trains on rows ``r *
B / W ..`` of each. ``GROUP`` picks the cases:

- ``draws``: two ``make_train_step`` updates (sgd) of a tiny DDPM UNet
  (``ddpm_loss``), a tiny MoE layer with router noise (its default
  grouping, and ``n_groups=3``, which no two workers' rows hold whole;
  and behind a ring attention, at world 2 under ``ParallelConfig(sp=2)``,
  each worker a sequence block of every row),
  a tiny ViT with dropout through the flash kernels' plain versions
  (``flash_attention_fn(dropout_impl="kernel")``) and one through the dense
  attend with a mask per row and head; each rank records every random draw
  of its rows (the DDPM timesteps and noise, the router noise, the
  embedding dropout's keep mask, the attention keep masks), the losses and
  the parameters;
- ``fused``: the tiny ViT (dropout 0.1, kernel-path masks) and the tiny
  UNet through ``train_loop`` over a ``DistributedDataLoader``,
  ``fuse="window"`` beside ``fuse=False``.

Each rank writes its results to ``OUT`` (an npz keyed ``case/name``)."""

import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

torch.set_num_threads(1)
group = sys.argv[1]
rank, world, store_path, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.models import (MoEMLP, UNet, ViT, cosine_beta_schedule,  # noqa: E402
                                      ddpm_loss)
from fluxmpi_tpu_torch.models import _layers, moe, unet, vit  # noqa: E402
from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState,  # noqa: E402
                                        make_train_step, ring_attention, train_loop)

# The module (``fluxmpi_tpu_torch.ops.flash_attention`` the name is the function).
fa = sys.modules["fluxmpi_tpu_torch.ops.flash_attention"]
fm.init(device="cpu")
res = {}
ROWS = 4  # the global batch
UNET = dict(out_channels=3, base_channels=8, channel_mults=(1, 2), blocks_per_stage=2,
            attn_resolutions=(4,), groups=4)
VIT = dict(num_classes=5, patch=8, num_layers=2, d_model=32, num_heads=4, d_ff=64)
MOE = dict(num_experts=4, d_ff=16, d_model=8, router_noise=1.0)


def put(case, key, value):
    res[f"{case}/{key}"] = np.asarray(value)


def mine(a):
    """This rank's rows of a global batch."""
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


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
    """An ``attention_fn`` whose signature names the dropout keywords, so
    the models' attend hands it the rate: it drops in the flash kernels
    (here their plain versions)."""
    return fa.flash_attention_fn(dropout_impl="kernel")(
        query, key, value, mask=mask, dropout_rng=dropout_rng, dropout_rate=dropout_rate,
        deterministic=deterministic)


def dense_attention(query, key, value, mask=None, dropout_rng=None, dropout_rate=0.0,
                    deterministic=True):
    """The dense attend with a dropout mask per batch row and head."""
    return _layers.dot_product_attention(
        query, key, value, mask, dropout_rng=dropout_rng, dropout_rate=dropout_rate,
        broadcast_dropout=False, deterministic=deterministic)


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


def unet_case():
    model = perturbed(UNet(**UNET, image_size=8, device="cpu",
                           generator=torch.Generator().manual_seed(0)), 1)
    betas = cosine_beta_schedule(100, device="cpu")
    gen = torch.Generator().manual_seed(42)

    def loss_fn(p, ms, batch):
        return ddpm_loss(model, p, batch[0], gen, betas), ms

    rng = np.random.default_rng(5)
    batches = [(torch.from_numpy(rng.uniform(-1, 1, (ROWS, 8, 8, 3)).astype(np.float32)),)
               for _ in range(2)]
    return model, loss_fn, batches, [Recorder(unet, "_ddpm_draws", tsteps=lambda o: o[0],
                                              eps=lambda o: o[1])]


def moe_case(n_groups):
    model = MoEMLP(**MOE, n_groups=n_groups, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(43)

    def loss_fn(p, ms, batch):
        y = torch.func.functional_call(model, p, (batch[0],), {"rng": gen})
        return (y.float() ** 2).mean(), ms

    rng = np.random.default_rng(6)
    batches = [(torch.from_numpy(rng.normal(size=(ROWS, 6, 8)).astype(np.float32)),)
               for _ in range(2)]
    return model, loss_fn, batches, [
        Recorder(moe, "_router_noise", noise=lambda o: o.reshape(-1, o.shape[-1]))]


class RingMoE(torch.nn.Module):
    """Embedding, a causal ring attention over ``sp`` (the whole sequence
    without it), a residual MoE layer with router noise, tied head."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.embedding = torch.nn.Parameter(0.3 * torch.randn(32, 8, generator=g))
        self.moe = MoEMLP(**MOE, device="cpu", generator=g)

    def forward(self, x, y, rng):
        h = self.embedding[x]
        q = h.reshape(*h.shape[:2], 2, 4)
        h = h + ring_attention(q, q, q, axis_name="sp", causal=True).reshape(h.shape)
        h = h + self.moe(h, train=True, rng=rng)
        return F.cross_entropy((h @ self.embedding.T).reshape(-1, 32), y.reshape(-1))


def moe_sp_case():
    model = RingMoE()
    gen = torch.Generator().manual_seed(45)

    def loss_fn(p, ms, batch):
        return torch.func.functional_call(model, p, (batch[0], batch[1], gen)), ms

    rng = np.random.default_rng(10)
    batches = [tuple(torch.from_numpy(rng.integers(0, 32, (ROWS, 8))).long()
                     for _ in range(2)) for _ in range(2)]
    return model, loss_fn, batches, [
        Recorder(moe, "_router_noise", noise=lambda o: o.reshape(-1, o.shape[-1]))]


def vit_model(attention_fn):
    return perturbed(ViT(**VIT, dropout=0.1, attention_fn=attention_fn, image_size=24,
                         device="cpu", generator=torch.Generator().manual_seed(0)), 2)


def vit_case(attention_fn, mask_module, mask_name):
    model = vit_model(attention_fn)
    gen = torch.Generator().manual_seed(44)

    def loss_fn(p, ms, batch):
        logits = torch.func.functional_call(model, p, (batch[0],), {"dropout_rng": gen})
        return F.cross_entropy(logits, batch[1]), ms

    rng = np.random.default_rng(7)
    batches = [(torch.from_numpy(rng.normal(size=(ROWS, 24, 24, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 5, ROWS)).long()) for _ in range(2)]
    return model, loss_fn, batches, [Recorder(vit, "_dropout", embed_keep=lambda o: o != 0),
                                     Recorder(mask_module, mask_name, attn_keep=lambda o: o)]


if group == "draws":
    cases = {"unet": unet_case, "moe": lambda: moe_case(None),
             "moe_groups3": lambda: moe_case(3), "moe_sp": moe_sp_case,
             "vit_kernel": lambda: vit_case(kernel_attention, fa, "_keep_mask"),
             "vit_dense": lambda: vit_case(dense_attention, _layers, "dense_dropout_keep")}
    for case, build in cases.items():
        model, loss_fn, batches, recs = build()
        opt = optim.sgd(0.1)
        state = TrainState.create(model, opt)
        if case == "moe_sp" and world > 1:
            # Every worker holds the rows whole and its sequence block.
            plan = ParallelConfig(sp=world).resolve()
            step, share = make_train_step(loss_fn, opt, parallel=plan), (lambda t: t)
        else:
            step, share = make_train_step(loss_fn, opt), mine
        for u, batch in enumerate(batches):
            state, loss = step(state, tuple(share(t) for t in batch))
            put(case, f"loss{u}", float(loss))
        for rec in recs:
            rec.close()
            for name, calls in rec.calls.items():
                put(case, f"{name}_calls", len(calls))
                for i, t in enumerate(calls):
                    put(case, f"{name}{i}", t.numpy())
        for k, v in state.params.items():
            put(case, f"param/{k}", v.detach().numpy())

elif group == "fused":
    def zoo(kind):
        if kind == "vit":
            model = vit_model(kernel_attention)
            gen = torch.Generator().manual_seed(44)

            def loss_fn(p, ms, batch):
                logits = torch.func.functional_call(model, p, (batch[0],),
                                                    {"dropout_rng": gen})
                return F.cross_entropy(logits, batch[1]), ms

            rng = np.random.default_rng(8)
            data = (rng.normal(size=(32, 24, 24, 3)).astype(np.float32),
                    rng.integers(0, 5, 32).astype(np.int64))
        else:
            model = perturbed(UNet(**UNET, image_size=8, device="cpu",
                                   generator=torch.Generator().manual_seed(0)), 1)
            betas = cosine_beta_schedule(100, device="cpu")
            gen = torch.Generator().manual_seed(42)

            def loss_fn(p, ms, batch):
                return ddpm_loss(model, p, batch[0], gen, betas), ms

            data = (np.random.default_rng(9).uniform(-1, 1, (32, 8, 8, 3)).astype(np.float32),)
        opt = optim.adam(1e-3)
        loader = fm.DistributedDataLoader(fm.DistributedDataContainer(fm.ArrayDataset(data)),
                                          8, shuffle=True, seed=3, device="cpu")
        return make_train_step(loss_fn, opt), TrainState.create(model, opt), loader

    for kind in ("vit", "unet"):
        bits, flushes = {}, {}
        for fuse in (False, "window"):
            step, state, loader = zoo(kind)
            state, summ = train_loop(step, state, loader, epochs=2, flush_every=2,
                                     fuse=fuse)
            bits[fuse] = {f"params/{k}": v.detach().clone() for k, v in state.params.items()}
            bits[fuse].update({f"{m}/{k}": v.clone() for m in ("mu", "nu")
                               for k, v in state.opt_state[m].items()})
            flushes[fuse] = [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                             for f in summ["flushes"]]
            put(kind, f"fused_window_{fuse}", summ["fused_window"] or 0)
            put(kind, f"dispatches_{fuse}", summ["dispatches"])
            put(kind, f"updates_{fuse}", summ["updates"])
        put(kind, "same", sum(torch.equal(bits["window"][k], bits[False][k])
                              for k in bits[False]))
        put(kind, "leaves", len(bits[False]))
        put(kind, "flushes_equal", flushes["window"] == flushes[False])

np.savez(out, **res)
fm.shutdown()
dist.barrier()
dist.destroy_process_group()
