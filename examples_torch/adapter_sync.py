"""Adapter-path walkthrough: syncing non-tree models and flat parameter
vectors.

The port of ``examples/adapter_sync.py`` (the reference's two framework
integrations):

1. **FluxModelWrapper** — a plain Python class holding tensors in
   attributes is not a tree, so ``fm.synchronize`` cannot walk it;
   wrapped in :class:`fluxmpi_tpu_torch.FluxModelWrapper`, every tensor
   attribute (nested objects included) is broadcast from the root rank.
2. **FlatParamVector** — the whole parameter tree in ONE contiguous
   buffer, so every collective on it (the init sync, the step's gradient
   all-reduce) is one collective whatever the number of layers. It is a
   registered tree node whose only leaf is the flat buffer.

Runs on the card, or on the CPU with ``--cpu``.

Run:  python examples_torch/adapter_sync.py [--cpu] [--steps 60]
"""

import argparse

import numpy as np
import torch
from torch.utils import _pytree as pytree

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import FlatParamVector, FluxModelWrapper, optim
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate, shard_batch


class Head:
    """Nested sub-object: the wrapper walk recurses into attributes."""

    def __init__(self, gen, device):
        self.w = (torch.randn((32, 1), generator=gen) * 0.3).to(device)
        self.b = torch.zeros((1,), device=device)


class TinyNet:
    """A mutable model class holding its weights in attributes — not a
    tree (the analogue of an arbitrary Flux model struct)."""

    def __init__(self, seed, device):
        gen = torch.Generator().manual_seed(seed)
        self.w = (torch.randn((3, 32), generator=gen) * 0.5).to(device)
        self.b = torch.zeros((32,), device=device)
        self.head = Head(gen, device)

    def __call__(self, x):
        h = torch.tanh(x @ self.w + self.b)
        return h @ self.head.w + self.head.b


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)

    # --- Part 1: a non-tree model object, synced via FluxModelWrapper ----
    # Rank-divergent init (each process seeds with its rank), then one
    # synchronize call replaces every attribute with the root rank's.
    net = fm.synchronize(FluxModelWrapper(TinyNet(fm.local_rank(), device))).model
    root_net = TinyNet(0, device)
    np.testing.assert_allclose(net.w.cpu().numpy(), root_net.w.cpu().numpy())
    np.testing.assert_allclose(net.head.w.cpu().numpy(), root_net.head.w.cpu().numpy())
    print("wrapper sync: all attributes (nested included) match root rank")

    # --- Part 2: the same weights as a FlatParamVector, trained DP -------
    # from_tree flattens a tree into one buffer; collectives on the vector
    # (the sync now, the gradient all-reduce every step) touch ONE tensor.
    params_tree = {"w": net.w, "b": net.b, "head": {"w": net.head.w, "b": net.head.b}}
    fpv = fm.synchronize(FlatParamVector.from_tree(params_tree))
    leaves, spec = pytree.tree_flatten(fpv)
    print(f"flat vector: {len(fpv)} params in one buffer ({len(leaves)} tree leaf)")

    def apply_flat(flat, x):
        p = pytree.tree_unflatten([flat], spec).to_tree()
        h = torch.tanh(x @ p["w"] + p["b"])
        return h @ p["head"]["w"] + p["head"]["b"]

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 3)).astype(np.float32)
    y = np.tanh(x.sum(axis=1, keepdims=True)).astype(np.float32)
    optimizer = optim.adam(1e-2)

    def loss_fn(p, ms, batch):
        bx, by = batch
        return ((apply_flat(p["flat"], bx) - by) ** 2).mean(), ms

    # The gradient of the flat buffer is one tensor: the DP gradient
    # reduction inside the step is a single all-reduce.
    step = make_train_step(loss_fn, optimizer, style="shard_map", grad_reduce="mean")
    state = replicate(TrainState.create({"flat": leaves[0].clone().requires_grad_()},
                                        optimizer))
    batch = shard_batch((x, y))
    losses = []
    for _ in range(args.steps):
        state, loss = step(state, batch)
        losses.append(loss)
    first, final = float(losses[0]), float(losses[-1])
    print(f"flat-vector DP training: loss {first:.4f} -> {final:.4f} ({args.steps} steps)")
    assert final < first / 5, (first, final)
    print("ADAPTER_SYNC_OK")


if __name__ == "__main__":
    main()
