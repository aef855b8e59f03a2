"""Deep Equilibrium Model with implicit gradients under data parallelism
(BASELINE config 4, the FastDEQ-style workload).

The port of ``examples/deq_regression.py``: the DEQ's fixed point is
solved on the device and differentiated implicitly
(:func:`~fluxmpi_tpu_torch.models.fixed_point_solve`), in the
``shard_map``-style step whose explicit collective averages the
gradients. Runs on the card, or on the CPU with ``--cpu``.

Run:  python examples_torch/deq_regression.py [--cpu] [--steps 50]
"""

import argparse

import numpy as np
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import DEQ
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate, shard_batch


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--steps", type=int, default=50)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 3)).astype(np.float32)
    y = np.tanh(x.sum(axis=1, keepdims=True)).astype(np.float32)
    model = fm.synchronize(DEQ(hidden=32, out=1, in_features=3, device=device,
                               generator=torch.Generator().manual_seed(fm.local_rank())))
    optimizer = optim.adam(5e-3)

    def loss_fn(p, ms, batch):
        bx, by = batch
        return ((torch.func.functional_call(model, p, (bx,)) - by) ** 2).mean(), ms

    # shard_map style: the implicit-gradient solve runs per worker and the
    # explicit collective averages the gradients.
    step = make_train_step(loss_fn, optimizer, style="shard_map", grad_reduce="mean")
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer))
    batch = shard_batch((x, y))

    losses = []
    for _ in range(args.steps):
        state, loss = step(state, batch)
        losses.append(loss)
    losses = [float(v) for v in losses]
    fm.fluxmpi_println(f"DEQ training: {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0] * 0.5
    print("DEQ_OK")


if __name__ == "__main__":
    main()
