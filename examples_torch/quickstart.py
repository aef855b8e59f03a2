"""Quick-start: distributed data-parallel training of a 4-layer MLP.

The port of ``examples/quickstart.py`` (the reference README's example):
regress ``y = x^2`` with parameters synchronized from rank 0, each worker
reading its share of the batches, and the gradients averaged over the
workers. Runs on the card, or on the CPU with ``--cpu``; under a launcher
(``python -m fluxmpi_tpu_torch.launch --nproc N``) on N workers.

Run:  python examples_torch/quickstart.py [--cpu] [--epochs 30]
"""

import argparse
import sys
import time

import numpy as np
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import MLP
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate

N = 512


def squares_loader():
    """The ``y = x^2`` dataset (drawn as the JAX example draws it), in
    shuffled global batches of 64."""
    xs = np.random.default_rng(0).uniform(-2, 2, size=(N, 1)).astype(np.float32)
    ys = (xs**2).astype(np.float32)

    class Squares:
        def __len__(self):
            return N

        def __getitem__(self, i):
            return xs[i], ys[i]

    return fm.DistributedDataLoader(fm.DistributedDataContainer(Squares()),
                                    global_batch_size=64, shuffle=True)


def train(model, loader, epochs, optimizer=None):
    """Train ``model`` for ``epochs`` epochs: ``(state, losses)``, every
    update's loss."""
    optimizer = optimizer or optim.adam(3e-3)

    def loss_fn(params, model_state, batch):
        x, y = batch
        pred = torch.func.functional_call(model, params, (x,))
        return ((pred - y) ** 2).mean(), model_state

    step = make_train_step(loss_fn, optimizer, mesh=fm.global_mesh(), style="auto")
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer),
                      fm.global_mesh())
    losses = []
    for _ in range(epochs):
        for batch in loader:
            state, loss = step(state, batch)
            losses.append(loss)
    return state, [float(loss) for loss in losses]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--epochs", type=int, default=30)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    fm.fluxmpi_println(f"workers: {fm.total_workers()}")
    # Rank-divergent init (each rank seeds differently), then synchronize
    # erases the divergence from the root rank.
    model = fm.synchronize(MLP(device=device, generator=torch.Generator().manual_seed(
        fm.local_rank() + 1234)))
    t0 = time.time()
    state, losses = train(model, squares_loader(), args.epochs)
    loss = losses[-1]
    fm.fluxmpi_println(f"final loss {loss:.5f} after {args.epochs} epochs "
                       f"({time.time() - t0:.1f}s)")
    test_x = torch.tensor([[0.5], [1.0], [-1.5]], device=device)
    pred = torch.func.functional_call(model, state.params, (test_x,)).detach().cpu()
    fm.fluxmpi_println(f"f(0.5)={float(pred[0, 0]):.3f} f(1)={float(pred[1, 0]):.3f} "
                       f"f(-1.5)={float(pred[2, 0]):.3f}")
    if loss > 0.05:
        sys.exit("quickstart failed to converge")
    print("QUICKSTART_OK")


if __name__ == "__main__":
    main()
