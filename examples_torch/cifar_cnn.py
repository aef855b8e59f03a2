"""CNN + BatchNorm on synthetic CIFAR-shaped data (BASELINE config 2).

The port of ``examples/cifar_cnn.py``: an array dataset served by the C++
gather/prefetch pipeline, BatchNorm statistics synchronized at init and
carried through the step as its model state, and a checkpoint
round-trip mid-training. Runs on the card, or on the CPU with ``--cpu``.

Run:  python examples_torch/cifar_cnn.py [--cpu] [--epochs 4]
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import CNN
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate
from fluxmpi_tpu_torch.utils import restore_checkpoint, save_checkpoint


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    rng = np.random.default_rng(0)
    n = 512
    xs = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    ys = (xs.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset({"x": xs, "y": ys})),
        global_batch_size=64, shuffle=True)

    model = CNN(num_classes=2, device=device,
                generator=torch.Generator().manual_seed(fm.local_rank()))
    # Rank-divergent init, then every worker takes rank 0's weights and
    # BatchNorm statistics.
    model = fm.synchronize(model)
    batch_stats = fm.synchronize(model.init_batch_stats())
    optimizer = optim.adam(1e-3)

    def loss_fn(params, batch_stats, batch):
        logits, new_stats = torch.func.functional_call(
            model, params, (batch["x"], batch_stats), {"train": True})
        return F.cross_entropy(logits, batch["y"].long()), new_stats

    step = make_train_step(loss_fn, optimizer)
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer,
                                        batch_stats))
    loss = None
    for epoch in range(args.epochs):
        for batch in loader:
            state, loss = step(state, batch)
        fm.fluxmpi_println(f"epoch {epoch}: loss {float(loss):.4f}")

    ckpt = os.path.join(tempfile.mkdtemp(), "ckpt")
    save_checkpoint(ckpt, state)
    state = restore_checkpoint(ckpt, state)
    fm.fluxmpi_println(f"checkpoint round-trip OK at step {int(state.step)}")
    print("CIFAR_CNN_OK")


if __name__ == "__main__":
    main()
