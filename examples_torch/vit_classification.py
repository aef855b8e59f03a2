"""End-to-end user journey: ViT image classification under data
parallelism.

The port of ``examples/vit_classification.py``: bring-up, a rank-divergent
init erased by ``synchronize``, the prefetching data loader, one train
step, rank-aware logging, and checkpoints through ``CheckpointManager``.
Runs on the card, or on the CPU with ``--cpu``.

Run:  python examples_torch/vit_classification.py [--cpu] [--epochs 4]
"""

import argparse
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import ViT
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate
from fluxmpi_tpu_torch.utils import CheckpointManager


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch", type=int, default=32)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    # Tiny synthetic dataset: 4-class 32x32 images whose class is encoded
    # in the mean brightness of a quadrant.
    rng = np.random.default_rng(0)
    n, classes = 512, 4
    xs = rng.normal(scale=0.3, size=(n, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, classes, size=(n,)).astype(np.int32)
    for i in range(n):
        q = ys[i]
        xs[i, (q // 2) * 16:(q // 2) * 16 + 16, (q % 2) * 16:(q % 2) * 16 + 16] += 1.0

    model = ViT(num_classes=classes, patch=8, num_layers=2, d_model=64, num_heads=4,
                d_ff=128, image_size=32, device=device,
                generator=torch.Generator().manual_seed(fm.local_rank()))
    # Rank-divergent init (each process its own seed), then root wins.
    model = fm.synchronize(model)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((xs, ys))),
        global_batch_size=args.batch, shuffle=True)
    optimizer = optim.adamw(1e-3)

    def loss_fn(p, mstate, batch):
        bx, by = batch
        logits = torch.func.functional_call(model, p, (bx,), {"train": True})
        return F.cross_entropy(logits, by.long()), mstate

    step = make_train_step(loss_fn, optimizer, mesh=fm.global_mesh())
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer),
                      fm.global_mesh())
    ckpt_dir = tempfile.mkdtemp(prefix="fluxmpi_vit_")
    manager = CheckpointManager(ckpt_dir, max_to_keep=2)
    first = last = None
    for epoch in range(args.epochs):
        # Epoch-mean losses: one shuffled batch's loss is too noisy to
        # witness learning over a 2-epoch smoke run.
        total = nsteps = 0
        for batch in loader:
            state, loss = step(state, batch)
            total, nsteps = total + loss.detach(), nsteps + 1
        last = float(total) / nsteps
        first = first if first is not None else last
        fm.fluxmpi_println(f"epoch {epoch}: loss {last:.4f}")
        manager.save(epoch, state)
    manager.wait_until_finished()
    assert manager.latest_step() == args.epochs - 1
    fm.fluxmpi_println(f"loss {first:.4f} -> {last:.4f}; checkpoints in {ckpt_dir}")
    assert last < first, "training did not reduce the loss"
    print("VIT_EXAMPLE_OK")


if __name__ == "__main__":
    main()
