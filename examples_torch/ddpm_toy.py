"""Toy DDPM: train the UNet on synthetic 8x8 two-tone blobs and draw DDIM
samples — the generative-vision walkthrough of the zoo.

The port of ``examples/ddpm_toy.py``: ``DistributedDataLoader`` feeding,
a per-step random stream that is the same on every data-parallel worker
and fresh every step, EMA weights, and DDIM sampling from them. Runs on
the card, or on the CPU with ``--cpu``.

Run:  python examples_torch/ddpm_toy.py [--cpu] [--steps 160]
"""

import argparse

import numpy as np
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import UNet, cosine_beta_schedule, ddim_sample, ddpm_loss
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate
from fluxmpi_tpu_torch.utils import ema_init, ema_params, ema_update


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--steps", type=int, default=160)
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    # Data: 8x8 images, a bright 4x4 quadrant on a dark field, in [-1, 1].
    rng = np.random.default_rng(0)
    n = 512
    xs = -np.ones((n, 8, 8, 1), np.float32)
    qi = rng.integers(0, 2, size=(n, 2))
    for img, (r, c) in zip(xs, qi):
        img[4 * r:4 * r + 4, 4 * c:4 * c + 4, 0] = 1.0
    xs += rng.normal(scale=0.05, size=xs.shape).astype(np.float32)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset({"x": xs})),
        global_batch_size=64, shuffle=True)

    model = UNet(out_channels=1, base_channels=8, channel_mults=(1, 2),
                 blocks_per_stage=1, attn_resolutions=(4,), num_heads=2, groups=4,
                 in_features=1, image_size=8, device=device,
                 generator=torch.Generator().manual_seed(fm.local_rank()))
    betas = cosine_beta_schedule(100, device=device)
    model = fm.synchronize(model)
    optimizer = optim.adam(2e-3)
    counter = [0]

    def loss_fn(p, _ms, batch):
        # Seed a stream from the host step counter: the same on every
        # data-parallel worker, fresh every step.
        step_rng = torch.Generator(device=device).manual_seed(42 + counter[0])
        return ddpm_loss(model, p, batch["x"], step_rng, betas), None

    step = make_train_step(loss_fn, optimizer, mesh=fm.global_mesh())
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer, None),
                      fm.global_mesh())
    # Short toy run; production diffusion uses 0.999+.
    ema = ema_init(state.params, decay=0.95)
    first = last = None
    while counter[0] < args.steps:
        for batch in loader:
            if counter[0] >= args.steps:
                break
            state, loss = step(state, batch)
            ema = ema_update(ema, state.params)
            if first is None:
                first = float(loss)
            last = loss
            counter[0] += 1
    last = float(last)
    fm.fluxmpi_println(f"ddpm loss: {first:.3f} -> {last:.3f} ({counter[0]} steps)")
    assert last < first * 0.7, (first, last)
    samples = ddim_sample(model, ema_params(ema), torch.Generator(device=device).manual_seed(1),
                          shape=(4, 8, 8, 1), betas=betas, num_steps=20)
    samples = samples.detach().cpu().numpy()
    assert np.isfinite(samples).all()
    # The sampler clips its x0 estimate to the data range, so even this
    # briefly-trained model lands in [-1, 1].
    assert np.abs(samples).max() <= 1.0 + 1e-5, samples.max()
    fm.fluxmpi_println(f"samples: mean |x| {np.abs(samples).mean():.2f}, "
                       f"range [{samples.min():.2f}, {samples.max():.2f}]")
    print("DDPM_TOY_OK")


if __name__ == "__main__":
    main()
