"""Long-context Transformer training with ring attention: sequence
parallelism over an ``sp`` mesh axis composed with data parallelism.

The port of ``examples/transformer_ring.py``: a ``TransformerEncoder``
whose attention is a causal ring over ``sp``
(``ring_attention_fn(axis_name="sp", causal=True)``), each worker holding
its block of the batch and of the sequence, the loss and gradients
averaged over the mesh. One process per worker (``dp`` x ``sp`` of them),
started by :mod:`fluxmpi_tpu_torch.launch`; on the card, or on the CPU
with ``--cpu``.

Run:  python examples_torch/transformer_ring.py [--cpu] [--dp 2] [--sp 4]
"""

import argparse
import sys

import numpy as np
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import launch, optim
from fluxmpi_tpu_torch.models import TransformerEncoder
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.ring import ring_attention_fn
from fluxmpi_tpu_torch.parallel.sharding import P
from fluxmpi_tpu_torch.parallel.train import shard_batch


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--sp", type=int, default=4)
    args = parser.parse_args()
    status = launch.spawn(args.dp * args.sp, cpu=args.cpu)
    if status is not None:
        sys.exit(status)

    device = fm.init(device="cpu" if args.cpu else None,
                     mesh_shape={"dp": args.dp, "sp": args.sp})
    fm.fluxmpi_println(f"mesh: {fm.global_mesh().shape}")
    kwargs = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128)
    model = TransformerEncoder(**kwargs, attention_fn=ring_attention_fn(axis_name="sp",
                                                                        causal=True),
                               device=device, generator=torch.Generator().manual_seed(0))
    model = fm.synchronize(model)
    rng = np.random.default_rng(0)
    b, s = 4, 256
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    y = rng.normal(size=(b, s, 64)).astype(np.float32)
    optimizer = optim.adam(1e-3)

    def loss_fn(params, ms, batch):
        bx, by = batch
        out = torch.func.functional_call(model, params, (bx,), {"train": False})
        return ((out - by) ** 2).mean(), ms

    # Each worker its block of the batch (dp) and of the sequence (sp);
    # the step averages the loss and the gradients over every worker.
    step = make_train_step(loss_fn, optimizer)
    state = TrainState.create(dict(model.named_parameters()), optimizer)
    batch = shard_batch((x, y), spec=P("dp", "sp"))
    losses = []
    for _ in range(args.steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    fm.fluxmpi_println(f"ring-attention training: {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    rank = fm.local_rank()
    fm.shutdown()
    if rank == 0:
        print("TRANSFORMER_RING_OK")


if __name__ == "__main__":
    main()
