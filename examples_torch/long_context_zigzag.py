"""Long-context training with zigzag ring attention over the flash kernels.

The port of ``examples/long_context_zigzag.py``: a causal LM whose
attention runs as the balanced zigzag ring over the ``sp`` axis of a
``dp`` x ``sp`` mesh, with the hand-written flash kernels as each block's
attend (their plain versions under ``--cpu``), checkpointed with
``CheckpointManager``. As in the JAX example, each worker runs the LM on
its block of the zigzag-permuted sequence, with the block's own
positions, and the loss is the next-token cross-entropy of the whole
sequence in its original order. One process per worker, started by
:mod:`fluxmpi_tpu_torch.launch`.

Run:  python examples_torch/long_context_zigzag.py [--cpu] [--dp 2] [--sp 4]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import launch, optim
from fluxmpi_tpu_torch.models import TransformerLM
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.ring import zigzag_indices, zigzag_ring_attention
from fluxmpi_tpu_torch.parallel.sharding import P
from fluxmpi_tpu_torch.parallel.train import shard_batch
from fluxmpi_tpu_torch.utils import CheckpointManager

VOCAB, SEQ, BATCH = 256, 128, 4
LM = dict(vocab_size=VOCAB, max_len=SEQ, num_layers=2, d_model=64, num_heads=4, d_ff=128)


def zigzag_lm(device, **kw):
    """The LM with its attention as the zigzag ring over ``sp``, on the
    kernels (the JAX example's ``attention_fn``; the mask is the ring's)."""
    def attend(q, k, v, bias=None, mask=None, **_):
        return zigzag_ring_attention(q, k, v, axis_name="sp", use_flash=True)

    return TransformerLM(**kw, attention_fn=attend, device=device,
                         generator=torch.Generator().manual_seed(fm.local_rank()))


def zigzag_batch(tokens, sp):
    """``(tokens, targets)`` of a host batch ``[b, s]`` in the zigzag
    order: each position's target is the next token of the original order
    (-1 past the end), so the loss needs no inverse permutation."""
    idxs = zigzag_indices(tokens.shape[1], sp)
    last = np.full((tokens.shape[0], 1), -1, tokens.dtype)
    targets = np.concatenate([tokens[:, 1:], last], axis=1)
    return tokens[:, idxs], targets[:, idxs]


def make_loss(model, n_targets, world):
    """The whole batch's mean next-token CE: this worker's block summed,
    scaled so that the step's mean over the ``world`` workers is the
    mean over all ``n_targets`` targets."""
    def loss_fn(p, mstate, batch):
        tokens, targets = batch
        logits = torch.func.functional_call(model, p, (tokens,), {"train": False})
        ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(), ignore_index=-1, reduction="sum")
        return ce * (world / n_targets), mstate

    return loss_fn


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--sp", type=int, default=4)
    args = parser.parse_args()
    status = launch.spawn(args.dp * args.sp, cpu=args.cpu)
    if status is not None:
        sys.exit(status)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("CUDA is not available (pass --cpu to run on the CPU)")

    # dp for the batch, sp for the sequence: one mesh, two axes.
    device = fm.init(device="cpu" if args.cpu else None,
                     mesh_shape={"dp": args.dp, "sp": args.sp}, verbose=True)
    sp = fm.global_mesh().shape["sp"]
    model = zigzag_lm(device, **LM)
    # Rank-divergent init, then every worker takes rank 0's weights.
    params = dict(fm.synchronize(model).named_parameters())
    rng = np.random.default_rng(0)
    rng.integers(0, VOCAB, size=(2, SEQ))  # the JAX example's init sample
    opt = optim.adam(1e-3)
    step = make_train_step(make_loss(model, BATCH * (SEQ - 1), fm.total_workers()), opt)
    state = TrainState.create(params, opt)
    tokens = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    # Zigzag once, train many; each worker keeps its block of the batch.
    batch = shard_batch(zigzag_batch(tokens, sp), spec=P("dp", "sp"))

    # One directory for every worker: rank 0's, sent to the others.
    path = np.zeros(1024, np.uint8)
    if fm.local_rank() == 0:
        made = os.path.join(tempfile.mkdtemp(), "zigzag_run").encode()
        path[:len(made)] = np.frombuffer(made, np.uint8)
    ckpt_dir = bytes(fm.host_bcast(path)).rstrip(b"\0").decode()
    losses = []
    with CheckpointManager(ckpt_dir, max_to_keep=2) as mgr:
        for i in range(10):
            state, loss = step(state, batch)
            losses.append(float(loss))
            if (i + 1) % 5 == 0:
                mgr.save(i + 1, state)
        mgr.wait_until_finished()
        assert mgr.latest_step() == 10
    fm.fluxmpi_println(
        f"zigzag LM: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
        f"{len(losses)} steps (sp={sp}, seq={SEQ})")
    assert losses[-1] < losses[0]
    rank = fm.local_rank()
    fm.shutdown()
    if rank == 0:
        print("LONG_CONTEXT_ZIGZAG_OK")


if __name__ == "__main__":
    main()
