"""LM pretraining: the performance surface of the LM path composed end to
end.

The port of ``examples/lm_pretrain.py``, every throughput feature of the
LM path together:

- attention in the hand-written flash kernels
  (``flash_attention_fn(causal=True)``: the forward, dQ and dK/dV
  kernels on the card, their plain versions under ``--cpu``);
- the chunked fused unembed + cross-entropy head
  (``TransformerLM(..., targets=...)``): the ``[tokens, vocab]`` logits
  are never materialized;
- multi-update dispatch: ``make_train_step(scan_steps=K)`` fed by
  ``fm.scan_batches(loader, K)``;
- the distributed loader with per-epoch shuffling;
- async checkpoints with ``CheckpointManager`` keep-k and a restore;
- KV-cache generation from the restored weights, through the forward
  kernel's decode row: the corpus follows ``t -> 3t+1 (mod V)``, so
  greedy decoding must reproduce the arithmetic.

Run:  python examples_torch/lm_pretrain.py [--cpu] [--epochs 14] [--scan 2]
"""

import argparse
import tempfile

import numpy as np
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.models import TransformerLM, generate
from fluxmpi_tpu_torch.ops import flash_attention_fn
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
from fluxmpi_tpu_torch.parallel.train import replicate
from fluxmpi_tpu_torch.utils import CheckpointManager

VOCAB, SEQ = 128, 32
LM = dict(vocab_size=VOCAB, max_len=SEQ, num_layers=2, d_model=32, num_heads=4, d_ff=64)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--epochs", type=int, default=14)
    parser.add_argument("--scan", type=int, default=2, help="optimizer updates per dispatch")
    args = parser.parse_args()

    device = fm.init(device="cpu" if args.cpu else None, verbose=True)
    model = TransformerLM(**LM, attention_fn=flash_attention_fn(causal=True), device=device,
                          generator=torch.Generator().manual_seed(fm.local_rank()))
    # Synthetic corpus with learnable structure (next token = 3*t+1 mod V).
    rng = np.random.default_rng(0)
    starts = rng.integers(0, VOCAB, size=(512, 1))
    seqs = [starts]
    for _ in range(SEQ):
        seqs.append((seqs[-1] * 3 + 1) % VOCAB)
    corpus = np.concatenate(seqs, axis=1).astype(np.int32)  # [512, SEQ+1]
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=64, shuffle=True)
    model = fm.synchronize(model)
    optimizer = optim.adamw(5e-3)

    def loss_fn(p, ms, batch):
        tokens, targets = batch
        # Fused head: per-token losses straight from the hidden states.
        return torch.func.functional_call(
            model, p, (tokens,), {"train": False, "targets": targets, "loss_chunk": 64}
        ).mean(), ms

    step = make_train_step(loss_fn, optimizer, scan_steps=args.scan)
    state = replicate(TrainState.create(dict(model.named_parameters()), optimizer))
    ckpt_dir = tempfile.mkdtemp(prefix="fluxmpi_lm_")
    manager = CheckpointManager(ckpt_dir, max_to_keep=2)
    first = last = None
    for epoch in range(args.epochs):
        for batch in fm.scan_batches(loader, args.scan):
            state, losses = step(state, batch)
        last = float(losses[-1])
        if first is None:
            first = float(losses[0])
        manager.save(epoch, state)
        fm.fluxmpi_println(f"epoch {epoch}: loss {last:.4f}")
    manager.wait_until_finished()
    assert manager.latest_step() == args.epochs - 1
    step_restored, restored = manager.restore(state)
    assert step_restored == args.epochs - 1
    assert int(restored.step) == int(state.step)
    assert last < first / 4, (first, last)
    print(f"loss {first:.4f} -> {last:.4f} over {args.epochs} epochs "
          f"(scan_steps={args.scan})")

    # Generate from the restored weights: a model whose attention is the
    # flash kernels (prefill and the KV-cache decode rows), the trained
    # weights loaded into it.
    decoder = TransformerLM(**LM, attention="flash", device=device)
    decoder.load_state_dict({k: v.detach() for k, v in restored.params.items()})
    start = 7
    prompt = torch.tensor([[start, (start * 3 + 1) % VOCAB]], device=device)
    with torch.no_grad():
        out = generate(decoder, prompt, 6)[0].tolist()
    expect = [start]
    for _ in range(7):
        expect.append((expect[-1] * 3 + 1) % VOCAB)
    correct = sum(int(a == b) for a, b in zip(out, expect))
    print(f"generate: {out} (rule: {expect}) — {correct}/8 positions follow the "
          f"learned arithmetic")
    assert correct >= 6, (out, expect)
    print("LM_PRETRAIN_OK")


if __name__ == "__main__":
    main()
