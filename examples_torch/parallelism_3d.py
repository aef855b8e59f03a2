"""3-D parallel training: data, sequence and tensor parallelism on one
mesh, plus an expert-parallel MoE variant and a pipeline stage demo.

The port of ``examples/parallelism_3d.py``, the full named-axis surface
in one script, one process per worker (started by
:mod:`fluxmpi_tpu_torch.launch`; ``4 x dp`` of them):

- ``dp`` x ``sp`` x ``tp`` (``ParallelConfig(dp=2, sp=2, tp=2)``): the
  batch over dp, the sequence over sp (each tp worker's heads attend as a
  ring over the sp group), Megatron column/row tensor parallelism over tp,
  and a ``rules=`` row that shards the one big leaf the tp table leaves
  replicated (``pos_embed``) over dp; ``remat=True``;
- ``dp`` x ``ep``: the MoE LM with its experts over ``ep`` (a second
  mesh: ``shutdown()``, then ``init(mesh_shape=...)`` again);
- ``pp``: a 4-stage GPipe schedule (a third mesh, ``dp`` x ``pp``, after
  another ``shutdown()``: the JAX example runs it on 4 of its devices,
  here each dp row of workers runs the same pipeline).

``--dp 1`` runs the same script on four workers. On the card, or on the
CPU with ``--cpu``.

Run:  python examples_torch/parallelism_3d.py [--cpu] [--dp 2] [--steps 10]
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import launch, optim, runtime
from fluxmpi_tpu_torch.models import (MoETransformerLM, TransformerLM, collect_moe_losses,
                                      expert_parallel_rules)
from fluxmpi_tpu_torch.parallel import (TrainState, combine_rules, fsdp_rule,
                                        make_train_step, shard_tree)
from fluxmpi_tpu_torch.parallel.pipeline import make_pipeline_fn, stack_stage_params
from fluxmpi_tpu_torch.parallel.sharding import P
from fluxmpi_tpu_torch.parallel.train import shard_batch


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    status = launch.spawn(4 * args.dp, cpu=args.cpu)
    if status is not None:
        sys.exit(status)
    device = "cpu" if args.cpu else None

    # ------------------------------------------------------------ dp x sp x tp
    # ONE declarative plan: the mesh, the Megatron tp rule table, the batch
    # spec (batch over dp, sequence over sp) and the axis names. The rules=
    # table, layered ahead of the tp rules, shards the position table over
    # dp, the one big leaf the tp table leaves replicated.
    dev = fm.init(parallel=fm.ParallelConfig(dp=args.dp, sp=2, tp=2,
                                             rules=[(r"pos_embed", P("dp", None))]),
                  device=device, verbose=True)
    plan = fm.global_plan()
    model = TransformerLM(vocab_size=256, max_len=64, num_layers=2, d_model=64,
                          num_heads=4, d_ff=128, device=dev,
                          generator=torch.Generator().manual_seed(0))
    model = fm.synchronize(model)
    opt = optim.adamw(3e-3)
    # The plan's rule engine lays out the parameters and the optimizer
    # state, and banks the layout for make_train_step(parallel=).
    state, _ = plan.shard_state(TrainState.create(dict(model.named_parameters()), opt))

    def lm_loss(p, mstate, batch):
        x, y = batch
        logits = torch.func.functional_call(model, p, (x,), {"train": False})
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               y.reshape(-1).long()), mstate

    step = make_train_step(lm_loss, opt, parallel=plan, remat=True)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(8, 33)).astype(np.int32)
    batch = shard_batch((data[:, :32], data[:, 1:]), plan.mesh, spec=plan.batch_spec)
    for _ in range(args.steps):
        state, loss = step(state, batch)
    fm.fluxmpi_println(f"dp×sp×tp TransformerLM: loss {float(loss):.4f}")

    # --------------------------------------------------------------- dp x ep
    runtime.shutdown()
    dev = fm.init(mesh_shape={"dp": args.dp, "ep": 4}, device=device)
    mesh_ep = runtime.global_mesh()
    moe = MoETransformerLM(vocab_size=256, max_len=64, num_layers=2, d_model=64,
                           num_heads=4, d_ff=128, num_experts=4, mesh=mesh_ep, device=dev,
                           generator=torch.Generator().manual_seed(1))
    rule_ep = combine_rules(expert_parallel_rules(), fsdp_rule(mesh_ep, min_size=1024))
    state_ep, sh_ep = shard_tree(TrainState.create(dict(moe.named_parameters()), opt),
                                 mesh_ep, rule_ep)

    def moe_loss(p, mstate, b):
        x, y = b
        losses = {}
        logits = torch.func.functional_call(moe, p, (x,), {"train": True, "losses": losses})
        task = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               y.reshape(-1).long())
        aux, zl = collect_moe_losses(losses)
        return task + 0.01 * aux + 1e-3 * zl, mstate

    step_ep = make_train_step(moe_loss, opt, mesh=mesh_ep, state_sharding=sh_ep,
                              batch_spec=P("dp"))
    batch_ep = shard_batch((data[:, :32], data[:, 1:]), mesh_ep, spec=P("dp"))
    for _ in range(args.steps):
        state_ep, loss_ep = step_ep(state_ep, batch_ep)
    fm.fluxmpi_println(f"dp×ep MoE LM:           loss {float(loss_ep):.4f}")

    # ------------------------------------------------------------- pp stages
    runtime.shutdown()
    dev = fm.init(mesh_shape={"dp": args.dp, "pp": 4}, device=device)
    mesh_pp = runtime.global_mesh()

    def stage_fn(p, h):
        return F.gelu(h @ p["w"] + p["b"], approximate="tanh")

    d_h = 32
    stacked = stack_stage_params([
        {"w": torch.as_tensor(rng.normal(scale=0.4, size=(d_h, d_h)), dtype=torch.float32,
                              device=dev),
         "b": torch.zeros((d_h,), device=dev)}
        for _ in range(4)])
    pipe = make_pipeline_fn(stage_fn, mesh_pp, n_microbatches=4)
    y = pipe(stacked, torch.ones((8, d_h), device=dev))
    fm.fluxmpi_println(f"pp GPipe 4 stages:      out norm {float(torch.linalg.norm(y)):.4f}")
    rank = fm.local_rank()
    fm.shutdown()
    if rank == 0:
        print("PARALLELISM_3D_OK")


if __name__ == "__main__":
    main()
