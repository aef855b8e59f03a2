"""One rank of the sequence- and pipeline-parallel tests' gloo worlds (run
by ``tests/test_torch_ring.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_sequence_step.py``, ``tests/test_torch_sp_tp.py`` and
``tests/test_torch_surface_c19_c20.py``): ``python _torch_seq_worker.py
GROUP RANK WORLD STORE OUT DATA``. ``GROUP`` is ``ring``, ``pipeline``,
``step``, ``surface`` or ``zigzag``; ``DATA`` is an npz the test writes (the global inputs, the flax
weights, and ``cases``: the JSON table of this world's cases). Runs every
case of the group in this world and writes this rank's results to ``OUT``
(an npz keyed ``case/name``)."""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
group, rank, world, store_path, out, data_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)

import fluxmpi_tpu_torch as fm  # noqa: E402
from fluxmpi_tpu_torch import _sequence_parallel as _sp  # noqa: E402
from fluxmpi_tpu_torch import optim  # noqa: E402
from fluxmpi_tpu_torch.parallel.sharding import Mesh  # noqa: E402

D = dict(np.load(data_path))
CASES = json.loads(str(D.pop("cases")))
res = {}


def t(name, grad=False):
    x = torch.from_numpy(D[name])
    return x.requires_grad_() if grad else x


def put(prefix, **arrays):
    for k, v in arrays.items():
        res[f"{prefix}/{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v)


def catch(prefix, fn):
    """Run ``fn``; record the type and message of what it raised."""
    try:
        fn()
        res[f"{prefix}/raised"] = np.array("")
    except Exception as exc:  # noqa: BLE001 - the test reads the type and message
        res[f"{prefix}/raised"] = np.array(f"{type(exc).__name__}: {exc}")


def ring_group():
    from fluxmpi_tpu_torch.models import TransformerEncoder, load_flax_params
    from fluxmpi_tpu_torch.parallel import (make_ring_attention, make_ulysses_attention,
                                            ring_attention_fn, ulysses_attention)
    from fluxmpi_tpu_torch.parallel.ring import _ring_flash, _rotation, _zigzag

    fm.init(device="cpu", mesh_shape={"sp": world})
    mesh = Mesh(np.arange(world), ("sp",))
    for case, spec in CASES.items():
        kind, kw = spec["kind"], dict(spec["kw"])
        if kind == "lse":
            # The merged lse of this worker's schedule (the ring's own
            # exchanges) beside the whole-sequence lse.
            ctx = _sp.SequenceParallel(mesh, "sp")
            axis = ctx.axis("sp")
            q, k, v = (t(n).chunk(world, 1)[rank] for n in ("q", "k", "v"))
            if kw.pop("zigzag", False):
                idx = torch.as_tensor(D["zigzag_idx"])
                q, k, v = (t(n)[:, idx].chunk(world, 1)[rank] for n in ("q", "k", "v"))
                _, rotate = _rotation(axis, (q, k, v))
                _, lse = _zigzag(q, k, v, n=world, idx=rank, qseg=None, kseg=None,
                                 use_flash=True, rotate=rotate)
            else:
                _, rotate = _rotation(axis, (q, k, v))
                _, lse = _ring_flash(q, k, v, n=world, idx=rank, qseg=None, kseg=None,
                                     rotate=rotate, **kw)
            put(case, lse=lse)
            continue
        if kind == "encoder":
            flat = {k_[len("enc/"):]: v_ for k_, v_ in D.items() if k_.startswith("enc/")}
            model = TransformerEncoder(num_layers=2, d_model=32, num_heads=4, d_ff=64,
                                       attention_fn=ring_attention_fn(**kw), device="cpu")
            load_flax_params(model, flat)
            x = t("enc_x").chunk(world, 1)[rank]
            put(case, out=model(x, train=False))
            continue
        qkv = spec.get("qkv", "")
        q, k, v = (t(n + qkv, grad=True) for n in ("q", "k", "v"))
        seg = t("seg") if spec.get("seg") else None
        seed = kw.pop("dropout_seed", None)
        if kind == "ulysses_blocks":
            # ulysses_attention on this worker's blocks, the axis bound by
            # the runtime's mesh; each rank's loss is its block's, so the
            # gradients of the global inputs sum over the ranks.
            blocks = [x.chunk(world, 1)[rank] for x in (q, k, v, seg)]
            o = ulysses_attention(*blocks[:3], axis_name="sp", segment_ids=blocks[3], **kw)
            loss = (o * t("cot").chunk(world, 1)[rank]).sum()
            grads = torch.autograd.grad(loss, [q, k, v])
            parts = [torch.empty_like(o) for _ in range(world)]
            dist.all_gather(parts, o.detach().contiguous())
            for g in grads:
                dist.all_reduce(g)
            put(case, out=torch.cat(parts, 1), dq=grads[0], dk=grads[1], dv=grads[2])
            continue
        if kind == "ulysses":
            fn = make_ulysses_attention(mesh, axis_name="sp", **kw)

            def call():
                return fn(q, k, v, dropout_seed=seed)
        else:
            fn = make_ring_attention(mesh, axis_name="sp", **kw)

            def call():
                return fn(q, k, v, segment_ids=seg, dropout_seed=seed)
        if spec.get("refused"):
            catch(case, call)
            continue
        o = call()
        dq, dk, dv = torch.autograd.grad((o * t("cot")).sum(), [q, k, v])
        put(case, out=o, dq=dq, dk=dk, dv=dv)


def pipeline_group():
    from fluxmpi_tpu_torch.parallel import (make_pipeline_fn, pipeline_apply,
                                            stack_stage_params)

    fm.init(device="cpu", mesh_shape={"pp": world})

    def stage_fn(p, x):
        return torch.nn.functional.gelu(x @ p["w"] + p["b"], approximate="tanh")

    for case, spec in CASES.items():
        kw = dict(spec["kw"])
        x = t(spec["x"], grad=True)
        if spec["kind"] == "block":
            # EncoderBlock stages, the stacked flax block trees loaded as
            # they are.
            from fluxmpi_tpu_torch.models.transformer import EncoderBlock

            block = EncoderBlock(16, 2, 32, 0.0, torch.float32, device="cpu")
            stacked = {k[len("blk/"):].replace("/", "."): t(k).clone().requires_grad_()
                       for k in D if k.startswith("blk/")}

            def block_fn(p, h):
                return torch.func.functional_call(block, p, (h,), {"train": False})

            y = make_pipeline_fn(block_fn, n_microbatches=spec["m"], **kw)(stacked, x)
            names = sorted(stacked)
            grads = torch.autograd.grad(torch.sin(y).sum(), [stacked[k] for k in names] + [x])
            put(case, out=y, gx=grads[-1], **{f"g/{k}": g for k, g in zip(names, grads)})
            continue
        chunks = [{"w": t(f"{spec['stages']}_w")[i], "b": t(f"{spec['stages']}_b")[i]}
                  for i in range(D[f"{spec['stages']}_w"].shape[0])]
        stacked = stack_stage_params(chunks, n_stages=spec.get("n_stages"),
                                     interleave=kw.get("interleave", 1))
        stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        if spec["kind"] == "wrapper":
            fn = make_pipeline_fn(stage_fn, n_microbatches=spec["m"], **kw)
            y = fn(stacked, x)
            loss = torch.sin(y).sum()
            gw, gb, gx = torch.autograd.grad(loss, [stacked["w"], stacked["b"], x])
            put(case, out=y, gw=gw, gb=gb, gx=gx)
            continue
        # pipeline_apply on this worker's stage block, over a mesh bound by
        # the sequence-parallel context (as a step binds its plan's mesh).
        mesh = Mesh(np.arange(world).reshape(spec["mesh"]), spec["axes"])
        ctx = _sp.SequenceParallel(mesh)
        pp = ctx.axis("pp")
        local = {k: v.chunk(pp.size, 0)[pp.index] for k, v in stacked.items()}
        xin = x
        if kw.get("input_sharded"):
            block = mesh.block_index(rank, tuple(spec["axes"]))[0]
            xin = x.chunk(world, 0)[block]
        with _sp.active(ctx):
            y = pipeline_apply(stage_fn, local, xin, n_microbatches=spec["m"],
                               axis_name="pp", **kw)
        loss = torch.sin(y).sum()
        # A replicated input is read by stage 0 only.
        grads = torch.autograd.grad(loss, [stacked["w"], stacked["b"], x], allow_unused=True)
        gw, gb, gx = (torch.zeros_like(v) if g is None else g
                      for g, v in zip(grads, [stacked["w"], stacked["b"], x]))
        put(case, out=y, gw=gw, gb=gb, gx=gx)


def _dropout_runs(case, LM, lm_params, plan):
    """The dense LM at dropout 0.1 under ``plan`` (sp) and with no plan on
    the global batches, each with a dropout generator seeded alike."""
    from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader
    from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    data = {"x": D["tokens"], "y": D["targets"]}
    for name in ("sp", "none"):
        model = TransformerLM(**LM, dropout=0.1, attention="naive", device="cpu")
        load_flax_params(model, lm_params)
        gen = torch.Generator().manual_seed(11)

        def loss_fn(p, ms, batch, model=model, gen=gen):
            return torch.func.functional_call(model, p, (batch["x"],), {
                "targets": batch["y"], "dropout_rng": gen}).mean(), ms

        opt = optim.sgd(0.1)
        state = TrainState.create(dict(model.named_parameters()), opt)
        if name == "sp":
            step = make_train_step(loss_fn, opt, parallel=plan)
            batches = DistributedDataLoader(ArrayDataset(data), 8, mesh=plan.mesh,
                                            axis_name=plan.data_axes, device="cpu")
        else:
            step = make_train_step(loss_fn, opt)
            batches = [{k: torch.from_numpy(v[8 * b:8 * b + 8]) for k, v in data.items()}
                       for b in range(3)]
        losses = []
        for _, batch in zip(range(3), batches):
            state, loss = step(state, batch)
            losses.append(float(loss))
        res[f"{case}/{name}/losses"] = np.array(losses)
        put(f"{case}/{name}/param", **state.params)


def step_group():
    from fluxmpi_tpu_torch.data import ArrayDataset, DistributedDataLoader
    from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params
    from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState, make_pipeline_fn,
                                            make_train_step, pipeline_rules,
                                            ring_attention_fn, ulysses_attention_fn)
    from fluxmpi_tpu_torch.parallel.sharding import P

    fm.init(device="cpu")
    lm_params = {k[len("lm/"):]: v for k, v in D.items() if k.startswith("lm/")}
    moe_params = {k[len("moe/"):]: v for k, v in D.items() if k.startswith("moe/")}
    LM = dict(vocab_size=32, max_len=16, num_layers=2, d_model=16, num_heads=2, d_ff=32)
    from fluxmpi_tpu_torch.models._layers import dot_product_attention

    fns = {"ring_fn": lambda: ring_attention_fn(causal=True, use_flash=True),
           "ulysses_fn": lambda: ulysses_attention_fn(causal=True),
           "not_sp_fn": lambda: dot_product_attention,
           "dense_fn": lambda: None}

    def stage_fn(p, x):
        return torch.nn.functional.gelu(x @ p["w"] + p["b"], approximate="tanh")

    for case, spec in CASES.items():
        kw = dict(spec["plan"])
        if spec["kind"] == "pp":
            rule = pipeline_rules("pp")
            kw["rules"] = lambda path, shape: rule(path, shape) if "stages" in path else P()
        if spec["kind"] == "moe" and "ep" in kw:
            from fluxmpi_tpu_torch.models import expert_parallel_rules

            kw["rules"] = expert_parallel_rules()
        plan = ParallelConfig(**kw).resolve()
        if spec["kind"] == "dropout":
            _dropout_runs(case, LM, lm_params, plan)
            continue
        if spec["kind"] == "pp":
            w = spec["w"]
            params = {k: t(name).clone().requires_grad_() for k, name in (
                ("stages.w", f"{w}_w"), ("stages.b", f"{w}_b"), ("head", "pp_head"))}
            pipe = make_pipeline_fn(stage_fn, plan.mesh, n_microbatches=4, axis_name="pp",
                                    interleave=spec.get("interleave", 1))

            def loss_fn(p, ms, batch):
                y = pipe({"w": p["stages.w"], "b": p["stages.b"]}, batch["x"])
                return ((y @ p["head"] - batch["y"]) ** 2).mean(), ms

            data = {"x": D["pp_x"], "y": D["pp_y"]}
        else:
            attention_fn = fns[spec.get("fn", "dense_fn")]()
            if spec["kind"] == "moe":
                from fluxmpi_tpu_torch.models import MoETransformerLM

                model = MoETransformerLM(**LM, num_experts=4, **spec.get("moe", {}),
                                         mesh=plan.mesh if "ep" in spec["plan"] else None,
                                         attention=spec.get("attention", "naive"),
                                         device="cpu")
                load_flax_params(model, moe_params)
            else:
                model = TransformerLM(**LM, attention=spec.get("attention", "naive"),
                                      attention_fn=attention_fn, device="cpu")
                load_flax_params(model, lm_params)
            params = dict(model.named_parameters())
            reg = spec.get("penalty")

            def loss_fn(p, ms, batch, model=model, reg=reg, spec=spec):
                if spec.get("no_layer"):  # a loss that enters no sp-aware layer
                    return (p["embed.embedding"][batch["x"]] ** 2).mean(), ms
                if spec["kind"] == "moe":
                    from fluxmpi_tpu_torch.models import collect_moe_losses

                    sown = {}
                    ce = torch.func.functional_call(model, p, (batch["x"],), {
                        "targets": batch["y"], "losses": sown}).mean()
                    aux, z = collect_moe_losses(sown)
                    return ce + 0.1 * aux + 0.01 * z, ms
                ce = torch.func.functional_call(model, p, (batch["x"],),
                                                {"targets": batch["y"]}).mean()
                if reg == "all":
                    ce = ce + 0.1 * sum(torch.linalg.vector_norm(w) for w in p.values())
                elif reg is not None:
                    ce = ce + 0.1 * torch.linalg.vector_norm(p[reg])
                return ce, ms

            data = {"x": D["tokens"], "y": D["targets"]}
        opt = optim.sgd(0.1)
        state = TrainState.create(params, opt)
        if plan.shards_parameters:
            state, _ = plan.shard_state(state)
        remat = spec.get("remat", False)
        if spec.get("refused"):
            def run():
                step = make_train_step(loss_fn, opt, parallel=plan, remat=remat)
                loader = DistributedDataLoader(ArrayDataset(data), 8, mesh=plan.mesh,
                                               axis_name=plan.data_axes, device="cpu")
                step(state, next(iter(loader)))

            catch(case, run)
            continue
        step = make_train_step(loss_fn, opt, parallel=plan, remat=remat)
        loader = DistributedDataLoader(ArrayDataset(data), 8, mesh=plan.mesh,
                                       axis_name=plan.data_axes, device="cpu")
        losses = []
        for _, batch in zip(range(3), loader):
            if spec.get("shard_batch"):
                # Cut over sp by the plan's batch spec: the step gathers it
                # back (the pipeline replicates sp).
                from fluxmpi_tpu_torch.parallel.train import shard_batch

                batch = shard_batch({k: v.numpy() for k, v in batch.items()}, plan.mesh,
                                    spec=plan.batch_spec)
            state, loss = step(state, batch)
            losses.append(float(loss))
        res[f"{case}/losses"] = np.array(losses)
        put(f"{case}/param", **state.params)
        layout = step.__fluxmpi_layout__
        res[f"{case}/tp_blocks"] = np.array(sorted(layout.tp_blocks or ()), dtype=str)


def surface_group():
    """C.19 and C.20: ``shard_ranks``/``unshard_ranks`` and the laid-out
    collectives, ``replicate`` and ``shard_batch`` over the cases' meshes."""
    from fluxmpi_tpu_torch.parallel import ParallelConfig
    from fluxmpi_tpu_torch.parallel.sharding import P
    from fluxmpi_tpu_torch.parallel.train import replicate, shard_batch

    fm.init(device="cpu")
    for case, spec in CASES.items():
        if spec["kind"] == "ranks":
            x = fm.shard_ranks(D["stacked"])
            put(case, block=x, whole=fm.unshard_ranks(x),
                allreduce=fm.allreduce(x), bcast=fm.bcast(x, root=1),
                allreduce_whole=fm.unshard_ranks(fm.allreduce(x, op="max")),
                same=np.array(fm.shard_ranks(x) is x))
            catch(case, lambda: fm.shard_ranks(D["stacked"][:1]))
        elif spec["kind"] == "replicate":
            out = replicate({"a": D["stacked"], "b": {"c": D["batch"]}})
            put(case, a=out["a"], c=out["b"]["c"])
        elif spec["kind"] == "batch":
            if spec["spec"] == "plan":
                plan = ParallelConfig(**spec["plan"]).resolve()
                mesh, bspec = plan.mesh, plan.batch_spec
            else:
                mesh = Mesh(np.arange(world).reshape(spec["shape"]), spec["axes"])
                bspec = P(*spec["spec"]) if spec["spec"] else None
            out = shard_batch({"x": D["batch"], "y": D["batch"][..., 0]}, mesh, spec=bspec)
            put(case, x=out["x"], y=out["y"])
            catch(case, lambda: shard_batch(D["batch"], mesh, "dp", spec=P("dp")))


def zigzag_group():
    """The zigzag LM of ``examples_torch/long_context_zigzag.py`` over
    ``dp=1, sp=WORLD``: 3 updates of its loss from the flax weights."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples_torch"))
    import long_context_zigzag as ex
    from fluxmpi_tpu_torch.models import load_flax_params
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step
    from fluxmpi_tpu_torch.parallel.sharding import P
    from fluxmpi_tpu_torch.parallel.train import shard_batch

    fm.init(device="cpu", mesh_shape={"dp": 1, "sp": world})
    for case, spec in CASES.items():
        model = ex.zigzag_lm("cpu", **spec["lm"])
        load_flax_params(model, {k[len("lm/"):]: v for k, v in D.items()
                                 if k.startswith("lm/")})
        params = dict(model.named_parameters())
        opt = optim.sgd(0.1)
        b, s = D["zz_tokens"].shape[1:]
        step = make_train_step(ex.make_loss(model, b * (s - 1), world), opt)
        state = TrainState.create(params, opt)
        losses = []
        for toks in D["zz_tokens"]:
            batch = shard_batch(ex.zigzag_batch(toks, spec["sp"]), spec=P("dp", "sp"))
            state, loss = step(state, batch)
            losses.append(float(loss))
        res[f"{case}/losses"] = np.array(losses)
        put(f"{case}/param", **state.params)


{"ring": ring_group, "pipeline": pipeline_group, "step": step_group,
 "surface": surface_group, "zigzag": zigzag_group}[group]()
np.savez(out, **res)
fm.shutdown()
# No rank tears its group down while a peer's last collective is in flight
# with it.
dist.barrier()
dist.destroy_process_group()
