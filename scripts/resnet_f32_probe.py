#!/usr/bin/env python3
"""Where the card's f32 ResNet-50 gradients part from an f64 reference.

    python3 scripts/resnet_f32_probe.py [--out chiprun_out/resnet_f32_probe.json]

On one CUDA card: ResNet-50 (``fluxmpi_tpu_torch.models.ResNet50``, f32,
1000 classes) with the seeded weights moved off their init (every
parameter plus ``0.1 * N(0, 1)``, so no BatchNorm scale is zero and every
residual branch is live), a batch of 4 of ``chip_smoke.image_corpus``'s
224 x 224 images, one training forward and backward. Each variant below is
held per leaf (logits, loss, every gradient, the new statistics) against
the same pass in f64 on the CPU, as ``max|diff| / max|ref|``, beside the
CPU's own f32 pass:

- ``card``: cuDNN with the legacy ``allow_tf32 = False`` flags;
- ``card_ieee``: also ``fp32_precision = "ieee"`` on cuDNN's convolutions
  and cuBLAS's matmuls, where this PyTorch has that setting;
- ``card_tf32``: TF32 allowed, to show what TF32 does to the same leaves;
- ``card_deterministic``, ``card_benchmark``: cuDNN's deterministic
  algorithms, or the fastest measured;
- ``card_nchw``: the convolutions on contiguous NCHW tensors instead of
  ``channels_last``;
- ``card_no_cudnn``: cuDNN disabled (PyTorch's own convolutions);
- ``card_tf32_override_0``: a child process with ``NVIDIA_TF32_OVERRIDE=0``,
  which stops cuDNN and cuBLAS from using TF32 whatever the flags say.

Then three weight sets: ``live_init`` (the seeded weights with every
BatchNorm scale 1), ``perturbed`` (as above) and ``trained`` (after
chip_smoke's 32 bf16 updates): the whole model on the CPU and on the card,
each in ``channels_last`` and in NCHW, against f64; and every layer alone
(``chip_smoke.resnet_layers``: each fed its input and output gradient
from the f64 pass) on the CPU and on the card, with TF32 off, in NCHW, and
with TF32 on; and where the whole model's f32 pass parts from f64, layer by
layer (``propagation``).

Then the worst leaf's layer alone: its input and its output's gradient,
taken from the f64 pass, go through ``convolution_backward`` on the card in
f32 under the same settings, with the sum's conditioning
``sum|x||dy| / max|g|``. Prints one line per variant and writes the whole
table to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DEVICE = "cuda:0"  # the card; a rehearsal on the CPU sets "cpu"


def perturbed_params():
    import torch

    from fluxmpi_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    params = {k: (p.detach() + 0.1 * torch.randn(p.shape, generator=gen))
              for k, p in model.named_parameters()}
    return params, model.init_batch_stats()


def batch():
    import torch

    import chip_smoke

    x, y = chip_smoke.image_corpus(16, chip_smoke.RESNET_HW, chip_smoke.RESNET_CLASSES)
    return torch.from_numpy(x[:4]), torch.from_numpy(y[:4])


@contextlib.contextmanager
def settings(name):
    """The backend flags of variant ``name``, restored after."""
    import torch

    from fluxmpi_tpu_torch.models import _layers

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             cudnn.enabled, _layers.Conv.forward)
    cudnn.allow_tf32 = matmul.allow_tf32 = name == "card_tf32"
    if name == "card_ieee":
        if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
            cudnn.conv.fp32_precision = "ieee"
        if hasattr(matmul, "fp32_precision"):
            matmul.fp32_precision = "ieee"
    cudnn.deterministic = name == "card_deterministic"
    cudnn.benchmark = name == "card_benchmark"
    cudnn.enabled = name != "card_no_cudnn"
    if name == "card_nchw":
        plain = _layers.Conv.forward

        def forward(self, x):
            return plain(self, x.contiguous()).contiguous()

        _layers.Conv.forward = forward
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         cudnn.enabled, _layers.Conv.forward) = saved


def flags():
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    out = dict(cudnn_allow_tf32=cudnn.allow_tf32, matmul_allow_tf32=matmul.allow_tf32,
               float32_matmul_precision=torch.get_float32_matmul_precision(),
               cudnn_version=cudnn.version(),
               NVIDIA_TF32_OVERRIDE=os.environ.get("NVIDIA_TF32_OVERRIDE"))
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        out["cudnn_conv_fp32_precision"] = cudnn.conv.fp32_precision
    if hasattr(matmul, "fp32_precision"):
        out["matmul_fp32_precision"] = matmul.fp32_precision
    return out


def per_leaf(got: dict, want: dict) -> dict:
    return {k: float((got[k].cpu().double() - w).abs().max())
            / max(float(w.abs().max()), 1e-30) for k, w in want.items()}


def summary(errs: dict, cpu: dict, top: int = 5) -> dict:
    worst = sorted(errs, key=errs.get, reverse=True)[:top]
    return dict(worst=[(k, errs[k], cpu[k]) for k in worst],
                over_3x_cpu=sum(errs[k] > max(1e-3, 3 * cpu[k]) for k in errs))


def child(name: str) -> None:
    """One card variant, its per-leaf results on stdout as JSON (run in a
    process of its own for environment variables read at start)."""
    import torch

    import chip_smoke

    params, stats = perturbed_params()
    x, y = batch()
    with settings("card"):
        res = chip_smoke._resnet_grads(torch.device(DEVICE), torch.float32, params,
                                       stats, x, y)
        print(json.dumps({"flags": flags(),
                          "leaves": {k: v.tolist() for k, v in res.items()}}))


def layer_probe(leaf: str, params, stats, x, y) -> dict:
    """The conv of ``leaf`` alone: its input and output gradient from the
    f64 pass, its weight gradient on the card in f32 per variant."""
    import torch

    from fluxmpi_tpu_torch.models import ResNet50
    from fluxmpi_tpu_torch.models._layers import same_pads

    mod_name = leaf.removeprefix("grad/").removesuffix(".kernel")
    model = ResNet50(num_classes=1000, dtype=torch.float64, device="cpu").double()
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    conv = model.get_submodule(mod_name)
    seen = {}

    def hook(mod, args, out):
        seen["x"] = args[0].detach()
        out.register_hook(lambda g: seen.__setitem__("dy", g.detach()))

    handle = conv.register_forward_hook(hook)
    logits, _ = model(x, {k: v.double() for k, v in stats.items()}, train=True)
    torch.nn.functional.cross_entropy(logits, y).backward()
    handle.remove()
    xs, dy = seen["x"], seen["dy"]
    w = conv.kernel.detach().permute(3, 2, 0, 1)
    strides = conv.strides
    # The module pads explicitly where flax's "SAME" is asymmetric; the
    # 1x1 convs this probe is aimed at need no padding.
    pads = [lo for lo, _ in same_pads(xs.shape[2:], w.shape[2:], strides)]
    ref = torch.ops.aten.convolution_backward(
        dy, xs, w, None, list(strides), pads, [1, 1], False, [0, 0], 1,
        [False, True, False])[1]
    cond = None
    if tuple(w.shape[2:]) == (1, 1) and tuple(strides) == (1, 1):
        cond = float(torch.einsum("nihw,nohw->oi", xs.abs(), dy.abs()).max()
                     / ref.abs().max())
    out = dict(layer=mod_name, x_shape=list(xs.shape), dy_shape=list(dy.shape),
               conditioning=cond, variants={})
    dev = DEVICE
    for name in ("card", "card_ieee", "card_tf32", "card_deterministic", "card_benchmark",
                 "card_no_cudnn"):
        for layout in ("channels_last", "contiguous"):
            fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
            try:
                with settings(name):
                    g = torch.ops.aten.convolution_backward(
                        dy.float().to(dev, memory_format=fmt),
                        xs.float().to(dev, memory_format=fmt),
                        w.float().to(dev, memory_format=fmt), None, list(strides), pads,
                        [1, 1], False, [0, 0], 1, [False, True, False])[1]
                out["variants"][f"{name}/{layout}"] = float(
                    (g.double().cpu() - ref).abs().max() / ref.abs().max())
            except Exception as e:
                out["variants"][f"{name}/{layout}"] = repr(e)
    g = torch.ops.aten.convolution_backward(
        dy.float(), xs.float(), w.float(), None, list(strides), pads, [1, 1], False, [0, 0],
        1, [False, True, False])[1]
    out["variants"]["cpu"] = float((g.double() - ref).abs().max() / ref.abs().max())
    return out


def live_init():
    """The seeded initial weights with every BatchNorm scale 1 (flax's
    default), so no residual branch starts dead."""
    import torch

    from fluxmpi_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    params = {k: (torch.ones_like(p) if k.endswith(".scale") else p.detach())
              for k, p in model.named_parameters()}
    return params, model.init_batch_stats()


def trained():
    """The weights and statistics after chip_smoke's main path: 32 bf16
    updates through ``train_loop(fuse="auto")``."""
    import torch

    import chip_smoke
    import fluxmpi_tpu_torch as fm

    dev = fm.init()
    corpus = chip_smoke.image_corpus(chip_smoke.RESNET_IMAGES, chip_smoke.RESNET_HW,
                                     chip_smoke.RESNET_CLASSES)
    *_, (params, mstate) = chip_smoke.resnet_run(dev, corpus, "auto", 32, 8)
    fm.shutdown()
    return ({k: v.cpu() for k, v in params.items()}, {k: v.cpu() for k, v in mstate.items()},
            torch.from_numpy(corpus[0][:4]), torch.from_numpy(corpus[1][:4]))


def weight_sets(perturbed, stats, x, y) -> dict:
    """For three weight sets (``live_init``, ``perturbed``, ``trained``):
    the whole model's per-leaf errors against f64 on the card and on the
    CPU, each in channels_last and in NCHW (a different summation order
    on the same device), and every layer alone (``chip_smoke.
    resnet_layers``) against f64 on the card and on the CPU."""
    import torch

    import chip_smoke

    cpu, dev = torch.device("cpu"), torch.device(DEVICE)
    sets = {"live_init": (*live_init(), x, y), "perturbed": (perturbed, stats, x, y),
            "trained": trained()}
    out = {}
    for wname, (params, mstate, xb, yb) in sets.items():
        exact = chip_smoke._resnet_grads(cpu, torch.float64, params, mstate, xb, yb)
        errs = {}
        for where, tag in ((cpu, "cpu"), (dev, "card")):
            with settings("card"):
                errs[tag] = per_leaf(chip_smoke._resnet_grads(where, torch.float32, params,
                                                              mstate, xb, yb), exact)
            with settings("card_nchw"):
                errs[f"{tag}_nchw"] = per_leaf(chip_smoke._resnet_grads(
                    where, torch.float32, params, mstate, xb, yb), exact)
        worst = sorted(errs["card"], key=errs["card"].get, reverse=True)[:5]
        with settings("card"):
            card_vs_cpu = chip_smoke._max_rel(
                chip_smoke._resnet_grads(dev, torch.float32, params, mstate, xb, yb),
                chip_smoke._resnet_grads(cpu, torch.float32, params, mstate, xb, yb))
        feed = chip_smoke.resnet_layers(cpu, torch.float64, params, mstate, xb, yb)
        ref = chip_smoke.resnet_layers(cpu, torch.float64, params, mstate, xb, yb, feed)
        lay = {}
        for where, tag, name in ((cpu, "cpu", "card"), (dev, "card", "card"),
                                 (dev, "card_nchw", "card_nchw"),
                                 (dev, "card_tf32", "card_tf32")):
            with settings(name):
                lay[tag] = per_leaf(chip_smoke.resnet_layers(where, torch.float32, params,
                                                             mstate, xb, yb, feed), ref)
        del feed, ref
        lworst = sorted(lay["card"], key=lay["card"].get, reverse=True)[:8]
        ratio = sorted(lay["card"][k] / max(lay["cpu"][k], 1e-12) for k in lay["card"])
        out[wname] = dict(
            whole_model={tag: max(e.values()) for tag, e in errs.items()},
            card_vs_cpu=card_vs_cpu,
            worst_leaves=[(k, {tag: e[k] for tag, e in errs.items()}) for k in worst],
            layers=dict(n=len(lay["card"]),
                        worst_card=[(k, {tag: e[k] for tag, e in lay.items()})
                                    for k in lworst],
                        worst={tag: max(e.items(), key=lambda kv: kv[1])
                               for tag, e in lay.items()},
                        card_over_cpu_ratio_quantiles=[ratio[int(q * (len(ratio) - 1))]
                                                       for q in (0.5, 0.9, 0.99, 1.0)]))
        out[wname]["propagation"] = propagation(params, mstate, xb, yb)
        print(f"weights {wname}: {out[wname]}", flush=True)
    return out


def trace_model(where, dtype, params, mstate, x, y) -> dict:
    """One training forward and backward of the whole model: every layer's
    output and its gradient, in forward order, on the host in f64; for a
    BatchNorm also its batch statistics' least ``var / E[x^2]`` over the
    channels (how far ``E[x^2] - E[x]^2`` cancels)."""
    import torch
    import torch.nn.functional as F

    from fluxmpi_tpu_torch.models import ResNet50
    from fluxmpi_tpu_torch.models._layers import BatchNorm, Conv
    from fluxmpi_tpu_torch.models.transformer import Dense

    model = ResNet50(num_classes=1000, dtype=dtype, device=where).to(dtype)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    seen, handles = {}, []

    def hook(name):
        def capture(mod, args, out):
            entry = seen[name] = {"out": out.detach().cpu().double()}
            if isinstance(mod, BatchNorm):
                xf = args[0].detach().double()
                axes = [0, 2, 3] if xf.ndim == 4 else [0]
                entry["var_over_ex2"] = float((xf.var(axes, unbiased=False)
                                               / (xf * xf).mean(axes).clamp_min(1e-300)).min())
            out.register_hook(lambda g: entry.__setitem__("grad", g.detach().cpu().double()))
        return capture

    for n, m in model.named_modules():
        if isinstance(m, (Conv, BatchNorm, Dense)):
            handles.append(m.register_forward_hook(hook(n)))
    logits, _ = model(x.to(where), {k: v.to(where, dtype) for k, v in mstate.items()},
                      train=True)
    F.cross_entropy(logits.float(), y.to(where)).backward()
    for h in handles:
        h.remove()
    return seen


def propagation(params, mstate, x, y) -> dict:
    """Where the whole model's f32 pass parts from f64: per layer, the
    output's and the output gradient's ``max|diff| / max|ref|`` on the CPU
    and on the card, and the first layers, in forward order for outputs
    and backward order for gradients, past 1e-4, 1e-3 and 1e-2."""
    import torch

    cpu, dev = torch.device("cpu"), torch.device(DEVICE)
    ref = trace_model(cpu, torch.float64, params, mstate, x, y)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))  # noqa: E731
    out = {"cancellation": sorted(((v["var_over_ex2"], k) for k, v in ref.items()
                                   if "var_over_ex2" in v))[:6]}
    for where, tag in ((cpu, "cpu"), (dev, "card")):
        with settings("card"):
            got = trace_model(where, torch.float32, params, mstate, x, y)
        fwd = [(k, rel(got[k]["out"], ref[k]["out"])) for k in ref]
        bwd = [(k, rel(got[k]["grad"], ref[k]["grad"])) for k in reversed(list(ref))]
        first = lambda seq, t: next(((k, e) for k, e in seq if e > t), None)  # noqa: E731
        # relu follows the stem's and each block's first two BatchNorms
        # directly: an output whose sign differs from f64 flips relu's mask
        # there, and the gradient through that element with it.
        flips = {k: int(((got[k]["out"] > 0) != (ref[k]["out"] > 0)).sum()) for k in ref
                 if k == "bn_init" or k.endswith((".bn1", ".bn2"))}
        out[tag] = dict(relu_mask_flips=sum(flips.values()),
                        relu_mask_flips_worst=sorted(flips.items(), key=lambda kv: -kv[1])[:4],
                        first_forward={t: first(fwd, t) for t in (1e-4, 1e-3, 1e-2)},
                        first_backward={t: first(bwd, t) for t in (1e-4, 1e-3, 1e-2)},
                        worst_forward=max(fwd, key=lambda kv: kv[1]),
                        worst_backward=max(bwd, key=lambda kv: kv[1]))
        del got
    return out


def variants(params, stats, x, y) -> dict:
    """The whole model per variant of the card's settings (module
    docstring), against f64, and the worst leaf's layer alone."""
    import torch

    import chip_smoke

    cpu, dev = torch.device("cpu"), torch.device(DEVICE)
    exact = chip_smoke._resnet_grads(cpu, torch.float64, params, stats, x, y)
    host = per_leaf(chip_smoke._resnet_grads(cpu, torch.float32, params, stats, x, y), exact)
    report = dict(leaves=len(exact), cpu=summary(host, host), variants={})
    print(f"cpu f32 vs f64: {report['cpu']}", flush=True)
    for name in ("card", "card_ieee", "card_tf32", "card_deterministic", "card_benchmark",
                 "card_nchw", "card_no_cudnn"):
        try:
            with settings(name):
                fl = flags()
                errs = per_leaf(chip_smoke._resnet_grads(dev, torch.float32, params, stats,
                                                         x, y), exact)
            report["variants"][name] = dict(flags=fl, **summary(errs, host))
        except Exception as e:  # a setting this PyTorch refuses: recorded, next variant
            report["variants"][name] = dict(error=repr(e))
        print(f"{name}: {report['variants'][name]}", flush=True)
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    proc = subprocess.run([sys.executable, __file__, "--child", "card"], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode == 0:
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        errs = per_leaf({k: torch.tensor(v) for k, v in got["leaves"].items()}, exact)
        report["variants"]["card_tf32_override_0"] = dict(flags=got["flags"],
                                                          **summary(errs, host))
    else:
        report["variants"]["card_tf32_override_0"] = dict(error=proc.stderr[-2000:])
    print(f"card_tf32_override_0: {report['variants']['card_tf32_override_0']}", flush=True)
    worst = report["variants"]["card"]["worst"][0][0]
    if worst.startswith("grad/") and worst.endswith(".kernel"):
        report["layer"] = layer_probe(worst, params, stats, x, y)
        print(f"layer: {report['layer']}", flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "resnet_f32_probe.json"))
    ap.add_argument("--weights-only", action="store_true",
                    help="skip the variants on the perturbed weights")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(os.cpu_count() or 1)
    # As chip_smoke.py runs: TF32 off (each variant below sets its own).
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if args.child:
        child(args.child)
        return 0
    if DEVICE != "cpu" and not torch.cuda.is_available():
        print("resnet_f32_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    params, stats = perturbed_params()
    x, y = batch()
    report = dict(card=chip_smoke.card_line())
    if not args.weights_only:
        report.update(variants(params, stats, x, y))
    report["weights"] = weight_sets(params, stats, x, y)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
