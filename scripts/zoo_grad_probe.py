#!/usr/bin/env python3
"""Read the zoo's gradient gates for the kernels as built, beside kernels
made wrong on purpose, and where ViT's f32 gradients part from f64, on one
GPU.

    python3 scripts/zoo_grad_probe.py [--out chiprun_out/zoo_grad_probe.json]

``chip_smoke.py`` (``zoo_grad_gates``) holds one update's gradients of
ViT-B/16 and of the DDPM UNet (at perturbed weights) through the three
attention kernels against the same update through their plain versions.
This script reads, for ``kind`` in ``vit`` and ``unet``, at chip_smoke's
main batch (128 and 64) and for the kernels as built (``kernels``) and for
each fault of ``scripts/bf16_grad_bound.py``'s ``FAULTS`` plus
``dk_off_one_percent`` (dK alone 1% large, which reaches only the key
projections' gradients):

- the bf16 gate's ``||diff|| / ||g||`` over the leaves bf16 resolves
  (whose plain bf16 gradient stands within ``2**-8 x 2 x layers`` of the
  f32 one) and, on the others, ``||diff|| / ||g_f32||`` (key biases
  against the largest norm);
- in f32 (TF32 off), ``chip_smoke.leaf_max_rel`` (per leaf
  ``max|diff| / max|g|``, key biases against the largest) and
  ``||diff|| / ||g||``, worst over every leaf and over the unresolved ones.

Then ViT alone at the seeded weights on the batches of chip_smoke's
card-vs-CPU check (4) and of its f32 gate (8): the kernels in f32 on the
card, the plain versions in f32 on the card and, at batch 4, on the CPU,
each against the
plain versions in f64 on the card (every layer in f64: LayerNorm and the
f32 head promoted for the pass; flax's dense attend), per leaf
``leaf_max_rel``. Prints one line per reading and writes every leaf's
readings to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def _dk_off_one_percent(fa, real):
    """dK 1% large (dV and dQ right)."""
    def dkv(*args, **opts):
        dk, dv = real["dkv"](*args, **opts)
        return dk * 1.01, dv
    return dict(dkv=dkv)


@contextlib.contextmanager
def f64_layers():
    """Every layer of the port's ViT in f64 when its model dtype is f64:
    LayerNorm (which computes in f32 whatever its input) and a ``Dense``
    asked for f32 (the head) promoted."""
    import torch
    import torch.nn.functional as F

    layers = importlib.import_module("fluxmpi_tpu_torch.models._layers")
    saved = layers.LayerNorm.forward, layers.Dense.forward

    def ln(self, x, dtype):
        return F.layer_norm(x.double(), (x.shape[-1],), self.scale.double(),
                            self.bias.double(), self.eps).to(torch.float64)

    def dense(self, x, dtype):
        return saved[1](self, x, torch.float64)

    layers.LayerNorm.forward, layers.Dense.forward = ln, dense
    try:
        yield
    finally:
        layers.LayerNorm.forward, layers.Dense.forward = saved


def _norm_rel(got, want, scale=None):
    """Per leaf ``||diff|| / ||want||`` (``||scale||`` where given); a key
    bias against the largest norm."""
    scale = scale or want
    top = max(g.double().norm().item() for g in scale.values())
    return {k: (got[k].double() - g.double()).norm().item()
            / (top if k.endswith("attn.key.bias") else (scale[k].double().norm().item() or 1.0))
            for k, g in want.items()}


def _worst(d, keys=None):
    keys = list(d) if keys is None else list(keys)
    if not keys:
        return (0.0, None)
    k = max(keys, key=d.get)
    return (d[k], k)


def gates(kind, dev, data, faults):
    """The main batch's readings for the kernels as built and each fault."""
    import torch

    import chip_smoke
    from bf16_grad_bound import _patched

    tol = 2 ** -8 * 2 * chip_smoke.ZOO_ATTN[kind]
    runs = {"kernels": None, **{f: make for f, make in faults.items()}}
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        model, loss_fn, fresh, batch = chip_smoke.zoo_grad_model(kind, dev, dtype, data)
        with chip_smoke.plain_attention():
            plain = chip_smoke._grads(model, loss_fn, batch, fresh)
        got = {}
        for run, make in runs.items():
            with (_patched(make) if make else contextlib.nullcontext()):
                got[run] = chip_smoke._grads(model, loss_fn, batch, fresh)
        res[str(dtype).split(".")[1]] = (plain, got)
        del model
        torch.cuda.empty_cache()
    plain_bf, got_bf = res["bfloat16"]
    f32, got32 = res["float32"]
    # chip_smoke's split: each leaf against its own f32 norm.
    spread = {k: (plain_bf[k].double() - g.double()).norm().item()
              / (g.double().norm().item() or 1.0) for k, g in f32.items()}
    resolved = [k for k, v in spread.items() if v <= tol]
    unresolved = [k for k in spread if k not in resolved]
    out = dict(bound=tol, resolved=len(resolved), unresolved=sorted(unresolved),
               plain_bf16_vs_f32=spread, runs={})
    for run in runs:
        bf_norm = _norm_rel(got_bf[run], plain_bf)
        bf_vs_f32 = _norm_rel(got_bf[run], plain_bf, f32)
        bf_vs_f32 = {k: bf_vs_f32[k] for k in unresolved}
        max32 = chip_smoke.leaf_max_rel(got32[run], f32)
        norm32 = _norm_rel(got32[run], f32)
        r = dict(bf16_resolved=_worst(bf_norm, resolved),
                 bf16_unresolved_over_f32_norm=_worst(bf_vs_f32),
                 f32_max_all=_worst(max32), f32_max_unresolved=_worst(max32, unresolved),
                 f32_norm_all=_worst(norm32), f32_norm_unresolved=_worst(norm32, unresolved),
                 leaves=dict(bf16=bf_norm, f32_max=max32, f32_norm=norm32))
        out["runs"][run] = r
        print(f"{kind} {run:28s} bf16 resolved ({len(resolved)}) ||d||/||g|| "
              f"{r['bf16_resolved'][0]:.4e} ({r['bf16_resolved'][1]}); bf16 unresolved "
              f"({len(unresolved)}) ||d||/||g_f32|| {r['bf16_unresolved_over_f32_norm'][0]:.4e}; "
              f"f32 max|d|/max|g| all {r['f32_max_all'][0]:.4e} ({r['f32_max_all'][1]}), "
              f"unresolved {r['f32_max_unresolved'][0]:.4e} ({r['f32_max_unresolved'][1]}); "
              f"f32 ||d||/||g|| all {r['f32_norm_all'][0]:.4e}, unresolved "
              f"{r['f32_norm_unresolved'][0]:.4e}", flush=True)
    return out


def witness(dev, data):
    """ViT at the seeded weights, batches 4 and 8: kernels and plain
    versions in f32 (and the CPU's at batch 4) against f64."""
    import torch

    import chip_smoke
    from fluxmpi_tpu_torch.models import ViT
    from fluxmpi_tpu_torch.ops import flash_attention_fn

    def vit(where, dtype, attention_fn):
        return ViT(**chip_smoke.VIT_B16, dtype=dtype, attention_fn=attention_fn,
                   image_size=chip_smoke.VIT_HW, device=where,
                   generator=torch.Generator().manual_seed(0))

    def grads(model, batch):
        return {k: v.to(dev) for k, v in chip_smoke._grads(
            model, chip_smoke._vit_loss(model), batch).items()}

    out = {}
    # chip_smoke's batches: the corpus's first 4 images (card vs CPU), the
    # loader's first batch's first 8 (the f32 gate).
    first = chip_smoke.zoo_grad_model("vit", dev, torch.float32, data)[3]
    for n in (4, 8):
        batch = (tuple(torch.from_numpy(t[:n]) for t in data) if n == 4
                 else tuple(t[:n].cpu() for t in first))
        on_dev = tuple(t.to(dev) for t in batch)
        model = vit(dev, torch.float32, flash_attention_fn())
        g = {"kernels": grads(model, on_dev)}
        with chip_smoke.plain_attention():
            g["plain"] = grads(model, on_dev)
        del model
        if n == 4:
            g["cpu"] = grads(vit(torch.device("cpu"), torch.float32, flash_attention_fn()),
                             batch)
        # f64: flax's dense attend (an implementation of its own), every
        # layer in f64.
        with f64_layers():
            g64 = grads(vit(dev, torch.float64, None), on_dev)
        torch.cuda.empty_cache()
        r = {f"{a}_vs_f64": chip_smoke.leaf_max_rel(g[a], g64) for a in g}
        r["kernels_vs_plain"] = chip_smoke.leaf_max_rel(g["kernels"], g["plain"])
        if "cpu" in g:
            r["kernels_vs_cpu"] = chip_smoke.leaf_max_rel(g["kernels"], g["cpu"])
        gate_leaf = _worst(r["kernels_vs_plain"])[1]
        line = {k: dict(worst=_worst(v), at_gate_leaf=v[gate_leaf]) for k, v in r.items()}
        out[f"batch_{n}"] = dict(summary=line, gate_leaf=gate_leaf, leaves=r)
        print(f"vit f32 batch {n} (gate leaf {gate_leaf}): " + "; ".join(
            f"{k} worst {v['worst'][0]:.4e} ({v['worst'][1]}), at the gate leaf "
            f"{v['at_gate_leaf']:.4e}" for k, v in line.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "zoo_grad_probe.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("zoo_grad_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    import fluxmpi_tpu_torch as fm
    from bf16_grad_bound import FAULTS
    from fluxmpi_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all()
    dev = fm.init()
    faults = {**FAULTS, "dk_off_one_percent": _dk_off_one_percent}
    # chip_smoke's data, so the loader's first batch is the gates' batch.
    data = {"vit": chip_smoke.image_corpus(chip_smoke.VIT_IMAGES, chip_smoke.VIT_HW,
                                           chip_smoke.RESNET_CLASSES),
            "unet": (chip_smoke.unet_images(chip_smoke.UNET_IMAGES, chip_smoke.UNET_HW),)}
    try:
        report = dict(card=card, gates={k: gates(k, dev, data[k], faults)
                                        for k in ("vit", "unet")},
                      witness=witness(dev, data["vit"]))
    finally:
        fm.shutdown()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
