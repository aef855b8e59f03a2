#!/usr/bin/env python3
"""Does ResNet-50's bf16 training give the same bits run after run?

    python3 scripts/resnet_determinism_probe.py [--updates 32] [--repeats 3]
        [--out chiprun_out/resnet_determinism_probe.json]

On one CUDA card, ``chip_smoke.vision_phase``'s main run as it trains:
ResNet-50 (``fluxmpi_tpu_torch.models.ResNet50``, bf16 compute, f32
parameters, 1000 classes) from the same seeded weights, ``sgd(0.1,
momentum=0.9)``, batch 128 of ``chip_smoke.image_corpus``'s 224 x 224
images through the device-gather loader, ``train_loop(steps=updates,
flush_every=8)``. TF32 is off, as in ``chip_smoke``.

For each cuDNN setting (``default``: PyTorch's heuristics, which may pick
engines cuDNN marks nondeterministic; ``deterministic``:
``torch.backends.cudnn.deterministic = True``) it trains ``repeats`` runs
with ``fuse=False`` and ``repeats`` with ``fuse="auto"`` (CUDA-graph
windows), and counts, against that setting's first ``fuse=False`` run,
the leaves (parameters, momentum buffers, BatchNorm statistics) that are
bit-identical and whether the flush losses are the same. One traced
update per setting lists the device kernels, so the convolution engines
the two settings pick can be told apart, and gives its median ms per
update.

With ``--free-gb 40,30,...`` it then trains, under the default setting,
one ``fuse="auto"`` run and one ``fuse=False`` run with a tensor held so
that only that many GB of the card stay free (``torch.cuda.mem_get_info``
after emptying the cache), and counts their bit-identical leaves against
the first run without that pressure: does memory the allocator cannot
give a convolution's workspace (during a CUDA-graph capture it releases
no cached block) change the engine cuDNN runs, and so the bits? A run
that fails names its error. Prints one line per run and writes
everything to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def train(dev, corpus, fuse, updates: int):
    """One run from the seeded weights; its flush losses, its leaves and
    the median ms per update of its steady windows."""
    import numpy as np
    import torch

    import chip_smoke
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import ResNet50
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator().manual_seed(0))
    fm.synchronize(model)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset(corpus)),
        global_batch_size=chip_smoke.RESNET_BATCH, shuffle=True, device=dev)
    opt = optim.sgd(0.1, momentum=0.9)
    step = make_train_step(chip_smoke._bn_loss(model), opt)
    state = TrainState.create(model, opt, model_state=model.init_batch_stats())
    state, summ = train_loop(step, state, loader, steps=updates, flush_every=8, fuse=fuse)
    torch.cuda.synchronize()
    leaves = {f"params/{k}": v.detach().clone() for k, v in state.params.items()}
    leaves.update({f"momentum/{k}": v.clone() for k, v in state.opt_state["trace"].items()})
    leaves.update({f"batch_stats/{k}": v.clone() for k, v in state.model_state.items()})
    flushes = [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
               for f in summ["flushes"]]
    width = summ["fused_window"] or 1
    ms = float(np.median([t / width for t in summ["step_ms"]])) if summ["step_ms"] else None
    kernels = None
    if fuse is False:
        import chip_smoke as cs

        (_, _), _, _, _, by_name = cs.traced(
            lambda: train_loop(step, state, loader, steps=1, flush_every=1, fuse=False),
            group=lambda name: name)
        kernels = sorted(by_name)
    del model, loader, step, state
    torch.cuda.empty_cache()
    return flushes, leaves, ms, kernels


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--free-gb", default="",
                    help="comma-separated GB to leave free for the pressure runs")
    ap.add_argument("--skip-settings", action="store_true",
                    help="only the reference run and the pressure runs")
    ap.add_argument("--out", default="chiprun_out/resnet_determinism_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resnet_determinism_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    import fluxmpi_tpu_torch as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = fm.init()
    corpus = chip_smoke.image_corpus(chip_smoke.RESNET_IMAGES, chip_smoke.RESNET_HW,
                                     chip_smoke.RESNET_CLASSES)
    report = {"card": card, "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version(), "settings": {}}
    for setting in (("default",) if args.skip_settings else ("default", "deterministic")):
        torch.backends.cudnn.deterministic = setting == "deterministic"
        ref = None
        runs = []
        repeats = 1 if args.skip_settings else args.repeats
        for fuse in [False] * repeats + ["auto"] * (0 if args.skip_settings else repeats):
            t0 = time.perf_counter()
            flushes, leaves, ms, kernels = train(dev, corpus, fuse, args.updates)
            if ref is None:
                ref = (flushes, leaves, kernels)
            same = sum(torch.equal(leaves[k], ref[1][k]) for k in ref[1])
            run = dict(fuse=fuse, bit_identical=same, leaves=len(ref[1]),
                       flushes_identical=flushes == ref[0], median_update_ms=ms,
                       flush_loss_means=[f[2] for f in flushes],
                       seconds=time.perf_counter() - t0)
            if kernels is not None:
                run["kernels_same_as_first"] = kernels == ref[2]
            runs.append(run)
            print(f"resnet_determinism_probe [{setting}, fuse={fuse!r}]: {same} of "
                  f"{len(ref[1])} leaves bit-identical to the first fuse=False run; "
                  f"flush losses {'identical' if run['flushes_identical'] else 'DIFFER'}; "
                  f"median {ms} ms per update; {card}", flush=True)
        conv = [k for k in ref[2] if any(s in k.lower() for s in (
            "conv", "wgrad", "dgrad", "fprop", "xmma", "cudnn", "sm90_"))]
        report["settings"][setting] = dict(runs=runs, kernels=ref[2], conv_kernels=conv)
        print(f"resnet_determinism_probe [{setting}]: {len(ref[2])} distinct kernels in "
              f"one update, {len(conv)} of them convolution engines", flush=True)
        if setting == "default":
            want = ref
    torch.backends.cudnn.deterministic = False
    report["pressure"] = []
    for gb in [float(g) for g in args.free_gb.split(",") if g]:
        for fuse in ("auto", False):
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info(dev)[0]
            hold = torch.empty(max(0, int(free - gb * 1e9)), dtype=torch.uint8, device=dev)
            left = torch.cuda.mem_get_info(dev)[0] / 1e9
            run = dict(free_gb=gb, free_gb_measured=left, fuse=fuse)
            try:
                flushes, leaves, ms, _ = train(dev, corpus, fuse, args.updates)
                run.update(bit_identical=sum(torch.equal(leaves[k], want[1][k]) for k in want[1]),
                           leaves=len(want[1]), flushes_identical=flushes == want[0],
                           median_update_ms=ms)
                del leaves
            except Exception as exc:  # noqa: BLE001 - report and go on
                run["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
            del hold
            torch.cuda.empty_cache()
            report["pressure"].append(run)
            print(f"resnet_determinism_probe [pressure, {left:.2f} GB free, fuse={fuse!r}]: "
                  + (run["error"] if "error" in run else
                     f"{run['bit_identical']} of {run['leaves']} leaves bit-identical to the "
                     f"run without pressure; flush losses "
                     f"{'identical' if run['flushes_identical'] else 'DIFFER'}")
                  + f"; {card}", flush=True)
    if args.skip_settings:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
        fm.shutdown()
        return 0
    a, b = (set(report["settings"][s]["conv_kernels"]) for s in ("default", "deterministic"))
    report["conv_kernels_only_default"] = sorted(a - b)
    report["conv_kernels_only_deterministic"] = sorted(b - a)
    for name in sorted(a - b):
        print(f"  only under default: {name[:200]}")
    for name in sorted(b - a):
        print(f"  only under deterministic: {name[:200]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    fm.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
