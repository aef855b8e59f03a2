#!/usr/bin/env python3
"""Read the bf16 gradient gate's ratio for the kernels as built, beside
kernels made wrong on purpose, on one GPU.

    python3 scripts/bf16_grad_bound.py [--out chiprun_out/bf16_grad_bound.json]

``chip_smoke.py`` (``bf16_phase``) and ``tests/test_torch_cuda.py``
(``test_bf16_training_update_through_the_kernels_matches_plain_versions``)
hold one bf16-compute update's gradients (f32 masters) through the three
attention kernels against the same update through their plain versions:
per parameter leaf ``||diff|| / ||g||`` within ``2**-8 x 2 x layers`` (the
key biases, zero in exact arithmetic, against the model's largest gradient
norm). This script reads that ratio in both settings, ``gpt2_small``
(chip_smoke's: 12 layers of GPT-2-small width, the first batch of 8 x 1024
tokens of its corpus) and ``test`` (the test's 2-layer LM on 4 x 128
random tokens), for:

- ``kernels``: the kernels as built, what the gates read;
- each entry of ``FAULTS``: the same kernels, their output changed as a
  faulty kernel would give it (the kernel itself still launches);
- ``f32_compute``: the plain versions with the model in f32 compute,
  against the plain versions in bf16: the whole effect of bf16 rounding,
  for scale.

For each it prints the worst leaf's ratio, how many leaves exceed the
bound, and the per-element form ``max|diff| / max|g|``, and writes all
leaves' ratios to ``--out``. It then runs chip_smoke's per-kernel bf16
checks at the training shape for the kernels as built and for each fault,
to show which faults the kernel-level tolerances catch. Exits non-zero if
the kernels as built exceed the bound or fail a kernel check.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCK = 64  # rows per kernel tile


def _dq_scale_dropped(fa, real):
    """dQ without the softmax scale 1/sqrt(d)."""
    def dq(q, *args, **opts):
        return real["dq"](q, *args, **opts) * math.sqrt(q.shape[-1])
    return dict(dq=dq)


def _dq_one_head_missing(fa, real):
    """dQ of head 0 never written (its blocks not launched)."""
    def dq(*args, **opts):
        out = real["dq"](*args, **opts)
        out[:, :, 0] = 0
        return out
    return dict(dq=dq)


def _dkv_last_key_block_missing(fa, real):
    """dK and dV of each sequence's last 64 keys never written (the key
    loop's bound one tile short)."""
    def dkv(*args, **opts):
        dk, dv = real["dkv"](*args, **opts)
        dk[:, -BLOCK:] = 0
        dv[:, -BLOCK:] = 0
        return dk, dv
    return dict(dkv=dkv)


def _lse_off_one_percent(fa, real):
    """The forward's log-sum-exp off by log(1.01): the backward's
    probabilities 1% small, so every attention gradient 1% small."""
    def fwd(*args, **opts):
        out, lse = real["fwd"](*args, **opts)
        return out, lse + math.log(1.01)
    return dict(fwd=fwd)


FAULTS = {
    "dq_scale_dropped": _dq_scale_dropped,
    "dq_one_head_missing": _dq_one_head_missing,
    "dkv_last_key_block_missing": _dkv_last_key_block_missing,
    "lse_off_one_percent": _lse_off_one_percent,
}


class _patched:
    """Route the wrappers through ``make(fa, real)``'s replacements."""

    def __init__(self, make):
        self.fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
        self.make = make

    def __enter__(self):
        fa = self.fa
        self.saved = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        real = dict(zip(("fwd", "dq", "dkv"), self.saved))
        new = {**real, **self.make(fa, real)}
        for fn in new.values():
            # A wrapper counts its launch on the module's name for it,
            # which is the replacement while this block lasts.
            if not hasattr(fn, "launches"):
                fn.launches = 0
        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = new["fwd"], new["dq"], new["dkv"]
        return self

    def __exit__(self, *exc):
        self.fa.flash_fwd, self.fa.flash_bwd_dq, self.fa.flash_bwd_dkv = self.saved
        return False


def ratios(names, got, want):
    """Per leaf ``||diff|| / ||g||`` and ``max|diff| / max|g|``; key biases
    against the model's largest norm and largest element."""
    top_norm = max(b.norm().item() for b in want)
    top_max = max(b.abs().max().item() for b in want)
    norm, elem = {}, {}
    for name, a, b in zip(names, got, want):
        key_bias = name.endswith("attn.key.bias")
        n = top_norm if key_bias else b.norm().item()
        m = top_max if key_bias else b.abs().max().item()
        norm[name] = (a - b).norm().item() / n if n else 0.0
        elem[name] = (a - b).abs().max().item() / m if m else 0.0
    return norm, elem


def setting(name, device):
    """``(config, model, batch)`` of one setting."""
    import torch

    import chip_smoke
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch.models import TransformerLM

    if name == "test":
        cfg = dict(vocab_size=211, max_len=128, num_layers=2, d_model=128,
                   num_heads=2, d_ff=256)
        gen = torch.Generator().manual_seed(3)
        model = TransformerLM(**cfg, attention="flash", dtype=torch.bfloat16,
                              device=device, generator=gen)
        gen = torch.Generator().manual_seed(0)
        x = torch.randint(0, 211, (4, 128), generator=gen).to(device)
        y = torch.randint(0, 211, (4, 128), generator=gen).to(device)
        return cfg, model, (x, y)
    cfg = chip_smoke.GPT2_SMALL
    model = TransformerLM(**cfg, attention="flash", dropout=0.0, dtype=torch.bfloat16,
                          device=device, generator=torch.Generator().manual_seed(0))
    corpus = chip_smoke.lm_corpus(cfg["vocab_size"], seq=cfg["max_len"])
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=8, shuffle=True)
    return cfg, model, next(iter(loader))


def kernel_checks(device):
    """chip_smoke's own per-kernel bf16 checks at its training case (b 8,
    s 1024, h 12, d 64, causal) for the kernels as built and for each
    fault: the forward's out and lse against the plain forward (``TOL``),
    dQ, dK and dV against the plain backward from the same lse
    (``GRAD_TOL``, relative to the largest magnitude). Returns ``{run:
    {"fwd": {...}, "bwd": {...}, "caught": bool}}``."""
    import torch

    import chip_smoke

    fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
    case = next(c for c, _ in chip_smoke.backward_cases() if c[0] == "train_1024")
    dtype = torch.bfloat16
    q, k, v, qseg, kseg = chip_smoke.make_inputs(case, dtype,
                                                 torch.Generator().manual_seed(2), device)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(dtype).to(device)
    opts = dict(causal=True, window=None, dropout_rate=0.0, seed=chip_smoke.DROPOUT_SEED)
    tol, gtol = chip_smoke.TOL["bfloat16"], chip_smoke.GRAD_TOL["bfloat16"]
    out_ref, lse_ref = fa.flash_attention_reference(q, k, v, **opts)

    def check():
        out, lse = fa.flash_fwd(q, k, v, qseg, kseg, **opts)
        fwd = {"out": (out.float() - out_ref.float()).abs().max().item(),
               "lse": (lse - lse_ref).abs().max().item()}
        dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        got = (fa.flash_bwd_dq(q, k, v, qseg, kseg, g, lse, dterm, **opts),
               *fa.flash_bwd_dkv(q, k, v, qseg, kseg, g, lse, dterm, **opts))
        want = fa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, **opts)
        bwd = {label: (a.float() - b.float()).abs().max().item()
               / b.float().abs().max().item()
               for label, a, b in zip(("dq", "dk", "dv"), got, want)}
        caught = (fwd["out"] > tol["out"] or fwd["lse"] > tol["lse"]
                  or any(r > gtol for r in bwd.values()))
        return dict(fwd=fwd, bwd=bwd, caught=caught)

    runs = {"kernels": check()}
    for fault, make in FAULTS.items():
        with _patched(make):
            runs[fault] = check()
    for run, r in runs.items():
        print(f"kernel checks {run:28s} out {r['fwd']['out']:.3e} (tol {tol['out']:g}) "
              f"lse {r['fwd']['lse']:.3e} (tol {tol['lse']:g}) dq/dk/dv rel "
              + "/".join(f"{r['bwd'][x]:.3e}" for x in ("dq", "dk", "dv"))
              + f" (tol {gtol:.3e}): {'caught' if r['caught'] else 'passes'}", flush=True)
    return runs


def read(name, device):
    import torch

    import chip_smoke
    from fluxmpi_tpu_torch.models import TransformerLM

    cfg, model, (x, y) = setting(name, device)
    names = [n for n, _ in model.named_parameters()]
    bound = 2 ** -8 * 2 * cfg["num_layers"]

    def grads(m):
        params = list(m.parameters())
        return [g.detach() for g in torch.autograd.grad(m(x, targets=y).mean(), params)]

    with chip_smoke.plain_attention():
        plain = grads(model)
    runs = {"kernels": grads(model)}
    for fault, make in FAULTS.items():
        with _patched(make):
            runs[fault] = grads(model)
    m32 = TransformerLM(**cfg, attention="flash", dropout=0.0, dtype=torch.float32,
                        device=device)
    m32.load_state_dict(model.state_dict())
    with chip_smoke.plain_attention():
        runs["f32_compute"] = grads(m32)
    del m32
    out = {}
    for run, got in runs.items():
        norm, elem = ratios(names, got, plain)
        worst = max(norm, key=norm.get)
        worst_e = max(elem, key=elem.get)
        above = sorted(n for n, r in norm.items() if not r <= bound)
        out[run] = dict(worst=norm[worst], worst_leaf=worst, above=len(above),
                        leaves=len(norm), worst_elem=elem[worst_e],
                        worst_elem_leaf=worst_e, norm=norm, elem=elem)
        print(f"{name:10s} {run:28s} worst ||diff||/||g|| {norm[worst]:.4e} "
              f"({worst}); {len(above)}/{len(norm)} leaves above the bound "
              f"{bound:.4e}; worst max|diff|/max|g| {elem[worst_e]:.4e} ({worst_e})",
              flush=True)
    torch.cuda.empty_cache()
    return dict(bound=bound, runs=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "bf16_grad_bound.json"))
    args = ap.parse_args()

    import torch

    import chip_smoke
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("bf16_grad_bound: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    _build.build_all()
    device = fm.init()
    try:
        result = {"card": chip_smoke.card_line(),
                  "settings": {name: read(name, device) for name in ("test", "gpt2_small")},
                  "kernel_checks": kernel_checks(device)}
    finally:
        fm.shutdown()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    summary = {name: {run: {k: v for k, v in r.items() if k not in ("norm", "elem")}
                      for run, r in s["runs"].items()} | {"bound": s["bound"]}
               for name, s in result["settings"].items()}
    summary["kernel_checks"] = result["kernel_checks"]
    print(json.dumps(summary))
    bad = [name for name, s in result["settings"].items()
           if s["runs"]["kernels"]["above"]]
    if result["kernel_checks"]["kernels"]["caught"]:
        bad.append("kernel_checks")
    if bad:
        print(f"bf16_grad_bound: the kernels exceed the bound in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
