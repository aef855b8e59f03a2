#!/usr/bin/env python3
"""Build the dK/dV kernel with other block shapes and time each on one GPU.

    python3 scripts/dkv_variants.py [KEY=VALUE,...[:ABLATION] | path/to/flash_bwd_dkv.cu ...]

e.g. ``F32_G=5,F32_S=2 BF16_BQ=32 SPLIT_ONCE=0 MINB=2 :skeleton`` (an empty
spec, or ``:ABLATION`` alone, is the shipped shape).

``fluxmpi_tpu_torch/ops/csrc/flash_bwd_dkv.cu`` takes its block shape per
input type from the constants of ``Shape<float>`` and
``Shape<__nv_bfloat16>``. A spec's ``KEY=VALUE`` pairs patch a copy of the
source: ``F32_BQ``, ``F32_G``, ``F32_NS``, ``F32_S`` and ``F32_CHUNK`` (and
``BF16_...``) set ``kBQ`` (queries per streamed tile), ``kG`` (row groups
of 16 key rows), ``kNS`` (query streams), ``kS`` (ring slots) and
``kChunk`` (queries a warp computes at once); ``SPLIT_ONCE=0`` splits the
f32 K/V operand to TF32 on every tile instead of once per block; ``MINB=2``
asks the registers to allow two blocks per SM. Each variant is compiled by
``nvcc`` (all variants at once, with the package's own flags, into
``fluxmpi_tpu_torch/ops/_build/variants/``), loaded with
ctypes in place of the package's library, held against
``flash_attention_bwd_reference`` within ``chip_smoke.GRAD_TOL`` and timed
by CUDA-graph replay (``chip_smoke.device_ms``) at the training shape (b 8,
s 1024, h 12, d 64, causal) in float32 and bfloat16. Prints the card,
ptxas's register and spill lines, and one JSON line per variant. Exits
non-zero if a variant fails to build or to agree. A path to another
``flash_bwd_dkv.cu`` (say the parent commit's, unpacked by ``git archive``
into a git-ignored directory) is built as it is, with the headers beside
it, and timed in the same run.

An ABLATION (one of ``ABLATIONS``) patches a copy of the source to take a
part of the tile step out, so the times show where a step's time goes;
its results are wrong by design, so it is timed but not held to the
tolerance.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE = (8, 1024, 12, 64)  # b, s, h, d

# Source patches (regex, replacement) of flash_bwd_dkv.cu, each taking a
# part of the tile step out.
ABLATIONS = {
    # No dV/dK product: the compiler drops the scores and the elementwise
    # pass too, leaving the walk, the copies and the barriers.
    "skeleton": [(r"value_product<DP, kChunk, LD>\(acc_[kv], \w+, \w+, lane\);", "")],
    # The four products without the elementwise pass between them.
    "no_elementwise": [(r"// p_drop\^T into s.*?(?=value_product<DP, kChunk, LD>\(acc_v)", "")],
    # The elementwise pass without exp, or with every tile on the path
    # without mask tests.
    "no_exp": [(r"__expf\((s\[j\]\[e\] \* p\.scale - \(\(e & 1\) \? lse2\.y : lse2\.x\))\)",
                r"(\1)")],
    "no_mask": [(r"const bool full = ", "const bool full = true || ")],
}


_TYPES = {"F32": "float", "BF16": "__nv_bfloat16"}
_FIELDS = {"BQ": "kBQ", "G": "kG", "NS": "kNS", "S": "kS", "CHUNK": "kChunk"}


def shape_patches(settings):
    """Source patches (regex, replacement) for a spec's KEY=VALUE pairs."""
    patches = []
    for key, value in settings:
        if key == "SPLIT_ONCE":
            patches.append((r"constexpr bool kSplitOnce = sizeof\(T\) == 4;",
                            f"constexpr bool kSplitOnce = sizeof(T) == 4 && {str(bool(value)).lower()};"))
        elif key == "MINB":
            patches.append((r"(__launch_bounds__\(Layout<T, DP, BQ, G, NS, S>::kThreads, )1\)",
                            rf"\g<1>{value})"))
        else:
            typ, _, field = key.partition("_")
            if typ not in _TYPES or field not in _FIELDS:
                raise SystemExit(f"unknown setting {key!r}")
            patches.append((rf"(struct Shape<{_TYPES[typ]}> \{{[^}}]*?\b{_FIELDS[field]} = )\d+",
                            rf"\g<1>{value}"))
    return patches


def patched_source(out_dir: Path, tag: str, patches) -> str:
    """A copy of ``csrc/`` with ``patches`` applied to the dK/dV source;
    returns the patched file's path."""
    import re
    import shutil

    from fluxmpi_tpu_torch.ops import _build

    dst = out_dir / f"src-{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    path = dst / "flash_bwd_dkv.cu"
    text = path.read_text()
    for pattern, repl in patches:
        text, n = re.subn(pattern, repl, text, flags=re.S)
        if not n:
            raise ValueError(f"{tag}: {pattern!r} matches nothing")
    path.write_text(text)
    return str(path)


def build(variants):
    import chip_smoke
    from fluxmpi_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        if isinstance(v, str):
            out = out_dir / f"libflash_bwd_dkv-source{i}.so"
            cmd = _build._command("flash_bwd_dkv", out)
            cmd[-1] = v
        else:
            settings, ablation = v
            tag = "-".join([f"{k}{n}" for k, n in settings] + [ablation or "full"])
            out = out_dir / f"libflash_bwd_dkv-{tag}.so"
            cmd = _build._command("flash_bwd_dkv", out)
            patches = shape_patches(settings) + ABLATIONS.get(ablation, [])
            if patches:
                cmd[-1] = patched_source(out_dir, tag, patches)
        procs[v] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for v, (out, proc) in procs.items():
        log, _ = proc.communicate()
        for line in chip_smoke.ptxas_summary(log):
            print(f"  G,NS,S={v}: {line}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{v}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib = ctypes.CDLL(str(out))
        lib.flash_bwd_dkv.argtypes = _build.SOURCES["flash_bwd_dkv"]
        lib.flash_bwd_dkv.restype = ctypes.c_int
        libs[v] = lib
    return libs, failed


def parse(spec: str):
    """``KEY=VALUE,...[:ABLATION]`` -> (((KEY, VALUE), ...), ABLATION or None)."""
    shape, _, ablation = spec.partition(":")
    if ablation and ablation not in ABLATIONS:
        raise SystemExit(f"unknown ablation {ablation!r}; known: {sorted(ABLATIONS)}")
    settings = tuple((k.upper(), int(n)) for k, n in
                     (kv.split("=") for kv in shape.split(",") if kv))
    shape_patches(settings)  # rejects unknown keys before anything is built
    return settings, ablation or None


def main(argv) -> int:
    import torch

    import chip_smoke
    from fluxmpi_tpu_torch.ops import _build

    fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
    if not torch.cuda.is_available():
        print("dkv_variants: CUDA is not available", file=sys.stderr)
        return 2
    variants = [a if a.endswith(".cu") else parse(a) for a in argv] or [parse("")]
    print(chip_smoke.card_line(), flush=True)
    libs, failed = build(variants)
    b, s, h, d = SHAPE
    gen = torch.Generator().manual_seed(2)
    dev = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to(dtype).to(dev)
                      for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=True)
        dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        _, ref_dk, ref_dv = fa.flash_attention_bwd_reference(q, k, v, g, lse, dterm,
                                                             causal=True)
        for var, lib in libs.items():
            _build._loaded["flash_bwd_dkv"] = lib
            dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, causal=True)
            torch.cuda.synchronize()
            rel = max((got.float() - ref.float()).abs().max().item()
                      / ref.float().abs().max().item()
                      for got, ref in ((dk, ref_dk), (dv, ref_dv)))
            ms = chip_smoke.device_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, None, None, g, lse, dterm, causal=True), n=4, reps=4)
            ok = rel <= chip_smoke.GRAD_TOL[dname]
            if isinstance(var, str):
                label, ablation = var, None
            else:
                label, ablation = dict(var[0]), var[1]
                if ablation:
                    label["ablation"] = ablation
                    ok = None
            print(json.dumps({"variant": label, "dtype": dname,
                              "ms": ms, "rel_err": rel, "ok": ok}), flush=True)
            if ok is False:
                failed.append(f"{var} {dname}: rel err {rel:.3e}")
        _build._loaded.pop("flash_bwd_dkv", None)
        del q, k, v, g, out, lse, dterm, ref_dk, ref_dv
    if failed:
        print("dkv_variants FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
