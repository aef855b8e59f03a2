#!/usr/bin/env python3
"""Build the three attention kernels from two or more source directories
and time them against each other on one GPU.

    python3 scripts/kernel_ab.py CSRC_A CSRC_B [...] [--rounds N]

Each ``CSRC`` is a directory holding ``flash_fwd.cu``, ``flash_bwd_dq.cu``,
``flash_bwd_dkv.cu`` and their headers: the package's own
(``fluxmpi_tpu_torch/ops/csrc``) or another commit's, unpacked by ``git
archive`` into a git-ignored directory. Every library is compiled with the
package's own ``nvcc`` flags, all at once, into
``fluxmpi_tpu_torch/ops/_build/variants/``, and loaded with ctypes in place
of the package's. At the training shape (b 8, s 1024, h 12, d 64, causal)
in float32 and bfloat16 each source's kernels are held against the plain
versions (``flash_attention_reference``, ``flash_attention_bwd_reference``
fed the forward's ``lse``; the errors as ``chip_smoke.py`` reads them:
``out`` absolute, dQ/dK/dV relative to the plain version's largest
magnitude; in bfloat16 also each output's ``rounding_ratio``, ||kernel -
plain|| / ||bf16(plain) - plain|| with the plain version in float32 on
the same inputs, which is 1 when the kernel adds nothing to the output's
own rounding) and timed by CUDA-graph replay (``chip_smoke.device_ms``), the
sources in turn, then in reverse order, for ``--rounds`` rounds (default
2: A B B A), so that a drift of the card's clock falls on both. Each
source's outputs are also taken with dropout (rate 0.1, seed
``DROPOUT_SEED``) and compared, with and without dropout, bit for bit with
the first source's (``equal_to_first``). Sources from before the kernels
read their dropout seed from device memory (their C entries take it as
an ``unsigned int``) are called through a shim that passes the seed's
value. Prints the card, ptxas's register and spill lines per source, and
one JSON line per source, kernel and type with each round's time. Exits
non-zero if a library fails to build, a kernel exceeds ``chip_smoke.py``'s
tolerances, or, with ``--expect-equal``, an output differs from the first
source's.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE = (8, 1024, 12, 64)  # b, s, h, d
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
DROPOUT_RATE, DROPOUT_SEED = 0.1, 0xC0FFEE11
# Position of the dropout seed among a C entry's arguments, from the end:
# ... dropout, seed, threshold, keep_prob, dtype, stream.
_SEED_FROM_END = 5


def _host_seed_abi(src, name) -> bool:
    """Does ``src``'s entry take the dropout seed as a host integer?"""
    return "unsigned int seed" in (Path(src) / f"{name}.cu").read_text()


def _host_seed_shim(lib, name):
    """``lib`` with its entry ``name`` taking the wrappers' arguments: the
    seed's device address is swapped for ``DROPOUT_SEED``'s value."""
    import ctypes as c

    from fluxmpi_tpu_torch.ops import _build

    raw = getattr(lib, name)
    argtypes = list(_build.SOURCES[name])
    argtypes[-_SEED_FROM_END] = c.c_uint
    raw.argtypes = argtypes

    def entry(*args):
        args = list(args)
        args[-_SEED_FROM_END] = DROPOUT_SEED if args[-_SEED_FROM_END - 1] else 0
        return raw(*args)

    return types.SimpleNamespace(**{name: entry, "device_launches": lib.device_launches})


def build(sources):
    """One nvcc per (source, kernel), all started together; returns
    ``{source: {kernel: CDLL}}`` and the failures."""
    import chip_smoke
    from fluxmpi_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        for name in KERNELS:
            out = out_dir / f"lib{name}-ab{i}.so"
            cmd = _build._command(name, out)
            cmd[-1] = str(Path(src) / f"{name}.cu")
            procs[(src, name)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for (src, name), (out, proc) in procs.items():
        log, _ = proc.communicate()
        for line in chip_smoke.ptxas_summary(log):
            print(f"  {src} {name}: {line}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src} {name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib = ctypes.CDLL(str(out))
        getattr(lib, name).argtypes = _build.SOURCES[name]
        getattr(lib, name).restype = ctypes.c_int
        lib.device_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        if _host_seed_abi(src, name):
            lib = _host_seed_shim(lib, name)
        libs.setdefault(src, {})[name] = lib
    return libs, failed


def rounding_ratios(fa, q, k, v, g, lse, dterm, got) -> dict:
    """For bf16 outputs ``got`` (out, dQ, dK, dV): ||got - plain|| over
    ||bf16(plain) - plain||, the plain versions in f32 on the same (bf16)
    inputs."""
    f = [t.float() for t in (q, k, v, g)]
    want = (fa.flash_attention_reference(*f[:3], causal=True)[0],
            *fa.flash_attention_bwd_reference(*f, lse, dterm, causal=True))
    out = {}
    for label, x, ref in zip(("out", "dq", "dk", "dv"), got, want):
        rounding = (ref.to(x.dtype).float() - ref).norm().item()
        out[label] = (x.float() - ref).norm().item() / rounding
    return out


def main(argv) -> int:
    import torch

    import chip_smoke
    from fluxmpi_tpu_torch.ops import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--expect-equal", action="store_true",
                    help="fail when an output differs from the first source's")
    args = ap.parse_args(argv)
    fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    libs, failed = build(args.sources)
    if failed:
        print("kernel_ab FAILED: " + "\n".join(failed), file=sys.stderr)
        return 1
    b, s, h, d = SHAPE
    gen = torch.Generator().manual_seed(2)
    dev = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to(dtype).to(dev)
                      for _ in range(4))
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
        rows = {}
        for src in args.sources:
            for name, lib in libs[src].items():
                _build._loaded[name] = lib
            out, lse = fa.flash_fwd(q, k, v, causal=True)
            dterm = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
            want = fa.flash_attention_bwd_reference(q, k, v, g, lse, dterm, causal=True)
            dq = fa.flash_bwd_dq(q, k, v, None, None, g, lse, dterm, causal=True)
            dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, g, lse, dterm, causal=True)
            torch.cuda.synchronize()
            err = {"out": (out.float() - ref_out.float()).abs().max().item(),
                   "lse": (lse - ref_lse).abs().max().item()}
            for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                err[label] = ((got.float() - ref.float()).abs().max().item()
                              / ref.float().abs().max().item())
            if dtype == torch.bfloat16:
                err["rounding_ratio"] = rounding_ratios(fa, q, k, v, g, lse, dterm,
                                                        (out, dq, dk, dv))
            tol = chip_smoke.TOL[dname]
            ok = (err["out"] <= tol["out"] and err["lse"] <= tol["lse"]
                  and all(err[x] <= chip_smoke.GRAD_TOL[dname] for x in ("dq", "dk", "dv")))
            if not ok:
                failed.append(f"{src} {dname}: {err}")
            calls = {
                "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal=True),
                "flash_bwd_dq": lambda lse=lse, dterm=dterm: fa.flash_bwd_dq(
                    q, k, v, None, None, g, lse, dterm, causal=True),
                "flash_bwd_dkv": lambda lse=lse, dterm=dterm: fa.flash_bwd_dkv(
                    q, k, v, None, None, g, lse, dterm, causal=True),
            }
            drop = dict(causal=True, dropout_rate=DROPOUT_RATE, seed=DROPOUT_SEED)
            d_out, d_lse = fa.flash_fwd(q, k, v, **drop)
            d_dterm = (g.float() * d_out.float()).sum(-1).permute(0, 2, 1).contiguous()
            outputs = (out, lse, dq, dk, dv, d_out, d_lse,
                       fa.flash_bwd_dq(q, k, v, None, None, g, d_lse, d_dterm, **drop),
                       *fa.flash_bwd_dkv(q, k, v, None, None, g, d_lse, d_dterm, **drop))
            first = rows.get(args.sources[0])
            equal = first is None or all(
                torch.equal(a, b) for a, b in zip(outputs, first["outputs"]))
            if args.expect_equal and not equal:
                failed.append(f"{src} {dname}: outputs differ from {args.sources[0]}'s")
            rows[src] = dict(err=err, ok=ok, calls=calls, ms={n: [] for n in KERNELS},
                             keep=(out, lse, dterm), outputs=outputs, equal=equal)
        order = list(args.sources)
        for _ in range(args.rounds):
            for src in order:
                for name, lib in libs[src].items():
                    _build._loaded[name] = lib
                for name, call in rows[src]["calls"].items():
                    rows[src]["ms"][name].append(chip_smoke.device_ms(call, n=4, reps=4))
            order.reverse()
        for src in args.sources:
            r = rows[src]
            print(json.dumps({"source": src, "dtype": dname, "err": r["err"],
                              "ok": r["ok"], "equal_to_first": r["equal"],
                              "ms": r["ms"]}), flush=True)
        for name in KERNELS:
            _build._loaded.pop(name, None)
        del q, k, v, g, ref_out, ref_lse, rows
        torch.cuda.empty_cache()
    if failed:
        print("kernel_ab FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
