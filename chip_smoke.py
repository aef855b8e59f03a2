#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fluxmpi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of the serving path from ``fluxmpi_tpu_torch/ops/csrc``.
2. Kernel phase: holds ``flash_fwd`` against its plain PyTorch version
   (``flash_attention_reference``) on the card in float32 and bfloat16, at
   the serving path's prefill and decode shapes plus a GQA, a windowed and
   a fully-masked-row case, and times the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it) on the device by CUDA-graph replay, and the
   kernel's eager call as the serving loop makes it.
3. Slice phase: serves 16 requests on a GPT-2-small-width ``TransformerLM``
   (12 layers, d_model 768, 12 heads, d_ff 3072, vocab 50257, max_len 1024,
   float32, TF32 off, weights from ``torch.Generator().manual_seed(0)``)
   through ``InferenceEngine(slots=8, block_size=16, continuous=True)``,
   checks every stream against the port's own ``generate()`` token for
   token, and checks that the kernel's launch counter shows the prefills
   and the decode steps went through it. It then serves the same requests
   once more under ``torch.profiler`` (device activity only) and prints,
   from that one traced run, the device's busy time against the run's wall
   time (idle share), device time by kernel group, and how much longer the
   traced run took than the untraced one.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, without the last line, if CUDA is absent, the
package is missing, or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,   # f32 outside the tensor cores
              "bfloat16": 989e12}  # dense bf16 tensor-core rate
TOL = {"float32": {"out": 2e-5, "lse": 1e-4},
       # bf16 output: one rounding of an f32 value of magnitude < 2 is at
       # most one bf16 ulp (2**-7); lse stays f32 on both sides.
       "bfloat16": {"out": 2e-2, "lse": 1e-4}}

GPT2_SMALL = dict(vocab_size=50257, max_len=1024, num_layers=12, d_model=768,
                  num_heads=12, d_ff=3072, ln_eps=1e-5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph and
    replayed ``reps`` times between CUDA events, so host-side launch cost
    (Python, ctypes) is left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time of one eager call as the serving loop makes it: events around a
    loop of launches, host-side cost included where it exceeds the
    device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases():
    """(name, b, sq, sk, h, h_kv, d, causal, window, segments kind)."""
    return [
        ("prefill_128", 1, 128, 128, 12, 12, 64, True, None, None),
        ("prefill_256", 1, 256, 256, 12, 12, 64, True, None, None),
        ("decode_1024", 8, 1, 1024, 12, 12, 64, False, None, "prefix"),
        ("gqa", 2, 192, 192, 12, 4, 64, True, None, None),
        ("window", 2, 256, 256, 12, 12, 64, True, 48, None),
        ("masked_row", 2, 128, 128, 12, 12, 64, True, None, "masked_row"),
    ]


def make_inputs(case, dtype, gen, device):
    import torch

    name, b, sq, sk, h, hkv, d, causal, window, seg = case
    q = torch.randn(b, sq, h, d, generator=gen)
    k = torch.randn(b, sk, hkv, d, generator=gen)
    v = torch.randn(b, sk, hkv, d, generator=gen)
    qseg = kseg = None
    if seg == "prefix":
        lens = torch.tensor([1, 17, 64, 65, 200, 513, 777, 1024])[:b]
        dead = torch.arange(sk)[None] >= lens[:, None]
        # Large finite garbage where the kernel must read nothing.
        k[dead] = torch.empty(int(dead.sum()), hkv, d).uniform_(-1e4, 1e4, generator=gen)
        v[dead] = torch.empty(int(dead.sum()), hkv, d).uniform_(-1e4, 1e4, generator=gen)
        qseg = torch.ones(b, sq, dtype=torch.int32)
        kseg = (~dead).to(torch.int32)
    elif seg == "masked_row":
        qseg = torch.ones(b, sq, dtype=torch.int32)
        qseg[0, 7] = 5          # a query row whose segment no key carries
        kseg = torch.ones(b, sk, dtype=torch.int32)
        kseg[1, :] = 0          # a batch row whose keys are all padding
    to = dict(device=device)
    q, k, v = (t.to(dtype).to(**to) for t in (q, k, v))
    if qseg is not None:
        qseg, kseg = qseg.to(**to), kseg.to(**to)
    return q, k, v, qseg, kseg


def bound(case, dtype, qseg, kseg):
    """Least time for the work: each input byte read once, each output
    byte written once, counting only the K/V rows some query attends,
    against 4 flops per attendable (q, k) pair per head and head dim."""
    import torch

    name, b, sq, sk, h, hkv, d, causal, window, seg = case
    item = torch.empty((), dtype=dtype).element_size()
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(sk)[None, :]
    mask = torch.ones(b, sq, sk, dtype=torch.bool)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= qi - kj < window
    if qseg is not None:
        qs, ks = qseg.cpu(), kseg.cpu()
        mask &= (qs[:, :, None] == ks[:, None, :]) & (ks[:, None, :] != 0)
    pairs = int(mask.sum()) * h
    live_keys = int(mask.any(dim=1).sum())
    nbytes = (2 * b * sq * h * d * item        # q in, out
              + 2 * live_keys * hkv * d * item  # live k, v
              + b * h * sq * 4)                 # lse
    if qseg is not None:
        nbytes += 4 * b * (sq + sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * pairs * d / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, case, qseg, kseg):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch
    import torch.nn.functional as F

    name, b, sq, sk, h, hkv, d, causal, window, seg = case
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if window is not None or seg is not None:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (qi >= kj)
        if window is not None:
            mask = mask & (qi - kj < window)
        mask = mask[None, None]
        if seg is not None:
            sm = (qseg[:, :, None] == kseg[:, None, :]) & (kseg[:, None, :] != 0)
            mask = mask & sm[:, None]
    gqa = hkv != h
    if mask is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


def kernel_phase(device):
    import torch

    from fluxmpi_tpu_torch.ops.flash_attention import flash_attention_reference, flash_fwd

    gen = torch.Generator().manual_seed(1)
    rows, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case in kernel_cases():
            name, b, sq, sk, h, hkv, d, causal, window, seg = case
            q, k, v, qseg, kseg = make_inputs(case, dtype, gen, device)
            out, lse = flash_fwd(q, k, v, qseg, kseg, causal=causal, window=window)
            ref_out, ref_lse = flash_attention_reference(
                q, k, v, causal=causal, window=window, q_seg=qseg, kv_seg=kseg)
            torch.cuda.synchronize()
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            finite = bool(torch.isfinite(out.float()).all()) and out.shape == q.shape
            if seg == "masked_row":
                finite = finite and bool((out[0, 7] == 0).all()) and bool((out[1] == 0).all()) \
                    and bool((lse[0, :, 7] == -1e30).all()) and bool((lse[1] == -1e30).all())
            tol = TOL[dname]
            ok = finite and err_out <= tol["out"] and err_lse <= tol["lse"]
            kernel = lambda: flash_fwd(q, k, v, qseg, kseg, causal=causal, window=window)  # noqa: E731
            ms = device_ms(kernel)
            call_ms = eager_ms(kernel)
            plain_ms = device_ms(lambda: flash_attention_reference(
                q, k, v, causal=causal, window=window, q_seg=qseg, kv_seg=kseg))
            library_ms = device_ms(sdpa_call(q, k, v, case, qseg, kseg))
            bound_ms, bound_by = bound(case, dtype, qseg, kseg)
            row = dict(case=name, dtype=dname, shape=[b, sq, sk, h, hkv, d],
                       causal=causal, window=window, segments=seg,
                       err_out=err_out, err_lse=err_lse, tol_out=tol["out"],
                       tol_lse=tol["lse"], ok=ok, ms=ms, eager_ms=call_ms,
                       plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print(f"kernel flash_fwd {name:12s} {dname:8s} err_out={err_out:.3e} "
                  f"(tol {tol['out']:g}) err_lse={err_lse:.3e} (tol {tol['lse']:g}) "
                  f"ms={ms:.4f} eager_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"flash_fwd {name} {dname}")
    return rows, failures


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "attention (flash_fwd)"
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "matmul")):
        return "matmul"
    if any(t in n for t in ("index", "gather", "scatter")):
        return "index/gather/scatter (paged cache, embedding)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "reduce" in n or "argmax" in n:
        return "reductions (argmax)"
    if "copy" in n or "memcpy" in n or "memset" in n or "fill" in n:
        return "copies and fills"
    return "elementwise and other"


def profile_phase(engine, specs, steps_before: int, untraced_ms: float):
    """Serve the same requests again under ``torch.profiler`` (device
    activity only). Busy time and wall time come from this one traced run;
    the tracer's own host cost lengthens the wall, reported against the
    untraced run's ``untraced_ms``. Returns the stats and the requests."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, n) for p, n in specs]
        summary = engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, groups = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        g = _kernel_group(evt.name)
        groups[g] = groups.get(g, 0.0) + (end - start) / 1e3
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    busy_ms = busy_us / 1e3
    steps = summary["decode_steps"] - steps_before
    out = dict(wall_ms=wall_ms, untraced_wall_ms=untraced_ms,
               device_busy_ms=busy_ms, kernels=len(spans), decode_steps=steps,
               idle_share=(1 - busy_ms / wall_ms) if spans else None,
               device_ms_by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])))
    if not spans:
        print("profile: the trace holds no device time (not measured)", flush=True)
        return out, reqs
    print(f"profile: traced run: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle share {out['idle_share']:.3f}); the untraced run took "
          f"{untraced_ms:.3f} ms; {len(spans)} kernels, {steps} decode steps",
          flush=True)
    for g, ms in out["device_ms_by_group"].items():
        print(f"profile:   {g:48s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of busy", flush=True)
    return out, reqs


def slice_phase(device):
    import numpy as np
    import torch

    from fluxmpi_tpu_torch.models import TransformerLM, generate
    from fluxmpi_tpu_torch.ops.flash_attention import flash_fwd
    from fluxmpi_tpu_torch.serving import InferenceEngine

    failures = []
    vocab = GPT2_SMALL["vocab_size"]
    t0 = time.perf_counter()
    model = TransformerLM(**GPT2_SMALL, attention="flash", dtype=torch.float32,
                          device=device, generator=torch.Generator().manual_seed(0))
    print(f"slice: GPT-2-small widths {GPT2_SMALL}, float32, TF32 off, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.2f}s", flush=True)

    # The model's forward through the kernel agrees with the dense attend.
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, vocab, (2, 40))).to(device)
    flash_logits = model(toks)
    naive_logits = model(toks, attention="naive")
    fwd_err = (flash_logits - naive_logits).abs().max().item()
    fwd_ok = bool(torch.isfinite(flash_logits).all()) and \
        flash_logits.shape == (2, 40, vocab) and fwd_err <= 1e-3
    print(f"slice: forward flash vs naive attention max_abs_err={fwd_err:.3e} "
          f"(tol 1e-3) {'ok' if fwd_ok else 'FAIL'}", flush=True)
    if not fwd_ok:
        failures.append("slice forward")

    engine = InferenceEngine(model, slots=8, block_size=16, continuous=True)
    rng = np.random.default_rng(0)
    specs = []
    for i in range(16):
        plen = int(rng.integers(8, 201))
        specs.append((rng.integers(0, vocab, plen).astype(np.int32),
                      64 if i % 8 == 7 else 16))
    engine.warmup(prompt_lengths=tuple(len(p) for p, _ in specs))
    torch.cuda.synchronize()

    flash_fwd.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, n) for p, n in specs]
    summary = engine.run()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_fwd.launches
    ttft = np.array([r.ttft_s for r in reqs])
    need = model.num_layers * (engine.prefills + summary["decode_steps"])
    print(f"slice: served {summary['completed']}/16 requests, "
          f"{summary['tokens']} tokens in {summary['wall_seconds']:.3f}s = "
          f"{summary['tokens_per_sec']:.1f} tokens/s; decode_steps="
          f"{summary['decode_steps']} prefills={engine.prefills}; TTFT "
          f"p50={np.median(ttft) * 1e3:.1f}ms max={ttft.max() * 1e3:.1f}ms "
          f"mean={ttft.mean() * 1e3:.1f}ms; flash_fwd launches={launches} "
          f"(need >= {need})", flush=True)
    if summary["completed"] != 16:
        failures.append("slice: not every request completed")
    if launches < need or launches == 0:
        failures.append(f"slice: flash_fwd launched {launches} < {need}")

    mismatched = 0
    for r, (p, n) in zip(reqs, specs):
        ref = generate(model, p[None], n)[0, len(p):].cpu().numpy()
        if not np.array_equal(np.asarray(r.tokens), ref):
            mismatched += 1
            print(f"slice: request {r.id} differs from generate(): "
                  f"{r.tokens} vs {ref.tolist()}", flush=True)
    print(f"slice: {16 - mismatched}/16 streams equal generate() token for token",
          flush=True)
    if mismatched:
        failures.append(f"slice: {mismatched} streams differ from generate()")
    stats = dict(tokens_per_sec=summary["tokens_per_sec"],
                 ttft_p50_ms=float(np.median(ttft) * 1e3),
                 ttft_max_ms=float(ttft.max() * 1e3),
                 decode_steps=summary["decode_steps"], prefills=engine.prefills,
                 launches=launches, tokens=summary["tokens"],
                 wall_seconds=summary["wall_seconds"])
    stats["profile"], traced = profile_phase(engine, specs, summary["decode_steps"],
                                             untraced_ms)
    if stats["profile"]["idle_share"] is None:
        failures.append("profile: the trace holds no device time")
    if [r.tokens for r in traced] != [r.tokens for r in reqs]:
        failures.append("profile: the traced run's streams differ from the first run's")
    engine.close()
    return stats, failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "fluxmpi_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: fluxmpi_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; TF32 off", flush=True)

    from fluxmpi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows, failures = kernel_phase(device)
    stats, slice_failures = slice_phase(device)
    failures += slice_failures

    main_row = next(r for r in rows if r["case"] == "decode_1024" and r["dtype"] == "float32")
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "fluxmpi_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "fluxmpi_tpu/ops/flash_attention.py:185",
        "launches": stats["launches"],
        "max_abs_err": max(max(r["err_out"], r["err_lse"]) for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "timed_case": "decode_1024 float32",
        "cases": rows,
    }]
    print(json.dumps({"kernels": kernels, "slice": stats, "card": card}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
