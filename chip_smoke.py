#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fluxmpi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds every
   CUDA kernel of the port from ``fluxmpi_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together), and counts each library's
   tensor-core instructions (``HMMA``/``HGMMA`` in ``cuobjdump -sass``):
   each of the three kernels must have some. Every kernel's bound
   is the larger of its bytes at 3.35 TB/s and its products at the tensor
   cores' rate: 989 TFLOP/s for bf16, 495 / 3 TFLOP/s for f32 (three TF32
   products per f32-accurate product); f32 rows also carry the bound at
   67 TFLOP/s of f32 FMAs.
2. Forward kernel phase: holds ``flash_fwd`` against its plain PyTorch
   version (``flash_attention_reference``) on the card in float32 and
   bfloat16, at the serving path's prefill and decode shapes, the training
   shape, a GQA, a windowed, a fully-masked-row and a dropout case, and
   times the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it) on the device by CUDA-graph replay, and the
   kernel's eager call as the serving loop makes it.
3. Backward kernel phase: holds ``flash_bwd_dq`` and ``flash_bwd_dkv``,
   fed the forward kernel's ``lse`` and the torch ``dterm = rowsum(dO *
   O) - dlse``, against ``flash_attention_bwd_reference`` (the backward
   written as formulas) in float32 and bfloat16: the training shape, GQA
   12 -> 4, window 128, packed segments with padding, rows with no key,
   ``dlse != 0``, dropout 0.1 and the two zoo shapes; checks that each of
   the three kernels' dropout keep masks equals ``dropout_keep_reference``
   bit for bit; and times both kernels, dterm, the plain backward and the
   backward of ``scaled_dot_product_attention`` (yardstick; CUDA-graph
   replay too, the median of 5 replays, each printed) at the training
   shape and the zoo shapes.
4. Serving phase: serves 16 requests on a GPT-2-small-width
   ``TransformerLM`` (12 layers, d_model 768, 12 heads, d_ff 3072, vocab
   50257, max_len 1024, float32, TF32 off, weights from
   ``torch.Generator().manual_seed(0)``) through
   ``InferenceEngine(slots=8, block_size=16, continuous=True)``, checks
   every stream against the port's own ``generate()`` token for token and
   that the prefills and decode steps went through ``flash_fwd``; then
   serves the same requests once more under ``torch.profiler`` (device
   activity only): device busy time against wall time (idle share) and
   device time by kernel group from that one traced run.
5. Training phase: the user's data-parallel script at the same widths
   (``attention="flash"``, dropout 0): ``init()`` (one worker, NCCL) ->
   ``synchronize(model)`` -> the synthetic corpus of
   ``examples/lm_pretrain.py`` (256 sequences of 1025 tokens, t -> 3t + 1
   mod V) through ``ArrayDataset`` -> ``DistributedDataContainer`` ->
   ``DistributedDataLoader(global_batch_size=8, shuffle=True)`` ->
   ``make_train_step(mean per-token loss, optim.adamw(3e-4))`` ->
   ``train_loop(steps=20, flush_every=10)``. Checks that each attention
   kernel launched 12 times per update, that the loss is finite and its
   mean over the last flush interval lower than over the first, and that
   one update's gradients
   through the kernels agree with the same update through the plain
   versions leaf by leaf; then traces a few more updates (device busy,
   wall, idle share, device time by kernel group).
6. bf16 phase: the same widths with ``dtype=torch.bfloat16`` (f32
   parameters and adamw moments, bf16 compute): 20 uninterrupted updates
   (each kernel launched 12 times per update with bf16 inputs, the mean
   loss falls), one update's gradients through the kernels against the
   plain versions; the same run with ``save_every=5`` into an async
   ``CheckpointManager(max_to_keep=2)`` in a temporary directory, killed by
   the fault ``data.fetch@step=13`` (it must raise
   ``FaultInjectedError``), then resumed by a fresh model, step, loader and
   manager (``resumed_from`` 10, the reference's counters, every parameter
   and moment bit-identical); the blocking and background seconds of a
   save, the bytes and a restore; 3 traced updates; and 3 updates each
   with ``remat=True`` and ``remat="dots"`` beside 3 without (every
   parameter and moment and every loss bit-identical, 24 ``flash_fwd``
   launches per update, the peak memory of each); ``flush_every=1``
   divides the epoch, so these run as one-update CUDA-graph windows.
7. Fused phase (``fused_phase``): the bf16 script with ``train_loop``'s
   default ``fuse="auto"`` over the device-gather loader,
   ``steps=32, flush_every=8``: 4 windows of 8 updates, the first eager,
   the second captured as a CUDA graph, each later one a replay; gates:
   ``fused_window`` 8, 4 dispatches, at least 3 replays, 12 launches of
   each kernel per update (counted by the kernels' own device counters,
   and equal to the wrappers' counts less the captures' plus the
   replays'), every parameter, adamw moment, the count
   and every flush's loss bit-identical to the same run with
   ``fuse=False``; a ``fuse=False`` run killed by ``data.fetch@step=6``
   with ``save_every=3`` resumes fused (one short realignment window) to
   the same bits. Prints, for both paths, ms per update and tokens/s (from
   a second, untraced run of 32 updates), the idle share of a traced
   window, host launch calls per update, capture seconds and peak memory.
8. Telemetry phase (``telemetry_phase``): the fused bf16 run once with
   every plane off and once under ``init(telemetry=<jsonl>, trace=<path>,
   goodput=True, memory=True, watchdog=...)`` with a ``TrainingMonitor``
   as ``metrics=``; gates: the JSONL and the trace export pass
   ``scripts/check_metrics_schema.py`` and ``scripts/goodput_report.py``
   reads the stream (subprocesses); ``train.steps`` 32,
   ``train.window.size`` 8, ``train.window.dispatches`` the loop's
   dispatches; every parameter and moment bit-identical to the planes-off
   run; ``goodput.mfu`` in (0, 1] and within 5% of counted FLOPs per update
   x updates / (the loop's seconds x 989.4e12); ``memory.peak_bytes_in_use``
   within 1% of ``torch.cuda.max_memory_allocated()``; at most one more host
   launch call per update than planes off; 12 launches of each kernel per
   update. Then the watchdog fires on a ``data.fetch`` delay and on the
   main thread waiting in ``torch.cuda.synchronize()`` behind a spinning
   kernel, each dump valid and naming the stalled call.
9. Vision phase (``vision_phase``; no hand-written kernel on its path:
   convolutions are cuDNN's, BatchNorm is plain PyTorch ops): ResNet-50
   (``num_classes=1000``, bf16 compute, f32 parameters and statistics) on
   1024 synthetic 224x224x3 uint8 images in the device-gather loader,
   batch 128, ``sgd(0.1, momentum=0.9)``, ``train_loop(steps=32,
   flush_every=8)`` with ``fuse="auto"`` beside ``fuse=False``: every
   parameter, momentum buffer, BatchNorm statistic and flush loss
   bit-identical, every statistic moved, the losses finite and the last
   flush's mean below the first's; the card against the CPU path in f32
   with TF32 off on a batch of 4: the whole model at the seeded initial
   weights (logits, loss, every gradient and statistic within 1e-3 per
   leaf) and every convolution, BatchNorm and the head alone at the
   trained weights against f64 (within 2e-4); ms per update,
   images/s, the idle share of a traced window, device time by kernel
   group and of the 15 kernels that take most of it, by name, host launch
   calls per update, capture seconds and peak memory
   for both paths. Then the CNN at ``bench.py``'s ``_bench_cnn`` shape
   (batch 256 of 32x32x3, f32, 20 updates: images/s, ms per update, the
   loss falling); the DEQ at ``examples/deq_regression.py``'s widths with
   each solver (its implicit gradient on the card against the CPU's within
   1e-4, 50 updates in one-update CUDA-graph windows halving the loss);
   and at world 1 over NCCL ``synchronize(FluxModelWrapper(...))``, a
   ``FlatParamVector`` synchronized in one broadcast, ``iallreduce`` and
   ``ibcast`` with ``Request.wait`` against the blocking calls,
   ``donate=True``, ``barrier(tag=)`` and the ``host_*`` collectives.
10. Zoo phase (``zoo_phase``): ViT-B/16 (patch 16 on 224x224x3, 12 layers,
   d_model 768, 12 heads, d_ff 3072, 1000 classes, 86,567,656 parameters;
   bf16 compute, ``adamw(1e-3)``, 1024 synthetic uint8 images, batch 128)
   and the DDPM UNet of ``bench.py``'s ``_bench_unet`` (side 32, base 128,
   mults (1, 2, 2, 4), attention at 8, groups 8, 4 heads; bf16,
   ``adam(1e-4)``, ``ddpm_loss`` over ``cosine_beta_schedule(1000)`` with a
   CUDA generator, 512 synthetic images in [-1, 1], batch 64), both with
   ``attention_fn=flash_attention_fn()``, through ``train_loop(steps=32,
   flush_every=8)`` with ``fuse="auto"`` beside ``fuse=False``: every
   parameter, adam moment, count and flush loss bit-identical (so every
   replayed DDPM window drew what the eager updates drew), 12 (ViT) and 6
   (UNet) launches of each kernel per update by the kernels' device
   counters and the wrappers' accounting, the last flush's mean loss below
   the first's; one update's gradients through the kernels against the
   plain versions (bf16 per leaf ||diff||/||g|| <= 2^-8 x 2 x the
   attention layers; f32 at batch 8 per leaf max|diff|/max|g| <= 1e-3; the
   UNet at its seeded weights + 0.1 N(0, 1), every attention kernel's
   gradient nonzero); ViT in f32 on the card against the CPU at batch 4
   (1e-3 per leaf); a ``TransformerEncoder`` at ViT-B's widths with a flax
   padding mask through ``flash_attention_fn`` against the dense masked
   attend; and the UNet's ``ema_init(decay=0.95)`` over 8 more ``step()``
   calls, then ``ddim_sample(num_steps=20)`` of 8 images from the EMA
   weights (finite, within the clip). Times, idle share, host launch calls,
   capture seconds, peak memory, device time by group and the 15 costliest
   kernels for each model and path.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, without the last line, if CUDA is absent, the
package is missing, or any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
# The least time for f32-accurate products: three TF32 tensor-core products
# per f32 product (the kernels' split) at 495 TFLOP/s; bf16 at the dense
# bf16 tensor-core rate.
PEAK_FLOPS = {"float32": 495e12 / 3,
              "bfloat16": 989e12}
BOUND_BASIS = {"float32": "split-TF32 tensor cores, 495/3 TFLOP/s",
               "bfloat16": "bf16 tensor cores, 989 TFLOP/s"}
FMA_FLOPS = 67e12                # f32 FMAs outside the tensor cores, beside it
# Kernels whose SASS must hold tensor-core instructions.
MMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TOL = {"float32": {"out": 2e-5, "lse": 1e-4},
       # bf16 output: one rounding of an f32 value of magnitude < 2 is at
       # most one bf16 ulp (2**-7); lse stays f32 on both sides.
       "bfloat16": {"out": 2e-2, "lse": 1e-4}}
# Gradients, relative to the largest magnitude of the plain version's
# output: f32 sums of up to 1024 products in different orders; bf16 adds
# one rounding of the f32 result (2**-7 relative).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -7 + 1e-4}
# One update's gradients through the kernels against the plain versions,
# per leaf max|diff| / max|g|: the attention differs only in f32
# summation order, carried through 12 layers and 8192 tokens.
TRAIN_GRAD_TOL = 1e-3
# One ResNet-50 layer alone in f32 against f64, max|diff| / max|ref| over
# its output and gradients: sums of up to 50176 products (the stem's
# weight gradient at batch 4); cuDNN's f32 algorithms on an H100 stand at
# most 7.1e-5 from f64 there and TF32 at 9.3e-4 or more
# (scripts/resnet_f32_probe.py).
LAYER_TOL = 2e-4

GPT2_SMALL = dict(vocab_size=50257, max_len=1024, num_layers=12, d_model=768,
                  num_heads=12, d_ff=3072, ln_eps=1e-5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instance in ``nvcc -Xptxas -v`` output: the
    kernel, its type and template integers, its registers and its spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_[a-z_]+_kernel)I(f|13__nv_bfloat16)((?:Li\d+E)+)E", m.group(1))
            name = m.group(1)
            if k:
                args = ["f32" if k.group(2) == "f" else "bf16"] + re.findall(r"Li(\d+)E", k.group(3))
                name = f"{k.group(1)}<{','.join(args)}>"
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers; {spill}")
            name = None
    return lines


def sass_mma_counts(paths) -> dict:
    """Tensor-core instructions (``HMMA`` from mma.sync, ``HGMMA`` from
    wgmma) in each built library's SASS, read by ``cuobjdump -sass``."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    counts = {}
    for name, path in paths.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        ops = []
        for line in sass.splitlines():
            tok = line.split()
            if len(tok) > 2 and tok[0].startswith("/*") and tok[0].endswith("*/"):
                ops.append(tok[2] if tok[1].startswith("@") else tok[1])
        counts[name] = {op: sum(1 for o in ops if o.startswith(op + ".") or o == op)
                        for op in ("HMMA", "HGMMA")}
    return counts


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
    """(name, b, sq, sk, h, h_kv, d, causal, window, segments kind,
    dropout rate)."""
    return [
        ("prefill_128", 1, 128, 128, 12, 12, 64, True, None, None, 0.0),
        ("prefill_256", 1, 256, 256, 12, 12, 64, True, None, None, 0.0),
        ("decode_1024", 8, 1, 1024, 12, 12, 64, False, None, "prefix", 0.0),
        ("train_1024", 8, 1024, 1024, 12, 12, 64, True, None, None, 0.0),
        ("gqa", 2, 192, 192, 12, 4, 64, True, None, None, 0.0),
        ("window", 2, 256, 256, 12, 12, 64, True, 48, None, 0.0),
        ("masked_row", 2, 128, 128, 12, 12, 64, True, None, "masked_row", 0.0),
        ("dropout", 2, 256, 256, 12, 12, 64, True, None, None, 0.1),
        # The zoo's shapes (slice 6), non-causal: ViT-B/16's 197 tokens (a
        # tail in every tile), the UNet's five attentions at 8x8 and its
        # middle one at head dim 128.
        ("vit_197", 128, 197, 197, 12, 12, 64, False, None, None, 0.0),
        ("unet_64", 64, 64, 64, 4, 4, 64, False, None, None, 0.0),
        ("unet_mid_d128", 64, 16, 16, 4, 4, 128, False, None, None, 0.0),
    ]


# The zoo's cases, each with its own row in the kernel table.
ZOO_TABLE_CASES = ("vit_197", "unet_64", "unet_mid_d128")
# The cases whose row in the kernel table carries the plain version's and
# the library's times beside the kernel's.
TABLE_CASES = ("train_1024", *ZOO_TABLE_CASES)


def backward_cases():
    """(name, b, sq, sk, h, h_kv, d, causal, window, segments kind,
    dropout rate), plus whether the lse cotangent is nonzero."""
    return [
        (("train_1024", 8, 1024, 1024, 12, 12, 64, True, None, None, 0.0), False),
        (("gqa", 2, 512, 512, 12, 4, 64, True, None, None, 0.0), False),
        (("window_128", 2, 1024, 1024, 12, 12, 64, True, 128, None, 0.0), False),
        (("packed", 2, 512, 512, 12, 12, 64, True, None, "packed", 0.0), False),
        (("masked_row", 2, 128, 128, 12, 12, 64, True, None, "masked_row", 0.0), False),
        (("dlse", 2, 256, 256, 12, 12, 64, True, None, None, 0.0), True),
        (("dropout", 2, 256, 256, 12, 12, 64, True, None, None, 0.1), False),
        (("vit_197", 128, 197, 197, 12, 12, 64, False, None, None, 0.0), False),
        (("unet_64", 64, 64, 64, 4, 4, 64, False, None, None, 0.0), False),
        (("unet_mid_d128", 64, 16, 16, 4, 4, 128, False, None, None, 0.0), False),
    ]


DROPOUT_SEED = 1234


def make_inputs(case, dtype, gen, device):
    import torch

    name, b, sq, sk, h, hkv, d, causal, window, seg, rate = case
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
    elif seg == "packed":
        # Three documents per row, then trailing padding in the last row.
        qseg = torch.ones(b, sq, dtype=torch.int32)
        qseg[:, sq // 3:] = 2
        qseg[:, 2 * sq // 3:] = 3
        qseg[-1, -sq // 5:] = 0
        kseg = qseg.clone()
    to = dict(device=device)
    q, k, v = (t.to(dtype).to(**to) for t in (q, k, v))
    if qseg is not None:
        qseg, kseg = qseg.to(**to), kseg.to(**to)
    return q, k, v, qseg, kseg


def bound(case, dtype, qseg, kseg, products: int = 2, extra_rows: int = 0,
          peak: float | None = None):
    """Least time for the work: each input byte read once, each output
    byte written once, counting only the K/V rows some query attends,
    against 2 flops per multiply-add of ``products`` [pairs x d] products
    over the attendable (q, k) pairs (2 for the forward: scores and P.V)
    at ``peak`` (default: the type's rate in ``PEAK_FLOPS``).
    ``extra_rows`` counts further [b, sq, h, d] tensors moved (the
    backward's dO and dQ) beside q and the output."""
    import torch

    name, b, sq, sk, h, hkv, d, causal, window, seg, rate = case
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
    nbytes = ((2 + extra_rows) * b * sq * h * d * item  # q, out (+ dO, ...)
              + 2 * live_keys * hkv * d * item         # live k, v
              + b * h * sq * 4)                         # lse
    if qseg is not None:
        nbytes += 4 * b * (sq + sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = peak or PEAK_FLOPS[str(dtype).split(".")[1]]
    t_ops = 2 * products * pairs * d / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, case, qseg, kseg):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch
    import torch.nn.functional as F

    name, b, sq, sk, h, hkv, d, causal, window, seg, rate = case
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


def _timing_counts(case):
    """CUDA-graph sizes: fewer captured calls for the ms-scale shapes."""
    big = case[1] * case[2] * case[3] >= 4 * 1024 * 1024
    return dict(n=4, reps=4) if big else dict(n=20, reps=10)


def kernel_phase(device):
    import torch

    from fluxmpi_tpu_torch.ops.flash_attention import flash_attention_reference, flash_fwd

    gen = torch.Generator().manual_seed(1)
    rows, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case in kernel_cases():
            name, b, sq, sk, h, hkv, d, causal, window, seg, rate = case
            q, k, v, qseg, kseg = make_inputs(case, dtype, gen, device)
            opts = dict(causal=causal, window=window, dropout_rate=rate,
                        seed=DROPOUT_SEED)
            out, lse = flash_fwd(q, k, v, qseg, kseg, **opts)
            ref_out, ref_lse = flash_attention_reference(q, k, v, q_seg=qseg,
                                                         kv_seg=kseg, **opts)
            torch.cuda.synchronize()
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            finite = bool(torch.isfinite(out.float()).all()) and out.shape == q.shape
            if seg == "masked_row":
                finite = finite and bool((out[0, 7] == 0).all()) and bool((out[1] == 0).all()) \
                    and bool((lse[0, :, 7] == -1e30).all()) and bool((lse[1] == -1e30).all())
            tol = TOL[dname]
            ok = finite and err_out <= tol["out"] and err_lse <= tol["lse"]
            kernel = lambda: flash_fwd(q, k, v, qseg, kseg, **opts)  # noqa: E731
            counts = _timing_counts(case)
            ms = device_ms(kernel, **counts)
            call_ms = eager_ms(kernel)
            plain_ms = device_ms(lambda: flash_attention_reference(
                q, k, v, q_seg=qseg, kv_seg=kseg, **opts), **counts)
            # A dropping SDPA draws its own random mask: no yardstick there.
            library_ms = None if rate else device_ms(
                sdpa_call(q, k, v, case, qseg, kseg), **counts)
            bound_ms, bound_by = bound(case, dtype, qseg, kseg)
            row = dict(case=name, dtype=dname, shape=[b, sq, sk, h, hkv, d],
                       causal=causal, window=window, segments=seg, dropout=rate,
                       err_out=err_out, err_lse=err_lse, tol_out=tol["out"],
                       tol_lse=tol["lse"], ok=ok, ms=ms, eager_ms=call_ms,
                       plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_basis=BOUND_BASIS[dname])
            if dtype == torch.float32:
                row["fma_bound_ms"] = bound(case, dtype, qseg, kseg, peak=FMA_FLOPS)[0]
            rows.append(row)
            lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
            print(f"kernel flash_fwd {name:12s} {dname:8s} err_out={err_out:.3e} "
                  f"(tol {tol['out']:g}) err_lse={err_lse:.3e} (tol {tol['lse']:g}) "
                  f"ms={ms:.4f} eager_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}; {BOUND_BASIS[dname]}) "
                  f"{'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"flash_fwd {name} {dname}")
            del q, k, v, out, lse, ref_out, ref_lse
    return rows, failures


def sdpa_backward_call(q, k, v, g, case):
    """The backward of ``scaled_dot_product_attention`` at the same causal
    shape (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    causal = case[7]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


def sdpa_backward_ms(q, k, v, g, case, n: int = 10, repeats: int = 5):
    """Device time of one SDPA backward (the yardstick), as the kernels are
    timed: the forward runs once on a side stream, ``n`` calls of
    ``torch.autograd.grad`` on that stream are captured in a CUDA graph (the
    backward runs on its forward's stream), and the graph is replayed
    ``repeats`` times, each replay between CUDA events. Returns the median
    ms per call and the repeats' ms."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call = sdpa_backward_call(q, k, v, g, case)
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times), times


def dropout_mask_check(device):
    """Each kernel's dropout keep mask, read off its output, against
    ``dropout_keep_reference``: with q = 0 every live probability is equal
    and nonzero, and identity matrices as V (forward), K (dQ) and dO (dV)
    copy the dropped probabilities into the output, so an entry is nonzero
    iff the kernel kept it. Returns {kernel: masks equal}."""
    import torch

    from fluxmpi_tpu_torch.ops.flash_attention import (dropout_keep_reference,
                                                       flash_bwd_dkv, flash_bwd_dq,
                                                       flash_fwd)

    b, h, s, d, rate = 2, 12, 128, 128, 0.1
    eye = torch.eye(s, device=device).expand(b, h, s, d).permute(0, 2, 1, 3).contiguous()
    zeros = torch.zeros(b, s, h, d, device=device)
    keep = dropout_keep_reference(
        DROPOUT_SEED, torch.arange(b * h, device=device).reshape(b, h, 1, 1),
        torch.arange(s, device=device).reshape(1, 1, s, 1),
        torch.arange(s, device=device).reshape(1, 1, 1, s), 1 - rate)
    opts = dict(dropout_rate=rate, seed=DROPOUT_SEED)
    lse = torch.zeros(b, h, s, device=device)
    dterm = torch.zeros(b, h, s, device=device)
    ones = torch.zeros(b, s, h, d, device=device)
    ones[..., 0] = 1.0
    out, _ = flash_fwd(zeros, zeros, eye, **opts)
    dq = flash_bwd_dq(zeros, eye, ones, None, None, ones, lse, dterm, **opts)
    _, dv = flash_bwd_dkv(zeros, zeros, zeros, None, None, eye, lse, dterm, **opts)
    torch.cuda.synchronize()
    return {"flash_fwd": bool(torch.equal(out.permute(0, 2, 1, 3) != 0, keep)),
            "flash_bwd_dq": bool(torch.equal(dq.permute(0, 2, 1, 3) != 0, keep)),
            "flash_bwd_dkv": bool(torch.equal(dv.permute(0, 2, 3, 1) != 0, keep)),
            "keep_fraction": keep.float().mean().item()}


def backward_phase(device):
    import torch

    from fluxmpi_tpu_torch.ops.flash_attention import (flash_attention_bwd_reference,
                                                       flash_bwd_dkv, flash_bwd_dq,
                                                       flash_fwd)

    gen = torch.Generator().manual_seed(2)
    rows, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case, with_dlse in backward_cases():
            name, b, sq, sk, h, hkv, d, causal, window, seg, rate = case
            q, k, v, qseg, kseg = make_inputs(case, dtype, gen, device)
            g = torch.randn(b, sq, h, d, generator=gen).to(dtype).to(device)
            opts = dict(causal=causal, window=window, dropout_rate=rate,
                        seed=DROPOUT_SEED)
            out, lse = flash_fwd(q, k, v, qseg, kseg, **opts)
            dlse = (torch.randn(b, h, sq, generator=gen).to(device) if with_dlse
                    else torch.zeros(b, h, sq, device=device))

            def dterm_fn():
                return ((g.float() * out.float()).sum(-1).permute(0, 2, 1)
                        - dlse).contiguous()

            dterm = dterm_fn()
            dq = flash_bwd_dq(q, k, v, qseg, kseg, g, lse, dterm, **opts)
            dk, dv = flash_bwd_dkv(q, k, v, qseg, kseg, g, lse, dterm, **opts)
            want = flash_attention_bwd_reference(q, k, v, g, lse, dterm, q_seg=qseg,
                                                 kv_seg=kseg, **opts)
            torch.cuda.synchronize()
            errs, rels, ok = {}, {}, True
            for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                diff = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                errs[label] = diff
                rels[label] = diff / scale if scale else diff
                ok = ok and bool(torch.isfinite(got.float()).all()) \
                    and got.dtype == dtype and diff <= GRAD_TOL[dname] * scale + 1e-6
            if seg == "masked_row":
                ok = ok and bool((dq[0, 7] == 0).all()) and bool((dq[1] == 0).all())
            counts = _timing_counts(case)
            dq_ms = device_ms(lambda: flash_bwd_dq(q, k, v, qseg, kseg, g, lse, dterm,
                                                   **opts), **counts)
            dkv_ms = device_ms(lambda: flash_bwd_dkv(q, k, v, qseg, kseg, g, lse, dterm,
                                                     **opts), **counts)
            row = dict(case=name, dtype=dname, shape=[b, sq, sk, h, hkv, d],
                       causal=causal, window=window, segments=seg, dropout=rate,
                       dlse=with_dlse, err=errs, rel_err=rels,
                       tol_rel=GRAD_TOL[dname], ok=ok, dq_ms=dq_ms, dkv_ms=dkv_ms)
            row["dq_bound_ms"], row["dq_bound_by"] = bound(
                case, dtype, qseg, kseg, products=3, extra_rows=1)
            row["dkv_bound_ms"], row["dkv_bound_by"] = bound(
                case, dtype, qseg, kseg, products=4, extra_rows=1)
            row["bound_basis"] = BOUND_BASIS[dname]
            if dtype == torch.float32:
                row["dq_fma_bound_ms"] = bound(case, dtype, qseg, kseg, products=3,
                                               extra_rows=1, peak=FMA_FLOPS)[0]
                row["dkv_fma_bound_ms"] = bound(case, dtype, qseg, kseg, products=4,
                                                extra_rows=1, peak=FMA_FLOPS)[0]
            if name in TABLE_CASES:
                row["dterm_ms"] = device_ms(dterm_fn, **counts)
                row["plain_ms"] = device_ms(lambda: flash_attention_bwd_reference(
                    q, k, v, g, lse, dterm, q_seg=qseg, kv_seg=kseg, **opts), **counts)
                row["library_ms"], row["library_ms_repeats"] = sdpa_backward_ms(
                    q, k, v, g, case)
                row["sum_ms"] = row["dterm_ms"] + dq_ms + dkv_ms
            rows.append(row)
            extra = ""
            if "plain_ms" in row:
                extra = (f" dterm_ms={row['dterm_ms']:.4f} sum_ms={row['sum_ms']:.4f} "
                         f"plain_ms={row['plain_ms']:.4f} "
                         f"library_ms(sdpa bwd)={row['library_ms']:.4f} (median of "
                         f"{len(row['library_ms_repeats'])} graph replays: "
                         + " ".join(f"{t:.4f}" for t in row["library_ms_repeats"]) + ")")
            print(f"kernel flash_bwd {name:12s} {dname:8s} "
                  + " ".join(f"err_{kk}={vv:.3e}(rel {rels[kk]:.2e})" for kk, vv in errs.items())
                  + f" (tol rel {GRAD_TOL[dname]:.2e}) dq_ms={dq_ms:.4f} "
                  f"(bound {row['dq_bound_ms']:.4f} {row['dq_bound_by']}) "
                  f"dkv_ms={dkv_ms:.4f} (bound {row['dkv_bound_ms']:.4f} "
                  f"{row['dkv_bound_by']}; {BOUND_BASIS[dname]}){extra} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"flash_bwd {name} {dname}")
            del q, k, v, g, out, lse, dq, dk, dv, want
    masks = dropout_mask_check(device)
    print(f"kernel dropout keep masks equal dropout_keep_reference bit for bit: "
          f"{masks}", flush=True)
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if not masks[kname]:
            failures.append(f"{kname}: dropout keep mask differs from the reference")
    return rows, masks, failures


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "attention forward (flash_fwd)"
    if "flash_bwd_dq" in n:
        return "attention backward dQ (flash_bwd_dq)"
    if "flash_bwd_dkv" in n:
        return "attention backward dK/dV (flash_bwd_dkv)"
    if "nccl" in n:
        return "collectives (NCCL)"
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "matmul", "sm90_")):
        return "matmul"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (multi-tensor)"
    if any(t in n for t in ("index", "gather", "scatter")):
        return "index/gather/scatter (paged cache, embedding)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "reduce" in n or "argmax" in n:
        return "reductions"
    if "copy" in n or "memcpy" in n or "memset" in n or "fill" in n or "cat" in n:
        return "copies and fills"
    return "elementwise and other"


def _vision_group(name: str) -> str:
    """The vision phase's kernel groups, by PyTorch's and cuDNN's kernel
    names: the model computes in bf16 and BatchNorm in f32, so f32
    elementwise kernels are BatchNorm's and bf16 ones relu's and the
    residual adds'."""
    n = name.lower()
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                            "cudnn", "xmma", "sm90_", "gemm", "cutlass")):
        return "convolutions (cuDNN) and matmuls"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (multi-tensor)"
    if "nccl" in n:
        return "collectives (NCCL)"
    if "pool" in n:
        return "max pool"
    if "copy" in n:
        return "casts (bf16 <-> f32) and layout copies"
    if "reduce_kernel" in n:
        return "reductions (BatchNorm statistics, scale and bias gradients)"
    if "elementwise" in n and ("bfloat16" in n or "elementwise_kernel<8," in n):
        # (a vector of 8 holds 16 bytes of a 2-byte type: bf16 here)
        return "bf16 elementwise (relu, residual adds)"
    if "elementwise" in n:
        return "f32 elementwise (BatchNorm arithmetic)"
    if any(t in n for t in ("memset", "fill", "cat", "index", "pad")):
        return "fills, pads and gathers"
    return "other"


def traced(run, group=_kernel_group):
    """Run ``run()`` under ``torch.profiler`` (device activity only);
    returns ``(run's result, device busy ms, wall ms, kernel count, device
    ms by kernel group)``, busy and wall from this one traced run, kernels
    grouped by ``group(name)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, groups = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        g = group(evt.name)
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
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    return result, busy_us / 1e3, wall_ms, len(spans), groups


# CUDA API calls (runtime and low-level) that launch work on the device.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaLaunchCooperativeKernel")


def host_launches(run):
    """Run ``run()`` under ``torch.profiler`` with host activity and count
    the host's launch calls (``_LAUNCH_CALLS``: kernel launches and CUDA
    graph launches; a graph launch is one call for all its kernels).
    Returns ``(run's result, launch calls, device kernels)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    calls = kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
        elif evt.name in _LAUNCH_CALLS:
            calls += 1
    return result, calls, kernels


def kernel_launches(run):
    """Run ``run()`` and count the attention kernels' launches the device
    ran, CUDA-graph replays included, from the kernels' own device counters
    (``device_launches``; zeroed just before, read just after). Returns
    ``(run's result, {kernel: count})``."""
    from fluxmpi_tpu_torch.ops import device_launches

    device_launches(reset=True)
    result = run()
    return result, device_launches()


def graph_launches(step) -> dict:
    """Per kernel, what the CUDA graphs of ``step``'s fused windows add to
    the wrappers' counters to give the launches the device ran: each
    capture raised the counters and launched nothing, each replay launched
    the graph's kernels without the wrappers."""
    out = {name: 0 for name in MMA_KERNELS}
    for prog in getattr(step, "__fluxmpi_window_cache__", {}).values():
        for name in out:
            out[name] += (prog.replayed_launches.get(name, 0)
                          - prog.capture_counted.get(name, 0))
    return out


def graph_stats(step) -> list:
    """Each window program of ``step``: width, whether a graph was
    captured, the launches captured per kernel, replays and capture
    seconds."""
    return [dict(width=p.width, captured=p.graph is not None,
                 captured_launches=p.captured_launches, replays=p.replays,
                 replayed_launches=dict(p.replayed_launches),
                 capture_seconds=p.capture_seconds)
            for p in getattr(step, "__fluxmpi_window_cache__", {}).values()]


def profile_phase(engine, specs, steps_before: int, untraced_ms: float):
    """Serve the same requests again under ``torch.profiler`` (device
    activity only). Busy time and wall time come from this one traced run;
    the tracer's own host cost lengthens the wall, reported against the
    untraced run's ``untraced_ms``. Returns the stats and the requests."""

    def serve():
        reqs = [engine.submit(p, n) for p, n in specs]
        return reqs, engine.run()

    (reqs, summary), busy_ms, wall_ms, nk, groups = traced(serve)
    steps = summary["decode_steps"] - steps_before
    out = dict(wall_ms=wall_ms, untraced_wall_ms=untraced_ms,
               device_busy_ms=busy_ms, kernels=nk, decode_steps=steps,
               idle_share=(1 - busy_ms / wall_ms) if nk else None,
               device_ms_by_group=groups)
    if not nk:
        print("profile: the trace holds no device time (not measured)", flush=True)
        return out, reqs
    print(f"profile: traced run: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle share {out['idle_share']:.3f}); the untraced run took "
          f"{untraced_ms:.3f} ms; {nk} kernels, {steps} decode steps",
          flush=True)
    for g, ms in groups.items():
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
    with torch.no_grad():
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


class plain_attention:
    """Route the attention wrappers to their plain versions (on the same
    CUDA tensors) for the duration of the block, counting no launches:
    the comparison run of the training phase."""

    def __enter__(self):
        import importlib

        fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
        self.fa = fa
        self.saved = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        ref, bwd = fa.flash_attention_reference, fa.flash_attention_bwd_reference

        def fwd(q, k, v, q_seg=None, kv_seg=None, **opts):
            return ref(q, k, v, q_seg=q_seg, kv_seg=kv_seg, **opts)

        def dq(q, k, v, q_seg, kv_seg, g, lse, dterm, **opts):
            return bwd(q, k, v, g, lse, dterm, q_seg=q_seg, kv_seg=kv_seg, **opts)[0]

        def dkv(q, k, v, q_seg, kv_seg, g, lse, dterm, **opts):
            return bwd(q, k, v, g, lse, dterm, q_seg=q_seg, kv_seg=kv_seg, **opts)[1:]

        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = fwd, dq, dkv
        return self

    def __exit__(self, *exc):
        self.fa.flash_fwd, self.fa.flash_bwd_dq, self.fa.flash_bwd_dkv = self.saved
        return False


def lm_corpus(vocab: int, n: int = 256, seq: int = 1024, seed: int = 0):
    """``examples/lm_pretrain.py``'s synthetic corpus: n sequences of seq + 1
    tokens following t -> 3t + 1 mod vocab, from ``default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, size=(n, 1))]
    for _ in range(seq):
        seqs.append((seqs[-1] * 3 + 1) % vocab)
    return np.concatenate(seqs, axis=1).astype(np.int32)


def train_phase(device, updates: int = 20, flush_every: int = 10,
                traced_updates: int = 3):
    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    failures = []
    dev = fm.init()
    t0 = time.perf_counter()
    model = TransformerLM(**GPT2_SMALL, attention="flash", dropout=0.0,
                          dtype=torch.float32, device=dev,
                          generator=torch.Generator().manual_seed(0))
    fm.synchronize(model)
    corpus = lm_corpus(GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_len"])
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
        global_batch_size=8, shuffle=True)
    print(f"train: world {fm.total_workers()} on {dev} "
          f"({torch.distributed.get_backend()}), corpus "
          f"{corpus.shape}, {len(loader)} batches of {loader.local_batch_size} x "
          f"{corpus.shape[1] - 1} tokens per epoch; set-up {time.perf_counter() - t0:.2f}s",
          flush=True)

    def loss_fn(params, model_state, batch):
        x, y = batch
        return model(x, targets=y).mean(), model_state

    opt = optim.adamw(3e-4)
    step = make_train_step(loss_fn, opt)
    state = TrainState.create(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    state, summary = train_loop(step, state, loader, steps=updates,
                                flush_every=flush_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = summary["updates"] * 8 * (corpus.shape[1] - 1)
    step_ms = summary["step_ms"]
    # One batch's loss moves from update to update by more than ten
    # updates lower it on this corpus, so the check reads each flush
    # interval's mean loss (the newest update's is printed beside it).
    first, last = summary["flushes"][0]["loss_mean"], summary["flushes"][-1]["loss_mean"]
    first_upd, last_upd = summary["flushes"][0]["loss"], summary["flushes"][-1]["loss"]
    stats = dict(updates=summary["updates"], tokens=tokens, wall_seconds=wall,
                 tokens_per_sec=tokens / wall,
                 median_update_ms=float(np.median(step_ms)) if step_ms else None,
                 step_ms=step_ms, first_flush_loss_mean=first,
                 last_flush_loss_mean=last, first_flush_loss=first_upd,
                 last_flush_loss=last_upd,
                 flushes=summary["flushes"], peak_memory_gb=peak_gb,
                 launches=launches, epochs=summary["epochs"])
    need = model.num_layers * summary["updates"]
    print(f"train: {summary['updates']} updates, {tokens} tokens in {wall:.3f}s = "
          f"{tokens / wall:.1f} tokens/s; median {stats['median_update_ms']:.2f} ms "
          f"per update (device timeline, updates 2..{summary['updates']}); mean loss "
          f"of the first flush interval {first:.4f} -> of the last {last:.4f} (the "
          f"flushing update's: {first_upd:.4f} -> {last_upd:.4f}); peak memory "
          f"{peak_gb:.2f} GB; launches {launches} (need {need} each)", flush=True)
    if summary["updates"] != updates:
        failures.append(f"train: {summary['updates']} updates, not {updates}")
    if any(n != need for n in launches.values()):
        failures.append(f"train: kernel launches {launches}, not {need} each")
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        failures.append(f"train: mean loss {first} -> {last} is not finite and falling")

    # One update's gradients through the kernels against the same update
    # through the plain versions, on the same batch.
    x, y = next(iter(loader))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def grads():
        return torch.autograd.grad(loss_fn(None, None, (x, y))[0], params)

    g_kernel = grads()
    with plain_attention():
        g_plain = grads()
    torch.cuda.synchronize()
    rel = {}
    for name, a, b in zip(names, g_kernel, g_plain):
        scale = b.abs().max().item()
        rel[name] = (a - b).abs().max().item() / scale if scale else 0.0
    # A key bias shifts every score of its query rows alike: its gradient is
    # zero in exact arithmetic, so both sides hold rounding noise only.
    checked = {n: r for n, r in rel.items() if not n.endswith("attn.key.bias")}
    worst = max(checked, key=checked.get)
    stats["grad_rel_err"] = rel
    stats["grad_rel_err_max"] = checked[worst]
    ok = all(np.isfinite(r) and r <= TRAIN_GRAD_TOL for r in checked.values())
    print(f"train: gradients through the kernels vs the plain versions, per leaf "
          f"max|diff|/max|g|: worst {checked[worst]:.3e} ({worst}) over "
          f"{len(checked)} leaves (tol {TRAIN_GRAD_TOL:g}; the {len(rel) - len(checked)} "
          f"key biases, zero in exact arithmetic, excluded) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("train: kernel gradients differ from the plain versions'")
    del g_kernel, g_plain

    # A traced window of a few more updates through the same loop.
    (_, tsum), busy_ms, wall_ms, nk, groups = traced(
        lambda: train_loop(step, state, loader, steps=traced_updates,
                           flush_every=traced_updates))
    prof = dict(updates=tsum["updates"], wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernels=nk, idle_share=(1 - busy_ms / wall_ms) if nk else None,
                device_ms_by_group=groups)
    stats["profile"] = prof
    if not nk:
        failures.append("train profile: the trace holds no device time")
    else:
        print(f"train profile: {tsum['updates']} traced updates: device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
              f"{prof['idle_share']:.3f}); {nk} kernels", flush=True)
        for g, ms in groups.items():
            print(f"train profile:   {g:48s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of busy",
                  flush=True)
    del state, model, step
    fm.shutdown()
    return stats, failures


# bf16 training: one update's gradients through the kernels against the
# plain versions, per leaf ||diff|| / ||g||. Both sides compute in bf16
# and differ only in the attention's roundings: at most about one bf16
# unit roundoff (2**-8) per attention a gradient crosses, forward and back.
# scripts/bf16_grad_bound.py reads the ratio beside kernels made wrong on
# purpose.
BF16_TRAIN_GRAD_TOL = 2 ** -8 * 2 * GPT2_SMALL["num_layers"]


class dtype_probe:
    """Record the input dtype of every kernel launch (the wrappers'
    ``_launch``) for the duration of the block; the wrappers count their
    launches as always."""

    def __enter__(self):
        import importlib

        fa = importlib.import_module("fluxmpi_tpu_torch.ops.flash_attention")
        self.fa, self.saved = fa, fa._launch
        self.dtypes = {name: set() for name in MMA_KERNELS}

        def launch(name, q, *args):
            self.dtypes[name].add(str(q.dtype).split(".")[-1])
            return self.saved(name, q, *args)

        fa._launch = launch
        return self

    def __exit__(self, *exc):
        self.fa._launch = self.saved
        return False


def bf16_phase(device, f32_stats, updates: int = 20, save_every: int = 5,
               crash_hit: int = 13, flush_every: int = 10,
               remat_updates: int = 3, traced_updates: int = 3):
    """bf16 compute with f32 masters at GPT-2-small widths: an
    uninterrupted run, a run killed by an injected fetch fault, its resume
    from the newest committed checkpoint (bit-identical to the
    uninterrupted run), one update's gradients through the kernels against
    the plain versions, remat against no remat, and a traced window."""
    import os
    import tempfile

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.utils import CheckpointManager

    failures = []
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    dev = fm.init()
    corpus = lm_corpus(GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_len"])
    tokens_per_update = 8 * (corpus.shape[1] - 1)

    def build(remat=False):
        model = TransformerLM(**GPT2_SMALL, attention="flash", dropout=0.0,
                              dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(0))
        fm.synchronize(model)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=8, shuffle=True)

        def loss_fn(params, model_state, batch):
            x, y = batch
            return model(x, targets=y).mean(), model_state

        opt = optim.adamw(3e-4)
        step = make_train_step(loss_fn, opt, remat=remat)
        return model, loader, step, TrainState.create(model, opt), loss_fn

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        return out

    # 1. The uninterrupted reference run.
    model, loader, step, state, loss_fn = build()
    if any(p.dtype != torch.float32 for p in model.parameters()):
        failures.append("train_bf16: the parameters are not f32 masters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    with dtype_probe() as probe:
        state, ref = train_loop(step, state, loader, steps=updates,
                                flush_every=flush_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    first, last = ref["flushes"][0]["loss_mean"], ref["flushes"][-1]["loss_mean"]
    tokens = ref["updates"] * tokens_per_update
    median_ms = float(np.median(ref["step_ms"]))
    stats = dict(updates=ref["updates"], tokens=tokens, wall_seconds=wall,
                 tokens_per_sec=tokens / wall, median_update_ms=median_ms,
                 step_ms=ref["step_ms"], first_flush_loss_mean=first,
                 last_flush_loss_mean=last, flushes=ref["flushes"],
                 peak_memory_gb=peak_gb, launches=launches,
                 kernel_dtypes={k: sorted(v) for k, v in probe.dtypes.items()})
    need = model.num_layers * updates
    print(f"train_bf16: bf16 compute, f32 masters: {ref['updates']} updates, "
          f"{tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tokens/s; median "
          f"{median_ms:.2f} ms per update (f32 phase: {f32_stats['median_update_ms']:.2f} "
          f"ms, {f32_stats['tokens_per_sec']:.1f} tokens/s); mean loss of the first "
          f"flush interval {first:.4f} -> of the last {last:.4f}; peak memory "
          f"{peak_gb:.2f} GB; launches {launches} (need {need} each), kernel input "
          f"dtypes {stats['kernel_dtypes']}", flush=True)
    if ref["updates"] != updates:
        failures.append(f"train_bf16: {ref['updates']} updates, not {updates}")
    if any(n != need for n in launches.values()):
        failures.append(f"train_bf16: kernel launches {launches}, not {need} each")
    if any(v != {"bfloat16"} for v in probe.dtypes.values()):
        failures.append(f"train_bf16: kernel input dtypes {probe.dtypes}, not bfloat16")
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        failures.append(f"train_bf16: mean loss {first} -> {last} is not finite and falling")
    want = {k: v.detach().clone() for k, v in leaves(state).items()}

    # One update's gradients through the kernels against the plain versions,
    # per leaf ||diff|| / ||g|| (a bias's gradient sums many tokens' terms
    # that mostly cancel, so its largest element says little about them);
    # the key biases, zero in exact arithmetic, against the largest norm.
    x, y = next(iter(loader))
    params = list(model.parameters())

    def grads():
        return torch.autograd.grad(loss_fn(None, None, (x, y))[0], params)

    g_kernel = grads()
    with plain_attention():
        g_plain = grads()
    top = max(b.norm().item() for b in g_plain)
    rel = {}
    for (name, _), a, b in zip(model.named_parameters(), g_kernel, g_plain):
        scale = top if name.endswith("attn.key.bias") else b.norm().item()
        rel[name] = (a - b).norm().item() / scale if scale else 0.0
    worst = max(rel, key=rel.get)
    ok = all(np.isfinite(r) and r <= BF16_TRAIN_GRAD_TOL for r in rel.values())
    stats["grad_rel_err"], stats["grad_rel_err_max"] = rel, rel[worst]
    print(f"train_bf16: gradients through the kernels vs the plain versions, per "
          f"leaf ||diff||/||g||: worst {rel[worst]:.3e} ({worst}) over {len(rel)} "
          f"leaves (tol {BF16_TRAIN_GRAD_TOL:g} = 2**-8 x 2 x "
          f"{GPT2_SMALL['num_layers']} layers; key biases against the largest "
          f"gradient norm) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("train_bf16: kernel gradients differ from the plain versions'")
    del g_kernel, g_plain, model, loader, step, state, loss_fn
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "run")
        # 2. The same run, killed by a fault at the 13th batch fetch.
        model, loader, step, state, _ = build()
        mgr = CheckpointManager(ckdir, max_to_keep=2, async_save=True)
        crashed = False
        try:
            with faults.scope(f"data.fetch@step={crash_hit}"):
                train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                           checkpoint=mgr, save_every=save_every)
        except fm.FaultInjectedError as exc:
            crashed = True
            print(f"resume: the run stopped at {exc}", flush=True)
        # The crashed run's writer finishes the save it was handed, as a
        # process exiting through its handlers would.
        mgr.close()
        if not crashed:
            failures.append("resume: the data.fetch fault did not stop the run")
        banked = mgr.all_steps()
        del model, loader, step, state, mgr
        torch.cuda.empty_cache()

        # 3. A fresh model, step, loader and manager resume it.
        model, loader, step, state, _ = build()
        mgr = CheckpointManager(ckdir, max_to_keep=2, async_save=True)
        t0 = time.perf_counter()
        state, res = train_loop(step, state, loader, steps=updates,
                                flush_every=flush_every, checkpoint=mgr,
                                save_every=save_every, resume=True)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        got = leaves(state)
        same = [k for k in want if torch.equal(got[k], want[k])]
        diff = {k: (got[k] - want[k]).abs().max().item() for k in want if k not in same}
        counters_ok = all(res[k] == ref[k] for k in ("updates", "epochs", "examples"))
        stats["resume"] = dict(
            banked_before_resume=banked, resumed_from=res["resumed_from"],
            updates=res["updates"], epochs=res["epochs"], examples=res["examples"],
            reference=dict(updates=ref["updates"], epochs=ref["epochs"],
                           examples=ref["examples"]),
            leaves=len(want), bit_identical=len(same), differing=diff,
            wall_seconds=resume_wall, committed_after=mgr.all_steps())
        print(f"resume: committed steps before the resume {banked}; resumed_from "
              f"{res['resumed_from']}; updates/epochs/examples {res['updates']}/"
              f"{res['epochs']}/{res['examples']} (reference {ref['updates']}/"
              f"{ref['epochs']}/{ref['examples']}); {len(same)} of {len(want)} "
              f"parameters and adamw moments bit-identical to the uninterrupted run"
              f"{'' if not diff else f'; worst differing {max(diff.values()):.3e}'}; "
              f"committed after {mgr.all_steps()}", flush=True)
        if res["resumed_from"] != 10:
            failures.append(f"resume: resumed_from {res['resumed_from']}, not 10")
        if not counters_ok:
            failures.append("resume: the counters differ from the uninterrupted run's")
        if diff:
            failures.append(f"resume: {len(diff)} leaves differ from the uninterrupted run")

        # A save and a restore of the full state, timed: the blocking part
        # (host snapshot) and the background part (the commit on the writer).
        probe_dir = os.path.join(tmp, "probe")
        pm = CheckpointManager(probe_dir, async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm.save(updates, {"state": state})
        blocking = time.perf_counter() - t0
        pm.wait_until_finished()
        background = pm.write_seconds[-1]
        nbytes = os.path.getsize(os.path.join(pm._step_path(updates), "state.pt"))
        t0 = time.perf_counter()
        _, back = pm.restore({"state": state})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_ok = all(torch.equal(a, b) for a, b in
                          zip(leaves(back["state"]).values(), got.values()))
        pm.close()
        stats["checkpoint"] = dict(bytes=nbytes, save_blocking_seconds=blocking,
                                   save_background_seconds=background,
                                   restore_seconds=restore_s,
                                   restored_bit_identical=restored_ok)
        print(f"checkpoint: {nbytes} bytes (f32 parameters and two adamw moments); "
              f"save: {blocking:.3f}s blocking (host snapshot), {background:.3f}s in "
              f"the background writer; restore {restore_s:.3f}s; restored bytes "
              f"{'equal' if restored_ok else 'DIFFER'}", flush=True)
        if not restored_ok:
            failures.append("checkpoint: the restored state differs from the saved one")
        del back, mgr, pm

    # 4. A traced window of a few more bf16 updates.
    (_, tsum), busy_ms, wall_ms, nk, groups = traced(
        lambda: train_loop(step, state, loader, steps=traced_updates,
                           flush_every=traced_updates))
    stats["profile"] = dict(updates=tsum["updates"], wall_ms=wall_ms,
                            device_busy_ms=busy_ms, kernels=nk,
                            idle_share=(1 - busy_ms / wall_ms) if nk else None,
                            device_ms_by_group=groups)
    if not nk:
        failures.append("train_bf16 profile: the trace holds no device time")
    else:
        print(f"train_bf16 profile: {tsum['updates']} traced updates: device "
              f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
              f"{stats['profile']['idle_share']:.3f}); {nk} kernels", flush=True)
        for g, ms in groups.items():
            print(f"train_bf16 profile:   {g:48s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of busy",
                  flush=True)
    del model, loader, step, state
    torch.cuda.empty_cache()

    # 5. remat=True and remat="dots" against no remat: the same updates,
    # bit for bit (the recompute runs the same deterministic kernels on the
    # same inputs), with the forward run again in the backward.
    runs, bits = {}, {}
    for remat in (False, True, "dots"):
        model, loader, step, state, _ = build(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for kern in kernels:
            kern.launches = 0
        # flush_every=1 divides the epoch: fuse="auto" runs one-update
        # windows, the first eagerly, the later ones as replays of a CUDA
        # graph captured under the checkpoint.
        (_, summ), seen = kernel_launches(
            lambda: train_loop(step, state, loader, steps=remat_updates, flush_every=1))
        extra = graph_launches(step)
        runs[remat] = dict(losses=[f["loss"] for f in summ["flushes"]],
                           peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                           launches=seen,
                           accounted_launches={k.__name__: k.launches + extra[k.__name__]
                                               for k in kernels},
                           fused_window=summ["fused_window"],
                           graphs=graph_stats(step))
        got = leaves(state)
        if remat is False:
            base = {k: v.detach().clone() for k, v in got.items()}
        else:
            bits[remat] = sum(torch.equal(got[k], base[k]) for k in base)
        del model, loader, step, state, got
        torch.cuda.empty_cache()
    n_leaves = len(base)
    del base
    plain = runs[False]
    fwd_need = 2 * GPT2_SMALL["num_layers"] * remat_updates
    stats["remat"] = dict(plain=plain, remat=runs[True], dots=runs["dots"],
                          leaves=n_leaves)
    for remat, name in ((True, "remat"), ("dots", "remat_dots")):
        rem = runs[remat]
        rem["identical_leaves"] = bits[remat]
        same = bits[remat] == n_leaves and rem["losses"] == plain["losses"]
        verdict = "equal" if rem["losses"] == plain["losses"] else "differ"
        print(f"{name}: {remat_updates} updates with remat={remat!r} vs without: "
              f"{bits[remat]}/{n_leaves} parameters and moments bit-identical, losses "
              f"{rem['losses']} vs {plain['losses']} ({verdict}); flash_fwd launches "
              f"{rem['launches']['flash_fwd']} counted by the device (need {fwd_need}: "
              f"{fwd_need // remat_updates} per update; the wrappers' counts with "
              f"the graphs' {rem['accounted_launches']['flash_fwd']}) vs "
              f"{plain['launches']['flash_fwd']}; peak memory "
              f"{rem['peak_memory_gb']:.2f} GB vs {plain['peak_memory_gb']:.2f} GB; "
              f"fused window {rem['fused_window']}, graphs {rem['graphs']}",
              flush=True)
        if not same:
            failures.append(f"{name}: the parameters, moments or losses differ from "
                            f"the run without remat")
        if rem["launches"]["flash_fwd"] != fwd_need:
            failures.append(f"{name}: flash_fwd launched {rem['launches']['flash_fwd']} "
                            f"times, not {fwd_need}")
    for remat, run in runs.items():
        if run["launches"] != run["accounted_launches"]:
            failures.append(f"remat={remat!r}: the device's launches {run['launches']} "
                            f"differ from the wrappers' counts with the graphs' "
                            f"{run['accounted_launches']}")
    fm.shutdown()
    return stats, failures


def fused_phase(device, bf16_stats, updates: int = 32, flush_every: int = 8,
                crash_hit: int = 6, save_every: int = 3):
    """One-program flush windows at GPT-2-small widths in bf16 compute with
    f32 masters: the same script as the bf16 phase with ``train_loop``'s
    default ``fuse="auto"`` over the device-gather loader and a
    ``flush_every`` that divides the 32-batch epoch, so each window of 8
    updates is one CUDA-graph replay (the first window runs eagerly and
    warms up, the second is captured). Held bit for bit against the same
    run with ``fuse=False``; a pipelined run killed by a fetch fault
    resumes fused (one short realignment window) to the same bits. Both
    paths are timed, traced and their host launches counted."""
    import os
    import tempfile

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.utils import CheckpointManager

    failures = []
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    dev = fm.init()
    corpus = lm_corpus(GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_len"])
    tokens_per_update = 8 * (corpus.shape[1] - 1)

    def build():
        model = TransformerLM(**GPT2_SMALL, attention="flash", dropout=0.0,
                              dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(0))
        fm.synchronize(model)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=8, shuffle=True)

        def loss_fn(params, model_state, batch):
            x, y = batch
            return model(x, targets=y).mean(), model_state

        opt = optim.adamw(3e-4)
        return model, loader, make_train_step(loss_fn, opt), TrainState.create(model, opt)

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return out

    def flushes(summary):
        return [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                for f in summary["flushes"]]

    def drive(fuse):
        """The main path (counts set to 0 just before, read just after; the
        attention kernels' launches also read from their device counters),
        a second, untraced run of as many updates for the times,
        a traced window of ``flush_every`` more updates, and the host's
        launch calls over one more window."""
        model, loader, step, state = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for kern in kernels:
            kern.launches = 0
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=updates,
                               flush_every=flush_every, fuse=fuse))
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        accounted = {n: counted[n] + extra[n] for n in counted}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        bits = {k: v.detach().clone() for k, v in leaves(state).items()}
        t0 = time.perf_counter()
        state, timed = train_loop(step, state, loader, steps=updates,
                                  flush_every=flush_every, fuse=fuse)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # step_ms holds one time per window on the fused path (every window
        # of this run replays the graph) and one per update without it.
        per_update = ([ms / flush_every for ms in timed["step_ms"]] if fuse
                      else timed["step_ms"])
        run = dict(fuse=fuse, updates=summ["updates"], dispatches=summ["dispatches"],
                   fused_window=summ["fused_window"], wall_seconds=wall,
                   tokens_per_sec=timed["updates"] * tokens_per_update / wall,
                   median_update_ms=float(np.median(per_update)),
                   step_ms=timed["step_ms"], flushes=summ["flushes"],
                   peak_memory_gb=peak_gb, launches=launches,
                   counted_launches=counted, accounted_launches=accounted,
                   graphs=graph_stats(step))
        run["steady_tokens_per_sec"] = tokens_per_update / run["median_update_ms"] * 1e3
        (_, tsum), busy_ms, wall_ms, nk, groups = traced(
            lambda: train_loop(step, state, loader, steps=flush_every,
                               flush_every=flush_every, fuse=fuse))
        run["profile"] = dict(updates=tsum["updates"], wall_ms=wall_ms,
                              device_busy_ms=busy_ms, kernels=nk,
                              idle_share=(1 - busy_ms / wall_ms) if nk else None,
                              device_ms_by_group=groups)
        (_, hsum), calls, nk2 = host_launches(
            lambda: train_loop(step, state, loader, steps=flush_every,
                               flush_every=flush_every, fuse=fuse))
        run["host_launches_per_update"] = calls / hsum["updates"]
        run["device_kernels_per_update"] = nk2 / hsum["updates"]
        if fuse:
            run["capture_seconds"] = sum(g["capture_seconds"] for g in graph_stats(step))
        del model, loader, step, state
        torch.cuda.empty_cache()
        return run, summ, bits

    pipe, pipe_sum, want = drive(False)
    fused, fused_sum, got = drive("auto")
    same = [k for k in want if torch.equal(got[k], want[k])]
    flush_same = flushes(fused_sum) == flushes(pipe_sum)
    need = GPT2_SMALL["num_layers"] * updates
    replays = sum(g["replays"] for g in fused["graphs"])
    stats = dict(pipelined=pipe, fused=fused, leaves=len(want), bit_identical=len(same),
                 flushes_bit_identical=flush_same, launches_needed=need,
                 replays=replays)
    for run in (pipe, fused):
        prof = run["profile"]
        print(f"fused_phase [{'fused' if run['fuse'] else 'pipelined'}]: "
              f"{run['updates']} updates in {run['dispatches']} dispatches "
              f"(fused_window {run['fused_window']}), {run['wall_seconds']:.3f}s = "
              f"{run['tokens_per_sec']:.1f} tokens/s (a second, untraced run of "
              f"{updates}); median {run['median_update_ms']:.2f} ms per update = "
              f"{run['steady_tokens_per_sec']:.1f} tokens/s; traced window of "
              f"{prof['updates']}: device busy {prof['device_busy_ms']:.3f} ms of "
              f"{prof['wall_ms']:.3f} ms wall (idle share "
              f"{prof['idle_share'] if prof['idle_share'] is None else round(prof['idle_share'], 3)}); "
              f"host launch calls per update {run['host_launches_per_update']:.2f} "
              f"(device kernels per update {run['device_kernels_per_update']:.1f}); "
              f"peak memory {run['peak_memory_gb']:.2f} GB; launches the device "
              f"counted {run['launches']} (need {need} each; the wrappers' counts "
              f"{run['counted_launches']}, with the graphs' captures taken off and "
              f"replays added {run['accounted_launches']})"
              + (f"; capture and instantiate {run['capture_seconds']:.3f}s; graphs "
                 f"{run['graphs']}" if run["fuse"] else ""), flush=True)
        if run["launches"] != {k.__name__: need for k in kernels}:
            failures.append(f"fused_phase: launches {run['launches']}, not {need} each")
        if run["accounted_launches"] != run["launches"]:
            failures.append(f"fused_phase: the wrappers' counts with the graphs' "
                            f"{run['accounted_launches']} differ from the device's "
                            f"{run['launches']}")
        if not run["profile"]["kernels"]:
            failures.append("fused_phase: the trace holds no device time")
    print(f"fused_phase: fused vs pipelined: {len(same)} of {len(want)} parameters, "
          f"adamw moments and the count bit-identical; flush losses "
          f"{'identical' if flush_same else 'DIFFER'} "
          f"({[f[1] for f in flushes(fused_sum)]}); {replays} graph replays",
          flush=True)
    if (fused["fused_window"], fused["dispatches"]) != (flush_every, updates // flush_every):
        failures.append(f"fused_phase: fused_window {fused['fused_window']}, dispatches "
                        f"{fused['dispatches']}, not {flush_every} and "
                        f"{updates // flush_every}")
    if replays < updates // flush_every - 1:
        failures.append(f"fused_phase: {replays} graph replays, fewer than "
                        f"{updates // flush_every - 1}")
    if len(same) != len(want) or not flush_same:
        failures.append("fused_phase: the fused run differs from the pipelined run")

    # A pipelined run killed by a fetch fault, resumed fused.
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "run")
        model, loader, step, state = build()
        mgr = CheckpointManager(ckdir, async_save=False)
        crashed = False
        try:
            with faults.scope(f"data.fetch@step={crash_hit}"):
                train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                           fuse=False, checkpoint=mgr, save_every=save_every)
        except fm.FaultInjectedError:
            crashed = True
        banked = mgr.latest_step()
        mgr.close()
        del model, loader, step, state
        torch.cuda.empty_cache()
        model, loader, step, state = build()
        mgr = CheckpointManager(ckdir, async_save=False)
        state, res = train_loop(step, state, loader, steps=updates,
                                flush_every=flush_every, checkpoint=mgr, resume=True)
        torch.cuda.synchronize()
        mgr.close()
        back = leaves(state)
        same_res = [k for k in want if torch.equal(back[k], want[k])]
        widths = [g["width"] for g in graph_stats(step)]
        stats["resume"] = dict(crashed=crashed, banked=banked,
                               resumed_from=res["resumed_from"], updates=res["updates"],
                               dispatches=res["dispatches"],
                               fused_window=res["fused_window"], widths=widths,
                               bit_identical=len(same_res), graphs=graph_stats(step))
        print(f"fused_phase resume: the pipelined run stopped by data.fetch@step="
              f"{crash_hit} ({'raised' if crashed else 'DID NOT RAISE'}) with step "
              f"{banked} committed; resumed fused from {res['resumed_from']}: "
              f"{res['updates']} updates in {res['dispatches']} windows (widths "
              f"{widths}; fused_window {res['fused_window']}); {len(same_res)} of "
              f"{len(want)} leaves bit-identical to the uninterrupted run", flush=True)
        short = flush_every - banked % flush_every if banked else 0
        if not crashed or res["resumed_from"] != banked or not banked:
            failures.append("fused_phase resume: the kill or the resume did not happen")
        if (res["fused_window"] != flush_every or res["updates"] != updates
                or res["dispatches"] != 1 + (updates - banked - short) // flush_every
                or short not in widths):
            failures.append(f"fused_phase resume: windows {widths}, dispatches "
                            f"{res['dispatches']}: not one short realignment window")
        if len(same_res) != len(want):
            failures.append("fused_phase resume: the resumed run differs from the "
                            "uninterrupted run")
        del model, loader, step, state
    torch.cuda.empty_cache()
    fm.shutdown()
    return stats, failures


# Telemetry phase: the fused bf16 run of fused_phase with every ported
# plane on (JSONL metrics, the span trace, goodput with live MFU, the
# memory plane, the watchdog) beside the same run with every plane off.
H100_PEAK_BF16 = 989.4e12  # NVIDIA H100 SXM data sheet, dense bf16


def telemetry_phase(device, updates: int = 32, flush_every: int = 8,
                    stall_deadline: float = 2.0):
    """GPT-2-small widths in bf16 compute with f32 masters, ``fuse="auto"``,
    ``steps=32, flush_every=8`` (four CUDA-graph windows), run twice from
    the same seed: once with every plane off, once under ``init(telemetry=
    <jsonl>, trace=<path>, goodput=True, memory=True, watchdog=<600 s>)``
    with ``make_train_step(metrics=TrainingMonitor(interval=1))`` (one JSONL
    line per flush). Gates: the JSONL and the trace export pass
    ``scripts/check_metrics_schema.py`` and ``scripts/goodput_report.py``
    reads the stream (both run as subprocesses); ``train.steps`` 32,
    ``train.window.size`` 8 and ``train.window.dispatches`` equal to the
    loop's ``dispatches``; every parameter and adamw moment bit-identical
    to the planes-off run; ``goodput.mfu`` in (0, 1] and within 5% of
    FLOPs per update x updates / (the loop's seconds x 989.4e12);
    ``memory.peak_bytes_in_use`` within 1% of
    ``torch.cuda.max_memory_allocated()``; host launch calls per update in
    replayed windows at most 1 above the planes-off run; each kernel
    launched 12 times per update. Prints ms per update (median over the
    windows of a second run of 32 updates) with the planes on beside off.
    Then the watchdog (deadline ``stall_deadline`` s) against two stalls:
    a pipelined run whose third batch is delayed by a ``data.fetch``
    ``delay=`` fault past the deadline, and the main thread waiting in
    ``torch.cuda.synchronize()`` on a kernel that spins on the card past
    the deadline; each dump must validate and name the stalled stack."""
    import os
    import tempfile

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, optim, telemetry
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    failures = []
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    root = Path(__file__).resolve().parent
    corpus = lm_corpus(GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_len"])
    tokens_per_update = 8 * (corpus.shape[1] - 1)
    need = GPT2_SMALL["num_layers"] * updates

    def build(dev, metrics=None, fuse_ok=True):
        model = TransformerLM(**GPT2_SMALL, attention="flash", dropout=0.0,
                              dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(0))
        fm.synchronize(model)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=8, shuffle=True, device_gather=fuse_ok)

        def loss_fn(params, model_state, batch):
            x, y = batch
            return model(x, targets=y).mean(), model_state

        opt = optim.adamw(3e-4)
        step = make_train_step(loss_fn, opt, metrics=metrics)
        return model, loader, step, TrainState.create(model, opt)

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        return out

    def drive(dev, metrics):
        model, loader, step, state = build(dev, metrics)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for kern in kernels:
            kern.launches = 0
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=updates,
                               flush_every=flush_every))
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        peak = torch.cuda.max_memory_allocated(dev)
        bits = {k: v.detach().clone() for k, v in leaves(state).items()}
        state, timed = train_loop(step, state, loader, steps=updates,
                                  flush_every=flush_every)
        (_, hsum), calls, _ = host_launches(
            lambda: train_loop(step, state, loader, steps=flush_every,
                               flush_every=flush_every))
        run = dict(updates=summ["updates"], dispatches=summ["dispatches"],
                   fused_window=summ["fused_window"], seconds=summ["seconds"],
                   parameters=sum(p.numel() for p in model.parameters()),
                   median_update_ms=float(np.median(
                       [ms / flush_every for ms in timed["step_ms"]])),
                   launches=launches,
                   accounted_launches={n: counted[n] + extra[n] for n in counted},
                   host_launches_per_update=calls / hsum["updates"],
                   peak_memory_bytes=peak, goodput=summ.get("goodput"))
        del model, loader, step, state
        torch.cuda.empty_cache()
        return run, bits

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        trace = os.path.join(tmp, "trace.{process}.json")
        dev = fm.init()
        off, want = drive(dev, None)
        prev = telemetry.set_registry(telemetry.MetricsRegistry())
        wd = telemetry.Watchdog(deadline=600.0, dump_dir=tmp)
        try:
            fm.init(telemetry=jsonl, trace=trace, goodput=True, memory=True, watchdog=wd)
            mon = telemetry.TrainingMonitor(interval=1)
            model, loader, step, state = build(dev, mon)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for kern in kernels:
                kern.launches = 0
            (state, summ), launches = kernel_launches(
                lambda: train_loop(step, state, loader, steps=updates,
                                   flush_every=flush_every))
            max_alloc = torch.cuda.max_memory_allocated(dev)
            counted = {k.__name__: k.launches for k in kernels}
            extra = graph_launches(step)
            got = {k: v.detach().clone() for k, v in leaves(state).items()}
            # What a user's script does next: the loss averaged over the
            # world and a barrier, two eager collectives on the trace.
            fm.allreduce(torch.tensor(summ["loss"], device=dev), op="mean")
            fm.barrier()
            with open(jsonl) as f:
                lines = [json.loads(x) for x in f.read().splitlines()]
            n_lines = len(lines)
            state, timed = train_loop(step, state, loader, steps=updates,
                                      flush_every=flush_every)
            (_, hsum), calls, _ = host_launches(
                lambda: train_loop(step, state, loader, steps=flush_every,
                                   flush_every=flush_every))
            # The loader's host time per batch (data.batch_fetch_seconds)
            # on the pipelined path, device-gathered and host-gathered.
            fetch = {}
            for gather in (True, False):
                fetch_reg = telemetry.MetricsRegistry()
                keep = telemetry.set_registry(fetch_reg)
                try:
                    _, fl, fstep, fstate = build(dev, fuse_ok=gather)
                    train_loop(fstep, fstate, fl, steps=flush_every,
                               flush_every=flush_every, fuse=False)
                    torch.cuda.synchronize()
                finally:
                    telemetry.set_registry(keep)
                hist = fetch_reg.histogram("data.batch_fetch_seconds")
                fetch["device_gather" if gather else "host_gather"] = dict(
                    count=hist.count, mean_ms=hist.mean * 1e3, max_ms=hist.max * 1e3)
                del fl, fstep, fstate
            on = dict(updates=summ["updates"], dispatches=summ["dispatches"],
                      fused_window=summ["fused_window"], seconds=summ["seconds"],
                      median_update_ms=float(np.median(
                          [ms / flush_every for ms in timed["step_ms"]])),
                      launches=launches,
                      accounted_launches={n: counted[n] + extra[n] for n in counted},
                      host_launches_per_update=calls / hsum["updates"],
                      peak_memory_bytes=max_alloc, goodput=summ["goodput"],
                      batch_fetch=fetch)
            del model, loader, step, state
            torch.cuda.empty_cache()
        finally:
            telemetry.shutdown()  # writes the last line and the trace export
            telemetry.set_registry(prev)
        trace_path = trace.format(process=0)
        check = subprocess.run(
            [sys.executable, str(root / "scripts" / "check_metrics_schema.py"), jsonl,
             trace_path], capture_output=True, text=True, timeout=300)
        report = subprocess.run(
            [sys.executable, str(root / "scripts" / "goodput_report.py"), jsonl, "--json"],
            capture_output=True, text=True, timeout=300)

        def metric(rec, name, **labels):
            for m in rec["metrics"]:
                if m["name"] == name and m["labels"] == labels:
                    return m.get("value")
            return None

        last = lines[-1] if lines else {"metrics": []}
        with open(trace_path) as f:
            spans = sorted({e["name"] for e in json.load(f)["traceEvents"]
                            if e["ph"] != "M"})
        rep = on["goodput"]
        fpu = rep["flops_per_update"] or 0.0
        mfu_formula = fpu * on["updates"] / (on["seconds"] * H100_PEAK_BF16)
        mem_peak = metric(last, "memory.peak_bytes_in_use", device=str(dev.index))
        same = [k for k in want if torch.equal(got[k], want[k])]
        stats = dict(
            planes_off=off, planes_on=on, jsonl_lines=n_lines, spans=spans,
            checker_rc=check.returncode, goodput_report_rc=report.returncode,
            goodput_report=(json.loads(report.stdout) if report.returncode == 0
                            else report.stderr[-2000:]),
            train_steps=metric(last, "train.steps"),
            window_size=metric(last, "train.window.size"),
            window_dispatches=metric(last, "train.window.dispatches"),
            flops_per_update=fpu,
            flops_6n_tokens=6 * off["parameters"] * tokens_per_update,
            mfu=rep["mfu"], mfu_productive=rep["mfu_productive"],
            mfu_formula=mfu_formula, memory_peak_gauge=mem_peak,
            max_memory_allocated=on["peak_memory_bytes"],
            leaves=len(want), bit_identical=len(same))
        print(f"telemetry_phase: planes off {off['median_update_ms']:.2f} ms per update, "
              f"on {on['median_update_ms']:.2f} ms (median over the windows of a second "
              f"run of {updates}); host launch calls per update off "
              f"{off['host_launches_per_update']:.3f}, on "
              f"{on['host_launches_per_update']:.3f}; {len(same)} of {len(want)} leaves "
              f"bit-identical; JSONL {n_lines} lines after the main run, checker rc "
              f"{check.returncode}, goodput_report rc {report.returncode}; train.steps "
              f"{stats['train_steps']}, window size {stats['window_size']}, dispatches "
              f"{stats['window_dispatches']} (loop {on['dispatches']}); FLOPs per update "
              f"{fpu:.4g} (6*N*tokens {stats['flops_6n_tokens']:.4g}); goodput.mfu "
              f"{rep['mfu']} (productive {rep['mfu_productive']}; formula "
              f"{mfu_formula:.4f}); goodput buckets {rep['buckets']}; memory peak gauge "
              f"{mem_peak} vs max_memory_allocated {on['peak_memory_bytes']}; spans "
              f"{spans}; launches {on['launches']}; data.batch_fetch_seconds "
              f"(pipelined, {flush_every} updates) {on['batch_fetch']}", flush=True)
        if check.returncode != 0:
            failures.append(f"telemetry_phase: checker: {(check.stdout + check.stderr)[-800:]}")
        if report.returncode != 0:
            failures.append(f"telemetry_phase: goodput_report: {report.stderr[-800:]}")
        if (stats["train_steps"], stats["window_size"]) != (updates, flush_every) or \
                stats["window_dispatches"] != on["dispatches"]:
            failures.append(f"telemetry_phase: train.steps {stats['train_steps']}, "
                            f"window size {stats['window_size']}, dispatches "
                            f"{stats['window_dispatches']} vs {on['dispatches']}")
        if len(same) != len(want):
            failures.append(f"telemetry_phase: {len(want) - len(same)} leaves differ "
                            f"from the planes-off run")
        if not (rep["mfu"] and 0 < rep["mfu"] <= 1) or \
                abs(rep["mfu"] - mfu_formula) > 0.05 * mfu_formula:
            failures.append(f"telemetry_phase: goodput.mfu {rep['mfu']} vs {mfu_formula}")
        if mem_peak is None or abs(mem_peak - on["peak_memory_bytes"]) > \
                0.01 * on["peak_memory_bytes"]:
            failures.append(f"telemetry_phase: memory peak gauge {mem_peak} vs "
                            f"{on['peak_memory_bytes']}")
        if on["host_launches_per_update"] > off["host_launches_per_update"] + 1:
            failures.append("telemetry_phase: the planes add more than one host launch "
                            "call per update")
        for run, name in ((off, "off"), (on, "on")):
            if run["launches"] != {k.__name__: need for k in kernels} or \
                    run["accounted_launches"] != run["launches"]:
                failures.append(f"telemetry_phase [{name}]: launches {run['launches']} "
                                f"(wrappers {run['accounted_launches']}), not {need} each")

        # The watchdog against two stalls on the card. Each dump overwrites
        # the last (one file per process), so each is read at once.
        def inspect(kind, want_fn, path, seconds):
            ok, tail = False, None
            if path:
                with open(path) as f:
                    dump = json.load(f)
                main = [t for t in dump["threads"] if t["name"] == "MainThread"]
                funcs = [fr["function"] for t in main for fr in t["stack"]]
                tail = funcs[-4:]
                chk = subprocess.run(
                    [sys.executable, str(root / "scripts" / "check_metrics_schema.py"),
                     path], capture_output=True, text=True, timeout=300)
                ok = dump["reason"] == "stall" and want_fn in funcs and chk.returncode == 0
            stats[f"watchdog_{kind}"] = dict(dumped=bool(path), stack_tail=tail,
                                             valid=ok, wait_seconds=seconds)
            print(f"telemetry_phase watchdog [{kind}]: stalled {seconds:.2f}s against a "
                  f"{stall_deadline:g}s deadline; dump {'written' if path else 'MISSING'}"
                  f", main thread at {tail}", flush=True)
            if not ok:
                failures.append(f"telemetry_phase: the watchdog did not dump a valid "
                                f"{kind} stall naming {want_fn}")

        model, loader, step, state = build(dev, fuse_ok=False)
        wd = telemetry.arm_watchdog(deadline=stall_deadline,
                                    poll_interval=stall_deadline / 8, dump_dir=tmp)
        try:
            t0 = time.perf_counter()
            with faults.scope(f"data.fetch@step=3:delay={3 * stall_deadline:g}"):
                train_loop(step, state, loader, steps=4, flush_every=2, fuse=False)
            inspect("fetch", "check", wd.last_dump_path, time.perf_counter() - t0)
            wd.last_dump_path = None
            # A kernel that spins ~3 deadlines at the card's 1.98 GHz boost
            # clock (longer at a lower clock), and the host waiting for it.
            t0 = time.perf_counter()
            torch.cuda._sleep(int(3 * stall_deadline * 1.98e9))
            torch.cuda.synchronize(dev)
            inspect("synchronize", "synchronize", wd.last_dump_path,
                    time.perf_counter() - t0)
        finally:
            telemetry.disarm_watchdog()
        del model, loader, step, state
        torch.cuda.empty_cache()
    fm.shutdown()
    return stats, failures


# Vision phase: ResNet-50 at ImageNet width (the reference's headline
# workload), the Conv+BN CNN, the DEQ, and the adapter path with the rest of
# the collectives.
RESNET_BATCH = 128
# Eight batches per epoch, so flush_every=8 windows are whole epochs and
# the fused and pipelined paths flush at the same updates.
RESNET_IMAGES = 1024
RESNET_HW = 224
RESNET_CLASSES = 10  # labels used of the 1000 the head predicts


def image_corpus(n: int, hw: int, classes: int, seed: int = 0):
    """``n`` uint8 NHWC images of ``hw`` x ``hw`` x 3 and their labels
    (``classes`` of them, int64), from ``default_rng(seed)``: each image is
    its class's template plus noise, so the loss can fall in a few
    updates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    templates = rng.integers(0, 128, (classes, hw, hw, 3), dtype=np.uint8)
    noise = rng.integers(0, 128, (n, hw, hw, 3), dtype=np.uint8)
    return (templates[labels] + noise).astype(np.uint8), labels.astype(np.int64)


def _bn_loss(model):
    """Cross-entropy of a BatchNorm classifier, its new statistics beside
    (``bench.py``'s ``_bn_loss``)."""
    import torch.nn.functional as F

    def loss_fn(params, model_state, batch):
        x, y = batch
        logits, new = model(x, model_state, train=True)
        return F.cross_entropy(logits.float(), y), new

    return loss_fn


def _max_rel(got: dict, want: dict) -> tuple:
    """The largest ``max|got - want| / max|want|`` over the leaves, and
    its leaf."""
    worst = (0.0, None)
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k].cpu() - w).abs().max()) / (scale if scale else 1.0)
        worst = max(worst, (err, k), key=lambda t: t[0])
    return worst


def resnet_run(dev, corpus, fuse, updates: int, flush_every: int):
    """ResNet-50 in bf16 compute with f32 parameters (``bench.py``'s
    ``_bench_resnet50``): the main path (``train_loop(steps=updates)``), a
    second run of as many updates for the times, a traced window and the
    host's launch calls over another. Returns the run's numbers, the first
    run's summary and its state's leaves."""
    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import ResNet50
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator().manual_seed(0))
    fm.synchronize(model)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset(corpus)),
        global_batch_size=RESNET_BATCH, shuffle=True, device=dev)
    opt = optim.sgd(0.1, momentum=0.9)
    step = make_train_step(_bn_loss(model), opt)
    state = TrainState.create(model, opt, model_state=model.init_batch_stats())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, summ = train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                             fuse=fuse)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    leaves = {f"params/{k}": v.detach().clone() for k, v in state.params.items()}
    leaves.update({f"momentum/{k}": v.clone() for k, v in state.opt_state["trace"].items()})
    leaves.update({f"batch_stats/{k}": v.clone() for k, v in state.model_state.items()})
    t0 = time.perf_counter()
    state, timed = train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                              fuse=fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    width = summ["fused_window"] or 1
    per_update = [ms / width for ms in timed["step_ms"]]
    run = dict(fuse=fuse, updates=summ["updates"], dispatches=summ["dispatches"],
               fused_window=summ["fused_window"], wall_seconds=wall,
               images_per_sec=timed["updates"] * RESNET_BATCH / wall,
               median_update_ms=float(np.median(per_update)), step_ms=timed["step_ms"],
               peak_memory_gb=peak_gb, graphs=graph_stats(step))
    run["steady_images_per_sec"] = RESNET_BATCH / run["median_update_ms"] * 1e3
    (_, tsum), busy_ms, wall_ms, nk, by_name = traced(
        lambda: train_loop(step, state, loader, steps=width, flush_every=flush_every,
                           fuse=fuse), group=lambda name: name)
    groups = {}
    for name, ms in by_name.items():
        groups[_vision_group(name)] = groups.get(_vision_group(name), 0.0) + ms
    n = tsum["updates"]
    run["profile"] = dict(updates=n, wall_ms=wall_ms, device_busy_ms=busy_ms,
                          kernels=nk, idle_share=(1 - busy_ms / wall_ms) if nk else None,
                          device_ms_by_group_per_update={
                              g: ms / n for g, ms in sorted(groups.items(),
                                                            key=lambda kv: -kv[1])},
                          top_kernels_ms_per_update=[
                              (name, ms / n) for name, ms in list(by_name.items())[:15]])
    (_, hsum), calls, nk2 = host_launches(
        lambda: train_loop(step, state, loader, steps=width, flush_every=flush_every,
                           fuse=fuse))
    run["host_launches_per_update"] = calls / hsum["updates"]
    run["device_kernels_per_update"] = nk2 / hsum["updates"]
    if fuse:
        run["capture_seconds"] = sum(g["capture_seconds"] for g in graph_stats(step))
    params = {k: v.detach().float().clone() for k, v in state.params.items()}
    mstate = {k: v.clone() for k, v in state.model_state.items()}
    del model, loader, step, state
    torch.cuda.empty_cache()
    return run, summ, leaves, (params, mstate)


def _resnet_grads(where, dtype, params, mstate, x, y) -> dict:
    """ResNet-50 (``dtype`` compute and parameters) with ``params`` and the
    statistics ``mstate``, one training forward and backward on ``where``:
    the logits, the loss, every gradient and the new statistics, on the
    host."""
    import torch

    from fluxmpi_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, dtype=dtype, device=where).to(dtype)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    ms = {k: v.to(where, dtype) for k, v in mstate.items()}
    logits, new = model(x.to(where), ms, train=True)
    loss = torch.nn.functional.cross_entropy(logits.float(), y.to(where))
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    res = {f"grad/{k}": g.detach().cpu().double() for k, g in zip(names, grads)}
    res.update({f"stats/{k}": v.cpu().double() for k, v in new.items()})
    res["logits"] = logits.detach().cpu().double()
    res["loss"] = loss.detach().cpu().double().reshape(1)
    return res


def resnet_layers(where, dtype, params, mstate, x, y, feed=None):
    """ResNet-50's layers one at a time: every ``Conv``, ``BatchNorm`` and
    the head, each fed its own input and its output's gradient from one
    reference pass, so that no layer's error reaches another. With
    ``feed=None``, runs that pass (a training forward and backward of the
    whole model with ``params`` and the statistics ``mstate`` on ``x, y``)
    and returns the feed; else returns, per layer, its output and the
    gradients of its input and its parameters, ``dtype`` on ``where``, on
    the host in f64."""
    import torch
    import torch.nn.functional as F

    from fluxmpi_tpu_torch.models import ResNet50
    from fluxmpi_tpu_torch.models._layers import BatchNorm, Conv, StatsContext
    from fluxmpi_tpu_torch.models.transformer import Dense

    model = ResNet50(num_classes=1000, dtype=dtype, device=where).to(dtype)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    layers = {n: m for n, m in model.named_modules() if isinstance(m, (Conv, BatchNorm, Dense))}
    if feed is None:
        feed, handles = {}, []

        def hook(name):
            def capture(mod, args, out):
                feed[name] = [args, None]
                out.register_hook(lambda g: feed[name].__setitem__(1, g.detach()))
            return capture

        handles = [m.register_forward_hook(hook(n)) for n, m in layers.items()]
        logits, _ = model(x.to(where), {k: v.to(where, dtype) for k, v in mstate.items()},
                          train=True)
        F.cross_entropy(logits.float(), y.to(where)).backward()
        for h in handles:
            h.remove()
        return {n: ([a.detach() if isinstance(a, torch.Tensor) else a for a in args], dy)
                for n, (args, dy) in feed.items()}
    ctx = StatsContext({k: v.to(where, dtype) for k, v in mstate.items()}, True)
    out = {}
    for n, m in layers.items():
        args, dy = feed[n]
        xin = args[0].to(where, dtype).requires_grad_()
        rest = [ctx if isinstance(a, StatsContext) else a for a in args[1:]]
        yout = m(xin, *rest)
        names = ["in"] + [k for k, _ in m.named_parameters()]
        grads = torch.autograd.grad(yout, [xin, *m.parameters()], dy.to(where, yout.dtype))
        out[f"{n}/out"] = yout.detach().cpu().double()
        out.update({f"{n}/d_{k}": g.cpu().double() for k, g in zip(names, grads)})
    return out


def resnet_card_vs_cpu(dev, trained, corpus):
    """f32 ResNet-50 with TF32 off on a batch of 4 of the corpus at 224 x
    224, the card (cuDNN) against the CPU path, gated twice. Returns each
    gate's worst ``max|diff| / max|ref|`` and where.

    - The whole model at the seeded initial weights: the logits, the loss,
      every gradient and the new statistics against the CPU's f32, per leaf
      within ``TRAIN_GRAD_TOL``. There each block's last BatchNorm scale is
      zero, so the gradients of the convolutions and BatchNorms inside the
      blocks are zero on both sides: this gate holds the stem, the
      projections, the last BatchNorms, the pooling and the head.
    - Every layer alone at the weights the bf16 run trained
      (:func:`resnet_layers`): each convolution, BatchNorm and the head fed
      its input and its output's gradient from an f64 pass of the CPU path;
      its output and the gradients of its input and parameters in f32 on
      the card against the same layer in f64, within ``LAYER_TOL``: every
      convolution's forward, data and weight gradient at the main path's
      shapes, layout and pads, with live weights.

    The whole model with live weights is not held to f32 end to end: a
    pre-activation within f32's rounding of 0 flips relu's mask, and with
    it a share of a gradient leaf, on the CPU as on the card
    (``scripts/resnet_f32_probe.py``)."""
    import torch

    from fluxmpi_tpu_torch.models import ResNet50

    x = torch.from_numpy(corpus[0][:4])
    y = torch.from_numpy(corpus[1][:4])
    init = ResNet50(num_classes=1000, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in init.named_parameters()}
    stats = init.init_batch_stats()
    cpu = torch.device("cpu")
    whole = _max_rel(_resnet_grads(dev, torch.float32, params, stats, x, y),
                     _resnet_grads(cpu, torch.float32, params, stats, x, y))
    params, stats = trained
    params = {k: v.cpu() for k, v in params.items()}
    stats = {k: v.cpu() for k, v in stats.items()}
    feed = resnet_layers(cpu, torch.float64, params, stats, x, y)
    exact = resnet_layers(cpu, torch.float64, params, stats, x, y, feed)
    card = resnet_layers(dev, torch.float32, params, stats, x, y, feed)
    return whole, _max_rel(card, exact) + (len(exact),)


def cnn_run(dev, updates: int = 20, flush_every: int = 10, batch: int = 256):
    """The Conv+BN CNN at ``bench.py``'s ``_bench_cnn`` shape (batch 256 of
    32 x 32 x 3, f32, ``sgd(0.1, momentum=0.9)``) through ``train_loop``."""
    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import CNN
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    corpus = image_corpus(batch * flush_every, 32, 10, seed=1)
    model = CNN(num_classes=10, device=dev, generator=torch.Generator().manual_seed(0))
    fm.synchronize(model)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset(corpus)), global_batch_size=batch,
        shuffle=True, device=dev)
    opt = optim.sgd(0.1, momentum=0.9)
    step = make_train_step(_bn_loss(model), opt)
    state = TrainState.create(model, opt, model_state=model.init_batch_stats())
    state, summ = train_loop(step, state, loader, steps=updates, flush_every=flush_every)
    t0 = time.perf_counter()
    state, timed = train_loop(step, state, loader, steps=updates, flush_every=flush_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    width = timed["fused_window"] or 1
    per_update = [ms / width for ms in timed["step_ms"]]
    losses = [f["loss_mean"] for f in summ["flushes"] + timed["flushes"]]
    return dict(updates=summ["updates"] + timed["updates"], timed_updates=timed["updates"],
                fused_window=summ["fused_window"],
                images_per_sec=timed["updates"] * batch / wall,
                median_update_ms=float(np.median(per_update)), flush_loss_means=losses)


def deq_run(dev, steps: int = 50):
    """``examples/deq_regression.py`` (``DEQ(hidden=32, out=1)``, 128
    samples of 3 features, ``adam(5e-3)``) with each solver: one loss and
    implicit gradient on the card against the CPU path's, then ``steps``
    updates through ``train_loop`` (one-update CUDA-graph windows). The
    comparison solves to ``tol=1e-6`` (the example's 1e-4 could stop the
    two paths an iteration apart); training keeps the example's settings."""
    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import DEQ
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop

    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 3)).astype(np.float32)
    y = np.tanh(x.sum(axis=1, keepdims=True)).astype(np.float32)
    out = {}
    for solver in ("damped", "anderson", "broyden"):
        grads = []
        for where in (dev, torch.device("cpu")):
            model = DEQ(hidden=32, out=1, solver=solver, tol=1e-6, max_iter=100,
                        in_features=3, device=where)
            loss = ((model(torch.from_numpy(x).to(where))
                     - torch.from_numpy(y).to(where)) ** 2).mean()
            g = torch.autograd.grad(loss, list(model.parameters()))
            grads.append({"loss": loss.detach().cpu().reshape(1), **{
                k: t.cpu() for (k, _), t in zip(model.named_parameters(), g)}})
        err, leaf = _max_rel(*grads)
        model = DEQ(hidden=32, out=1, solver=solver, in_features=3, device=dev)
        fm.synchronize(model)

        def loss_fn(params, ms, batch, model=model):
            return ((model(batch[0]) - batch[1]) ** 2).mean(), ms

        opt = optim.adam(5e-3)
        step = make_train_step(loss_fn, opt)
        loader = fm.DistributedDataLoader(fm.ArrayDataset((x, y)), global_batch_size=128,
                                          device=dev)
        t0 = time.perf_counter()
        _, summ = train_loop(step, TrainState.create(model, opt), loader, steps=steps,
                             flush_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first, last = summ["flushes"][0]["loss"], summ["flushes"][-1]["loss"]
        out[solver] = dict(card_vs_cpu=err, worst_leaf=leaf, first_loss=first,
                           last_loss=last, updates=summ["updates"],
                           fused_window=summ["fused_window"],
                           ms_per_update=wall * 1e3 / summ["updates"],
                           graphs=len(graph_stats(step)))
    return out


def adapter_checks(dev):
    """The adapter path and the new collectives at world 1 over NCCL:
    ``synchronize(FluxModelWrapper(...))``, ``synchronize`` of a
    ``FlatParamVector`` in one collective (counted), ``iallreduce`` and
    ``ibcast`` with ``Request.wait`` against the blocking calls,
    ``donate=True``, ``barrier(tag=)`` and the ``host_*`` collectives."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch.models import MLP

    class Holder:
        def __init__(self):
            self.w = torch.arange(6.0, device=dev).reshape(2, 3)
            self.model = MLP((8, 1), device=dev)
            self.inner = type("Inner", (), {})()
            self.inner.b = torch.ones(4, device=dev, dtype=torch.bfloat16)

    obj = Holder()
    before = {k: v.clone() for k, v in obj.model.state_dict().items()}
    wrapped = fm.synchronize(fm.FluxModelWrapper(obj))
    checks = {"wrapper": wrapped.model is obj and torch.equal(obj.w.cpu(), torch.arange(
        6.0).reshape(2, 3)) and obj.inner.b.device == dev and all(
        torch.equal(v, before[k]) for k, v in obj.model.state_dict().items())}
    fpv = fm.FlatParamVector.from_tree({"w": torch.randn(3, 4, device=dev),
                                        "n": torch.arange(3, device=dev)})
    real, count = dist.broadcast, [0]

    def counted(*a, **k):
        count[0] += 1
        return real(*a, **k)

    dist.broadcast = counted
    try:
        synced = fm.synchronize(fpv)
    finally:
        dist.broadcast = real
    checks["flat_param_vector_one_collective"] = count[0] == 1 and torch.equal(
        synced.to_tree()["w"], fpv.to_tree()["w"]) and synced.to_tree()["n"].dtype == torch.int64
    tree = {"f": torch.randn(5, device=dev), "i": torch.arange(3, device=dev)}
    val, req = fm.iallreduce(tree, "mean")
    got = req.wait()
    checks["iallreduce"] = all(torch.equal(got[k], fm.allreduce(tree, "mean")[k])
                               and got[k] is val[k] for k in tree)
    checks["ibcast"] = all(torch.equal(w[k], tree[k])
                           for w in fm.Request.wait_all([fm.ibcast(tree)[1]]) for k in tree)
    t = torch.ones(4, device=dev)
    checks["donate"] = fm.allreduce(t, donate=True) is t and fm.bcast(t, donate=True) is t
    fm.barrier(tag="vision_phase")
    h = np.arange(4, dtype=np.int32)
    checks["host"] = (np.array_equal(fm.host_allreduce(h), h)
                      and np.array_equal(fm.host_allgather(h), h[None])
                      and np.array_equal(fm.host_bcast(h), h)
                      and fm.local_device_count() == torch.cuda.device_count())
    return checks


def vision_phase(device, updates: int = 32, flush_every: int = 8):
    """ResNet-50 at 224 x 224 in bf16 compute (batch 128, ``sgd(0.1,
    momentum=0.9)``, 1024 synthetic images in the device-gather loader)
    through ``train_loop(fuse="auto")`` beside ``fuse=False``, held bit for
    bit; the card against the CPU path in f32; the CNN; the DEQ; the
    adapters and collectives."""
    import torch

    import fluxmpi_tpu_torch as fm

    failures = []
    dev = fm.init()
    t0 = time.perf_counter()
    corpus = image_corpus(RESNET_IMAGES, RESNET_HW, RESNET_CLASSES)
    print(f"vision: {RESNET_IMAGES} images of {RESNET_HW}x{RESNET_HW}x3 uint8 "
          f"({corpus[0].nbytes / 1e6:.1f} MB), {RESNET_CLASSES} classes, made in {time.perf_counter() - t0:.2f}s", flush=True)
    pipe, pipe_sum, want, _ = resnet_run(dev, corpus, False, updates, flush_every)
    fused, fused_sum, got, (params, mstate) = resnet_run(dev, corpus, "auto", updates,
                                                         flush_every)
    same = [k for k in want if torch.equal(got[k], want[k])]
    flush = lambda s: [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])  # noqa: E731
                       for f in s["flushes"]]
    flush_same = flush(fused_sum) == flush(pipe_sum)
    moved = sum(not torch.equal(v, torch.zeros_like(v) if k.endswith(".mean")
                                else torch.ones_like(v))
                for k, v in got.items() if k.startswith("batch_stats/"))
    n_stats = sum(k.startswith("batch_stats/") for k in got)
    losses = [f["loss_mean"] for f in fused_sum["flushes"]]
    for run in (pipe, fused):
        prof = run["profile"]
        idle = prof["idle_share"]
        print(f"vision resnet50 [{'fused' if run['fuse'] else 'pipelined'}]: "
              f"{run['updates']} updates in {run['dispatches']} dispatches (fused_window "
              f"{run['fused_window']}); a second run of {updates}: {run['wall_seconds']:.3f}s "
              f"= {run['images_per_sec']:.1f} images/s; median {run['median_update_ms']:.2f} "
              f"ms per update = {run['steady_images_per_sec']:.1f} images/s; traced window "
              f"of {prof['updates']}: device busy {prof['device_busy_ms']:.3f} ms of "
              f"{prof['wall_ms']:.3f} ms wall (idle share "
              f"{idle if idle is None else round(idle, 4)}"
              f"); host launch calls per update {run['host_launches_per_update']:.2f} "
              f"(device kernels per update {run['device_kernels_per_update']:.1f}); peak "
              f"memory {run['peak_memory_gb']:.2f} GB"
              + (f"; capture and instantiate {run['capture_seconds']:.3f}s" if run["fuse"]
                 else ""), flush=True)
        for g, ms in prof["device_ms_by_group_per_update"].items():
            print(f"vision resnet50 [{'fused' if run['fuse'] else 'pipelined'}]:   {g:48s} "
                  f"{ms:9.3f} ms per update", flush=True)
        for name, ms in prof["top_kernels_ms_per_update"]:
            print(f"vision resnet50 [{'fused' if run['fuse'] else 'pipelined'}]:     kernel "
                  f"{ms:9.3f} ms per update  {name[:200]}", flush=True)
        if not prof["kernels"]:
            failures.append("vision: the ResNet-50 trace holds no device time")
    print(f"vision resnet50: fused vs pipelined: {len(same)} of {len(want)} parameters, "
          f"momentum buffers and BatchNorm statistics bit-identical; flush losses "
          f"{'identical' if flush_same else 'DIFFER'}; {moved} of {n_stats} statistics moved "
          f"from their init; flush mean losses {losses}", flush=True)
    if len(same) != len(want) or not flush_same:
        failures.append("vision: ResNet-50 fused differs from fuse=False")
    if moved != n_stats:
        failures.append(f"vision: {n_stats - moved} BatchNorm statistics did not move")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        failures.append(f"vision: ResNet-50 flush mean losses {losses} not finite and falling")
    if not fused["fused_window"] or sum(g["replays"] for g in fused["graphs"]) < 1:
        failures.append("vision: ResNet-50 fuse='auto' replayed no CUDA graph")
    t0 = time.perf_counter()
    (err, leaf), (lerr, lname, n_layer) = resnet_card_vs_cpu(dev, (params, mstate), corpus)
    print(f"vision resnet50 card vs CPU (f32, TF32 off, batch 4 at {RESNET_HW}x{RESNET_HW}): "
          f"the whole model at the seeded initial weights (logits, loss, every gradient and "
          f"statistic) against the CPU's f32: worst max|diff|/max|ref| {err:.3e} at {leaf} "
          f"(gate {TRAIN_GRAD_TOL:g}); every layer alone at the trained weights ({n_layer} "
          f"outputs and gradients of the convolutions, BatchNorms and head) against f64 on "
          f"the CPU: worst {lerr:.3e} at {lname} (gate {LAYER_TOL:g}); "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not err <= TRAIN_GRAD_TOL:
        failures.append(f"vision: ResNet-50 card vs CPU {err:.3e} at {leaf}")
    if not lerr <= LAYER_TOL:
        failures.append(f"vision: ResNet-50 layer on the card vs f64 {lerr:.3e} at {lname}")
    del params, mstate
    torch.cuda.empty_cache()

    cnn = cnn_run(dev)
    print(f"vision cnn (batch 256 of 32x32x3, f32): {cnn['images_per_sec']:.1f} images/s "
          f"over {cnn['timed_updates']} updates, median {cnn['median_update_ms']:.3f} ms per "
          f"update "
          f"(fused_window {cnn['fused_window']}); flush mean losses "
          f"{[round(v, 4) for v in cnn['flush_loss_means']]}", flush=True)
    if not (all(map(math.isfinite, cnn["flush_loss_means"]))
            and cnn["flush_loss_means"][-1] < cnn["flush_loss_means"][0]):
        failures.append("vision: CNN loss not finite and falling")
    deq = deq_run(dev)
    for solver, r in deq.items():
        print(f"vision deq [{solver}]: card vs CPU loss and implicit gradients "
              f"{r['card_vs_cpu']:.3e} ({r['worst_leaf']}); {r['updates']} updates "
              f"(fused_window {r['fused_window']}, {r['graphs']} window program) "
              f"{r['ms_per_update']:.2f} ms each with the capture; loss "
              f"{r['first_loss']:.5f} -> {r['last_loss']:.5f}", flush=True)
        if not r["card_vs_cpu"] <= 1e-4:
            failures.append(f"vision: DEQ {solver} card vs CPU {r['card_vs_cpu']:.3e}")
        if not r["last_loss"] < 0.5 * r["first_loss"]:
            failures.append(f"vision: DEQ {solver} loss {r['first_loss']} -> {r['last_loss']}")
    checks = adapter_checks(dev)
    print(f"vision adapters and collectives (world 1, NCCL): {checks}", flush=True)
    failures += [f"vision: {k} check failed" for k, ok in checks.items() if not ok]
    fm.shutdown()
    return dict(resnet50=dict(pipelined=pipe, fused=fused, leaves=len(want),
                              bit_identical=len(same), flushes_bit_identical=flush_same,
                              stats_moved=moved, flush_loss_means=losses,
                              card_vs_cpu=err, card_vs_cpu_leaf=leaf,
                              layers_vs_f64=lerr, layers_vs_f64_worst=lname),
                cnn=cnn, deq=deq, adapters=checks), failures


# Zoo phase (slice 6): ViT-B/16 and the DDPM UNet through the flash
# kernels' non-causal path (flash_attention_fn), the standalone encoder's
# mask path, the EMA and DDIM sampling.
VIT_B16 = dict(num_classes=1000, patch=16, num_layers=12, d_model=768, num_heads=12,
               d_ff=3072)
VIT_BATCH = 128
VIT_IMAGES = 1024   # eight batches per epoch: flush_every=8 windows are epochs
VIT_HW = 224
# bench.py's _bench_unet accelerator configuration.
UNET_BENCH = dict(out_channels=3, base_channels=128, channel_mults=(1, 2, 2, 4),
                  blocks_per_stage=2, attn_resolutions=(8,), num_heads=4, groups=8)
UNET_HW = 32
UNET_BATCH = 64
UNET_IMAGES = 512
UNET_STEPS = 1000
# Attention layers each update crosses (launches of each kernel per update).
ZOO_ATTN = {"vit": VIT_B16["num_layers"], "unet": 6}


def _zoo_group(name: str) -> str:
    """Kernel groups of the zoo phase: the three attention kernels, layer
    norm, then the vision groups (GroupNorm's arithmetic is f32
    elementwise and reductions there)."""
    n = name.lower()
    for kern in MMA_KERNELS:
        if kern in n:
            return _kernel_group(kern)
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "nvjet" in n:  # cuBLAS's Hopper matmul kernels
        return "convolutions (cuDNN) and matmuls"
    g = _vision_group(name)
    return {"f32 elementwise (BatchNorm arithmetic)": "f32 elementwise (GroupNorm, DDPM, "
            "softmax-free arithmetic)",
            "reductions (BatchNorm statistics, scale and bias gradients)":
            "reductions (norm statistics, bias gradients)",
            "bf16 elementwise (relu, residual adds)": "bf16 elementwise (gelu, silu, "
            "residual adds)"}.get(g, g)


def unet_images(n: int, hw: int, seed: int = 0):
    """``n`` f32 NHWC images in [-1, 1] from ``default_rng(seed)``: smooth
    random fields (a coarse grid upsampled) plus a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (n, hw // 8, hw // 8, 3))
    fine = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    return np.clip(fine + 0.1 * rng.normal(size=fine.shape), -1, 1).astype(np.float32)


def _vit_loss(model):
    import torch
    import torch.nn.functional as F

    def loss_fn(params, model_state, batch):
        x, y = batch
        return F.cross_entropy(model(x.to(torch.float32) / 255.0), y), model_state

    return loss_fn


def zoo_build(kind: str, dev, dtype, data):
    """The user's script for ``kind`` ("vit" or "unet"): the model (weights
    from ``manual_seed(0)``) with ``attention_fn=flash_attention_fn()``,
    the device-gather loader over ``data``, the step and its state.
    Returns ``(model, loader, step, state, loss_fn, draws)``: ``draws`` is
    the CUDA generator of the UNet's ``ddpm_loss`` (None for ViT)."""
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import UNet, ViT, cosine_beta_schedule, ddpm_loss
    from fluxmpi_tpu_torch.ops import flash_attention_fn
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    gen = torch.Generator().manual_seed(0)
    draws = None
    if kind == "vit":
        model = ViT(**VIT_B16, dtype=dtype, attention_fn=flash_attention_fn(),
                    image_size=VIT_HW, device=dev, generator=gen)
        batch, opt, loss_fn = VIT_BATCH, optim.adamw(1e-3), _vit_loss(model)
    else:
        model = UNet(**UNET_BENCH, dtype=dtype, attention_fn=flash_attention_fn(),
                     image_size=UNET_HW, device=dev, generator=gen)
        betas = cosine_beta_schedule(UNET_STEPS, device=dev)
        draws = torch.Generator(device=dev).manual_seed(42)

        def loss_fn(params, model_state, b):
            return ddpm_loss(model, params, b[0], draws, betas), model_state

        batch, opt = UNET_BATCH, optim.adam(1e-4)
    fm.synchronize(model)
    loader = fm.DistributedDataLoader(fm.DistributedDataContainer(fm.ArrayDataset(data)),
                                      global_batch_size=batch, shuffle=True, device=dev)
    step = make_train_step(loss_fn, opt)
    return model, loader, step, TrainState.create(model, opt), loss_fn, draws


def zoo_run(kind, dev, data, fuse, updates: int, flush_every: int):
    """The main path of ``kind`` in bf16 compute (counts of the wrappers
    and the kernels' device counters set to 0 just before, read just
    after), a second run of as many updates for the times, a traced window
    by kernel name and the host's launch calls over another. Returns the
    numbers, the first run's summary, its state's leaves, and the model,
    loader, step and state for what follows."""
    import numpy as np
    import torch

    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import train_loop

    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    batch = VIT_BATCH if kind == "vit" else UNET_BATCH
    model, loader, step, state, _, _ = zoo_build(kind, dev, torch.bfloat16, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kern in kernels:
        kern.launches = 0
    (state, summ), launches = kernel_launches(
        lambda: train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                           fuse=fuse))
    counted = {k.__name__: k.launches for k in kernels}
    extra = graph_launches(step)
    accounted = {n: counted[n] + extra[n] for n in counted}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    leaves = {f"params/{k}": v.detach().clone() for k, v in state.params.items()}
    for m in ("mu", "nu"):
        leaves.update({f"{m}/{k}": v.clone() for k, v in state.opt_state[m].items()})
    leaves["count"] = state.opt_state["count"].clone()
    t0 = time.perf_counter()
    state, timed = train_loop(step, state, loader, steps=updates, flush_every=flush_every,
                              fuse=fuse)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    width = summ["fused_window"] or 1
    per_update = [ms / width for ms in timed["step_ms"]]
    run = dict(fuse=fuse, updates=summ["updates"], dispatches=summ["dispatches"],
               fused_window=summ["fused_window"], wall_seconds=wall,
               images_per_sec=timed["updates"] * batch / wall,
               median_update_ms=float(np.median(per_update)), step_ms=timed["step_ms"],
               peak_memory_gb=peak_gb, launches=launches, counted_launches=counted,
               accounted_launches=accounted, graphs=graph_stats(step),
               flushes=summ["flushes"])
    run["steady_images_per_sec"] = batch / run["median_update_ms"] * 1e3
    (_, tsum), busy_ms, wall_ms, nk, by_name = traced(
        lambda: train_loop(step, state, loader, steps=width, flush_every=flush_every,
                           fuse=fuse), group=lambda name: name)
    groups = {}
    for name, ms in by_name.items():
        groups[_zoo_group(name)] = groups.get(_zoo_group(name), 0.0) + ms
    n = tsum["updates"]
    run["profile"] = dict(updates=n, wall_ms=wall_ms, device_busy_ms=busy_ms, kernels=nk,
                          idle_share=(1 - busy_ms / wall_ms) if nk else None,
                          device_ms_by_group_per_update={
                              g: ms / n for g, ms in sorted(groups.items(),
                                                            key=lambda kv: -kv[1])},
                          top_kernels_ms_per_update=[
                              (name, ms / n) for name, ms in list(by_name.items())[:15]])
    (_, hsum), calls, nk2 = host_launches(
        lambda: train_loop(step, state, loader, steps=width, flush_every=flush_every,
                           fuse=fuse))
    run["host_launches_per_update"] = calls / hsum["updates"]
    run["device_kernels_per_update"] = nk2 / hsum["updates"]
    if fuse:
        run["capture_seconds"] = sum(g["capture_seconds"] for g in graph_stats(step))
    return run, summ, leaves, (model, loader, step, state)


def _grads(model, loss_fn, batch, fresh=None):
    """The gradients of one loss on ``batch`` (``fresh()`` resets the
    loss's random draws first), keyed by parameter name."""
    import torch

    if fresh is not None:
        fresh()
    names = [n for n, _ in model.named_parameters()]
    loss = loss_fn(dict(model.named_parameters()), None, batch)[0]
    return dict(zip(names, torch.autograd.grad(loss, [p for _, p in model.named_parameters()])))


def zoo_grad_model(kind, dev, dtype, data):
    """``kind``'s model in ``dtype`` compute for the gradient gates, with
    its loss, a ``fresh()`` that resets the loss's random draws (None for
    ViT) and the loader's first batch. The UNet runs at its seeded weights
    + 0.1·N(0, 1) from a fixed generator: seeded, its zero-initialised
    attention ``out`` kernels, ``conv2`` and ``conv_out`` zero every
    attention cotangent."""
    import torch

    model, loader, _, _, loss_fn, draws = zoo_build(kind, dev, dtype, data)
    if kind == "unet":
        pert = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=pert).to(dev))
    start = draws.get_state() if draws is not None else None
    fresh = (lambda: draws.set_state(start)) if draws is not None else None
    return model, loss_fn, fresh, next(iter(loader))


def leaf_max_rel(got: dict, want: dict) -> dict:
    """Per leaf ``max|diff| / max|want|``; a key bias (zero in exact
    arithmetic: the softmax's row sums cancel its gradient, so both sides
    hold rounding) against the largest ``max|want|`` of any leaf."""
    top = max(g.abs().max().item() for g in want.values())
    return {k: (got[k].double() - g.double()).abs().max().item()
            / (top if k.endswith("attn.key.bias") else (g.abs().max().item() or 1.0))
            for k, g in want.items()}


def zoo_grad_gates(kind, dev, data):
    """One update's gradients through the kernels against the same update
    through the plain versions, per leaf, three gates:

    - bf16 at the main path's batch: ||diff|| / ||g|| <= 2**-8 x 2 x the
      attention layers on every leaf the bf16 computation resolves, that is
      whose plain bf16 gradient stands within that tolerance of the same
      update's f32 gradient (plain versions, same weights and batch);
    - f32 (TF32 off) at the main path's batch, every leaf:
      ``leaf_max_rel`` <= TRAIN_GRAD_TOL. This one also holds the leaves
      bf16 does not resolve (their bf16 gradient is mostly rounding: the
      key biases and, where the tokens share a large common part, the
      query and key projections, whose gradients the softmax's row sums
      cancel down to the tokens' spread), and it sees a 1% error in dK,
      which the bf16 gate does not (``scripts/zoo_grad_probe.py``);
    - f32 at batch 8: max|diff| / max|g| <= TRAIN_GRAD_TOL (key biases
      excluded).

    The UNet runs at perturbed weights (``zoo_grad_model``). Returns the
    gates' worst ratios and leaves, the unresolved leaves' count and how
    far their plain bf16 gradient (key biases aside) stands from f32
    (least and largest, over ||g||), and the attention parameters whose
    gradient is zero."""
    import torch

    def pair(model, loss_fn, fresh, batch):
        g_kernel = _grads(model, loss_fn, batch, fresh)
        with plain_attention():
            g_plain = _grads(model, loss_fn, batch, fresh)
        return g_kernel, g_plain

    out = {}
    model, loss_fn, fresh, batch = zoo_grad_model(kind, dev, torch.bfloat16, data)
    g_kernel, g_plain = pair(model, loss_fn, fresh, batch)
    zero_attn = [f"{k} (bf16)" for k, g in g_kernel.items()
                 if ".attn." in k and k.endswith("kernel") and not g.abs().max() > 0]
    del model
    model32, loss32, fresh32, _ = zoo_grad_model(kind, dev, torch.float32, data)
    g_kernel32, g_f32 = pair(model32, loss32, fresh32, batch)
    tol = 2 ** -8 * 2 * ZOO_ATTN[kind]
    gate, spread = {}, {}
    for k, gp in g_plain.items():
        ref = g_f32[k].double()
        dp = (gp.double() - ref).norm().item()
        if dp <= tol * ref.norm().item():
            gate[k] = (g_kernel[k].double() - gp.double()).norm().item() / (
                gp.double().norm().item() or 1.0)
        else:
            spread[k] = dp / (ref.norm().item() or 1.0)
    worst = max(gate, key=gate.get)
    out["bfloat16"] = (gate[worst], worst, len(gate))
    rel = leaf_max_rel(g_kernel32, g_f32)
    worst = max(rel, key=rel.get)
    out["float32_main"] = (rel[worst], worst, len(rel))
    named = [v for k, v in spread.items() if not k.endswith("attn.key.bias")]
    out["bfloat16_unresolved"] = (len(spread), min(named) if named else None,
                                  max(named) if named else None)
    del g_kernel, g_plain, g_kernel32, g_f32
    batch8 = tuple(t[:8] for t in batch)
    g_kernel, g_plain = pair(model32, loss32, fresh32, batch8)
    torch.cuda.synchronize()
    rel = {k: (g_kernel[k] - g).abs().max().item() / (g.abs().max().item() or 1.0)
           for k, g in g_plain.items() if not k.endswith("attn.key.bias")}
    worst = max(rel, key=rel.get)
    out["float32"] = (rel[worst], worst, len(rel))
    zero_attn += [f"{k} (f32)" for k, g in g_kernel.items()
                  if ".attn." in k and k.endswith("kernel") and not g.abs().max() > 0]
    del model32, g_kernel, g_plain
    torch.cuda.empty_cache()
    return out, zero_attn


def vit_card_vs_cpu(dev, corpus):
    """ViT-B/16 in f32 with TF32 off at the seeded weights, batch 4: the
    logits, the loss and every gradient on the card (the kernels) against
    the CPU path (the plain versions), per leaf max|diff| / max|ref| (the
    key biases against the largest gradient); the worst and its leaf."""
    import torch

    from fluxmpi_tpu_torch.models import ViT
    from fluxmpi_tpu_torch.ops import flash_attention_fn

    x = torch.from_numpy(corpus[0][:4])
    y = torch.from_numpy(corpus[1][:4])
    res = []
    for where in (dev, torch.device("cpu")):
        model = ViT(**VIT_B16, attention_fn=flash_attention_fn(), image_size=VIT_HW,
                    device=where, generator=torch.Generator().manual_seed(0))
        logits = model(x.to(where).float() / 255.0)
        loss = torch.nn.functional.cross_entropy(logits, y.to(where))
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        r = {f"grad/{k}": g.detach().cpu().double() for k, g in zip(names, grads)}
        r["logits"] = logits.detach().cpu().double()
        r["loss"] = loss.detach().cpu().double().reshape(1)
        res.append(r)
        del model, logits, grads
    card, cpu = res
    # A key bias's gradient is zero in exact arithmetic (the softmax's row
    # sums cancel it): both sides hold rounding there, held against the
    # largest gradient; the other leaves against their own.
    top = max(v.abs().max().item() for k, v in cpu.items() if k.startswith("grad/"))
    worst = (0.0, None)
    for k, want in cpu.items():
        scale = top if k.endswith("attn.key.bias") else (want.abs().max().item() or 1.0)
        err = (card[k] - want).abs().max().item() / scale
        worst = max(worst, (err, k), key=lambda t: t[0])
    return worst


def encoder_mask_check(dev, batch: int = 8, seq: int = 197):
    """A ``TransformerEncoder`` at ViT-B's widths (f32, TF32 off) with a
    flax padding mask, trailing pads of a different length per row,
    through ``flash_attention_fn`` against the same weights' dense masked
    attend: the output's real rows and the gradients of a loss over them,
    per leaf max|diff| / max|ref| (key biases against the largest). A pad
    row's query attends nothing: the kernels output 0 there, flax's dense
    attend an average of every value; no real row reads a pad row."""
    import torch

    from fluxmpi_tpu_torch.models import TransformerEncoder
    from fluxmpi_tpu_torch.ops import flash_attention_fn

    widths = dict(num_layers=VIT_B16["num_layers"], d_model=VIT_B16["d_model"],
                  num_heads=VIT_B16["num_heads"], d_ff=VIT_B16["d_ff"])
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(batch, seq, widths["d_model"], generator=gen).to(dev)
    w = torch.randn(batch, seq, widths["d_model"], generator=gen).to(dev)
    lengths = torch.tensor([seq - 13 * i for i in range(batch)], device=dev)
    valid = torch.arange(seq, device=dev)[None] < lengths[:, None]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    w = w * valid[:, :, None]
    res = {}
    for label, kw in (("flash", dict(attention_fn=flash_attention_fn())), ("dense", {})):
        enc = TransformerEncoder(**widths, **kw, device=dev,
                                 generator=torch.Generator().manual_seed(0))
        out = enc(x, mask=mask)
        names = [k for k, _ in enc.named_parameters()]
        grads = torch.autograd.grad((out * w).sum(), list(enc.parameters()))
        res[label] = {"out": (out * valid[:, :, None]).detach(),
                      **{k: g for k, g in zip(names, grads)}}
    top = max(g.abs().max().item() for k, g in res["dense"].items() if k != "out")
    rel = {k: (res["flash"][k] - g).abs().max().item()
           / (top if k.endswith("attn.key.bias") else (g.abs().max().item() or 1.0))
           for k, g in res["dense"].items()}
    worst = max(rel, key=rel.get)
    return rel["out"], rel[worst], worst, len(rel)


def zoo_phase(device, updates: int = 32, flush_every: int = 8):
    """ViT-B/16 (bf16 compute, batch 128 of 224 x 224, adamw(1e-3), 1024
    synthetic uint8 images) and the DDPM UNet of ``bench.py``'s
    ``_bench_unet`` (bf16, batch 64 of 32 x 32 in [-1, 1], adam(1e-4),
    ``ddpm_loss`` over ``cosine_beta_schedule(1000)``), each with
    ``attention_fn=flash_attention_fn()``, through ``train_loop(fuse="auto")``
    beside ``fuse=False``, held bit for bit, with the launch, loss and
    gradient gates; ViT on the card against the CPU in f32; the encoder's
    mask path; then the UNet's EMA over 8 more updates and DDIM samples
    from the EMA weights."""
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch.models import cosine_beta_schedule, ddim_sample
    from fluxmpi_tpu_torch.utils import ema_init, ema_params, ema_update

    failures, stats = [], {}
    dev = fm.init()
    t0 = time.perf_counter()
    data = {"vit": image_corpus(VIT_IMAGES, VIT_HW, RESNET_CLASSES),
            "unet": (unet_images(UNET_IMAGES, UNET_HW),)}
    print(f"zoo: {VIT_IMAGES} ViT images of {VIT_HW}x{VIT_HW}x3 uint8, {UNET_IMAGES} UNet "
          f"images of {UNET_HW}x{UNET_HW}x3 f32 in [-1, 1]; made in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    flush = lambda s: [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])  # noqa: E731
                       for f in s["flushes"]]
    kept = None
    for kind in ("vit", "unet"):
        pipe, pipe_sum, want, rest = zoo_run(kind, dev, data[kind], False, updates,
                                             flush_every)
        del rest
        torch.cuda.empty_cache()
        fused, fused_sum, got, rest = zoo_run(kind, dev, data[kind], "auto", updates,
                                              flush_every)
        if kind == "unet":
            kept = rest
        else:
            n_params = sum(p.numel() for p in rest[0].parameters())
            del rest
        torch.cuda.empty_cache()
        same = [k for k in want if torch.equal(got[k], want[k])]
        flush_same = flush(fused_sum) == flush(pipe_sum)
        losses = [f["loss_mean"] for f in fused_sum["flushes"]]
        need = ZOO_ATTN[kind] * updates
        replays = sum(g["replays"] for g in fused["graphs"])
        for run in (pipe, fused):
            prof, tag = run["profile"], f"zoo {kind} [{'fused' if run['fuse'] else 'pipelined'}]"
            idle = prof["idle_share"]
            print(f"{tag}: {run['updates']} updates in {run['dispatches']} dispatches "
                  f"(fused_window {run['fused_window']}); a second run of {updates}: "
                  f"{run['wall_seconds']:.3f}s = {run['images_per_sec']:.1f} images/s; median "
                  f"{run['median_update_ms']:.2f} ms per update = "
                  f"{run['steady_images_per_sec']:.1f} images/s; traced window of "
                  f"{prof['updates']}: device busy {prof['device_busy_ms']:.3f} ms of "
                  f"{prof['wall_ms']:.3f} ms wall (idle share "
                  f"{idle if idle is None else round(idle, 4)}); host launch calls per update "
                  f"{run['host_launches_per_update']:.2f} (device kernels per update "
                  f"{run['device_kernels_per_update']:.1f}); peak memory "
                  f"{run['peak_memory_gb']:.2f} GB; launches the device counted "
                  f"{run['launches']} (need {need} each; the wrappers' with the graphs' "
                  f"{run['accounted_launches']})"
                  + (f"; capture and instantiate {run['capture_seconds']:.3f}s"
                     if run["fuse"] else ""), flush=True)
            for g, ms in prof["device_ms_by_group_per_update"].items():
                print(f"{tag}:   {g:52s} {ms:9.3f} ms per update", flush=True)
            for name, ms in prof["top_kernels_ms_per_update"]:
                print(f"{tag}:     kernel {ms:9.3f} ms per update  {name[:200]}", flush=True)
            if run["launches"] != {k: need for k in MMA_KERNELS}:
                failures.append(f"zoo {kind}: launches {run['launches']}, not {need} each")
            if run["accounted_launches"] != run["launches"]:
                failures.append(f"zoo {kind}: the wrappers' counts with the graphs' "
                                f"{run['accounted_launches']} differ from the device's "
                                f"{run['launches']}")
            if not prof["kernels"]:
                failures.append(f"zoo {kind}: the trace holds no device time")
        print(f"zoo {kind}: fused vs pipelined: {len(same)} of {len(want)} parameters, "
              f"moments and the count bit-identical; flush losses "
              f"{'identical' if flush_same else 'DIFFER'}; {replays} graph replays; flush "
              f"mean losses {losses}", flush=True)
        if len(same) != len(want) or not flush_same:
            failures.append(f"zoo {kind}: the fused run differs from fuse=False")
        if not fused["fused_window"] or replays < updates // flush_every - 1:
            failures.append(f"zoo {kind}: fuse='auto' replayed {replays} CUDA graphs")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            failures.append(f"zoo {kind}: flush mean losses {losses} not finite and falling")
        t0 = time.perf_counter()
        gates, zero_attn = zoo_grad_gates(kind, dev, data[kind])
        bf16_tol = 2 ** -8 * 2 * ZOO_ATTN[kind]
        (b_err, b_leaf, b_n), (f_err, f_leaf, f_n) = gates["bfloat16"], gates["float32"]
        m_err, m_leaf, m_n = gates["float32_main"]
        u_n, lo, hi = gates["bfloat16_unresolved"]
        spread = ("all key biases" if lo is None else f"their plain bf16 gradients, key "
                  f"biases aside, stand {lo:.3f}-{hi:.3f} of ||g|| from f32")
        batch = VIT_BATCH if kind == "vit" else UNET_BATCH
        print(f"zoo {kind}: gradients through the kernels vs the plain versions"
              + (" at the seeded weights + 0.1 N(0, 1)" if kind == "unet" else "")
              + f": bf16 (batch {batch}) per leaf ||diff||/||g|| worst {b_err:.3e} "
              f"({b_leaf}) over {b_n} leaves (tol {bf16_tol:g} = 2**-8 x 2 x "
              f"{ZOO_ATTN[kind]}) of the leaves whose plain bf16 gradient stands within "
              f"that of the f32 one (not the {u_n} others: {spread}); f32 (batch {batch}, TF32 "
              f"off) per leaf max|diff|/max|g| (key biases against the largest) worst "
              f"{m_err:.3e} ({m_leaf}) over {m_n} leaves (tol {TRAIN_GRAD_TOL:g}); f32 "
              f"(batch 8) per "
              f"leaf max|diff|/max|g| worst {f_err:.3e} ({f_leaf}) over {f_n} leaves (tol "
              f"{TRAIN_GRAD_TOL:g}); attention kernels with a zero gradient: "
              f"{zero_attn or 'none'}; {time.perf_counter() - t0:.1f}s", flush=True)
        if not b_err <= bf16_tol:
            failures.append(f"zoo {kind}: bf16 kernel gradients {b_err:.3e} at {b_leaf}")
        if not m_err <= TRAIN_GRAD_TOL:
            failures.append(f"zoo {kind}: f32 kernel gradients at batch {batch} "
                            f"{m_err:.3e} at {m_leaf}")
        if not f_err <= TRAIN_GRAD_TOL:
            failures.append(f"zoo {kind}: f32 kernel gradients {f_err:.3e} at {f_leaf}")
        if zero_attn:
            failures.append(f"zoo {kind}: zero attention gradients {zero_attn}")
        stats[kind] = dict(pipelined=pipe, fused=fused, leaves=len(want), bit_identical=len(same),
                           flushes_bit_identical=flush_same, flush_loss_means=losses,
                           replays=replays, launches_needed=need, grad_bf16=gates["bfloat16"],
                           grad_bf16_unresolved=gates["bfloat16_unresolved"],
                           grad_f32_main=gates["float32_main"],
                           grad_f32=gates["float32"])
        if kind == "vit":
            stats[kind]["parameters"] = n_params
            t0 = time.perf_counter()
            err, leaf = vit_card_vs_cpu(dev, data["vit"])
            print(f"zoo vit: ViT-B/16 ({n_params} parameters) card vs CPU (f32, TF32 off, "
                  f"batch 4 at the seeded weights): logits, loss and every gradient, worst "
                  f"max|diff|/max|ref| {err:.3e} at {leaf} (gate {TRAIN_GRAD_TOL:g}); "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            stats[kind].update(card_vs_cpu=err, card_vs_cpu_leaf=leaf)
            if not err <= TRAIN_GRAD_TOL:
                failures.append(f"zoo vit: card vs CPU {err:.3e} at {leaf}")
            if n_params != 86567656:
                failures.append(f"zoo vit: {n_params} parameters, not ViT-B/16's 86567656")
            out_err, g_err, g_leaf, n_leaves = encoder_mask_check(dev)
            print(f"zoo encoder mask path (ViT-B widths, f32, batch 8 x 197, trailing pads "
                  f"0-91 per row, flash_attention_fn vs the dense masked attend): real rows' "
                  f"output max|diff|/max|ref| {out_err:.3e}, gradients worst {g_err:.3e} "
                  f"({g_leaf}) over {n_leaves - 1} leaves (tol {TRAIN_GRAD_TOL:g})",
                  flush=True)
            stats["encoder_mask"] = dict(out_rel_err=out_err, grad_rel_err=g_err,
                                         grad_worst=g_leaf)
            if not (out_err <= TRAIN_GRAD_TOL and g_err <= TRAIN_GRAD_TOL):
                failures.append(f"zoo encoder mask path: {out_err:.3e} / {g_err:.3e}")
        torch.cuda.empty_cache()

    # The UNet's EMA over 8 more updates, then DDIM samples from it.
    model, loader, step, state = kept
    ema = ema_init(state.params, decay=0.95)
    n = 0
    while n < 8:
        for batch in loader:
            if n == 8:
                break
            state, _ = step(state, batch)
            ema = ema_update(ema, state.params)
            n += 1
    betas = cosine_beta_schedule(UNET_STEPS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = ddim_sample(model, ema_params(ema), torch.Generator(device=dev).manual_seed(1),
                          shape=(8, UNET_HW, UNET_HW, 3), betas=betas, num_steps=20)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(samples).all())
    peak = samples.abs().max().item()
    print(f"zoo unet: ema_init(decay=0.95), {int(ema.count)} ema_update calls after as many "
          f"step() updates; ddim_sample(num_steps=20) of 8 images from the EMA weights in "
          f"{sample_s:.3f}s: finite {finite}, max|x| {peak:.6f} (clip 1 + 1e-5), mean|x| "
          f"{samples.abs().mean().item():.4f}", flush=True)
    stats["unet"].update(ema_updates=int(ema.count), ddim_seconds=sample_s,
                         sample_max_abs=peak, samples_finite=finite)
    if not (finite and peak <= 1.0 + 1e-5 and samples.shape == (8, UNET_HW, UNET_HW, 3)):
        failures.append(f"zoo unet: DDIM samples finite={finite}, max|x| {peak}")
    del model, loader, step, state, kept, ema, samples
    torch.cuda.empty_cache()
    fm.shutdown()
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
    paths = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in _build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"  {name}: {line}")
    sass = sass_mma_counts(paths)
    sass_failures = []
    for name, counts in sass.items():
        print(f"kernel {name}: tensor-core instructions in SASS (cuobjdump -sass): "
              + " ".join(f"{op} {n}" for op, n in counts.items()), flush=True)
        if name in MMA_KERNELS and not sum(counts.values()):
            sass_failures.append(f"{name}: no tensor-core instruction in its SASS")

    kernels, results, failures = run_phases(device)
    failures = sass_failures + failures
    for kern in kernels:
        kern["sass_tensor_core_instructions"] = sass.get(kern["name"])
    print(json.dumps({"kernels": kernels, **results, "card": card}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(device):
    """All phases on ``device``; returns the kernels' rows, the serving and
    training results, and the failures."""
    import torch

    rows, failures = kernel_phase(device)
    bwd_rows, masks, bwd_failures = backward_phase(device)
    failures += bwd_failures
    stats, slice_failures = slice_phase(device)
    failures += slice_failures
    torch.cuda.empty_cache()
    train, train_failures = train_phase(device)
    failures += train_failures
    torch.cuda.empty_cache()
    bf16, bf16_failures = bf16_phase(device, train)
    failures += bf16_failures
    torch.cuda.empty_cache()
    fused, fused_failures = fused_phase(device, bf16)
    failures += fused_failures
    torch.cuda.empty_cache()
    telem, telem_failures = telemetry_phase(device)
    failures += telem_failures
    torch.cuda.empty_cache()
    vision, vision_failures = vision_phase(device)
    failures += vision_failures
    torch.cuda.empty_cache()
    zoo, zoo_failures = zoo_phase(device)
    failures += zoo_failures
    zoo_paths = {f"zoo_{kind}{'' if run == 'fused' else '_pipelined'}":
                 zoo[kind][run]["launches"] for kind in ("vit", "unet")
                 for run in ("pipelined", "fused")}

    def zoo_rows(rows, keys):
        return {f"{r['case']} {r['dtype']}": {k: r.get(k) for k in keys}
                for r in rows if r["case"] in ZOO_TABLE_CASES}

    fwd_row = next(r for r in rows if r["case"] == "decode_1024" and r["dtype"] == "float32")
    fwd_train = next(r for r in rows if r["case"] == "train_1024" and r["dtype"] == "float32")
    bwd_main = next(r for r in bwd_rows if r["case"] == "train_1024"
                    and r["dtype"] == "float32")
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "fluxmpi_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "fluxmpi_tpu/ops/flash_attention.py:185",
        "launches": (stats["launches"] + train["launches"]["flash_fwd"]
                     + bf16["launches"]["flash_fwd"]
                     + bf16["remat"]["remat"]["launches"]["flash_fwd"]
                     + bf16["remat"]["dots"]["launches"]["flash_fwd"]
                     + fused["fused"]["launches"]["flash_fwd"]
                     + telem["planes_on"]["launches"]["flash_fwd"]
                     + sum(n["flash_fwd"] for n in zoo_paths.values())),
        "launches_by_path": {"serve": stats["launches"],
                             "train": train["launches"]["flash_fwd"],
                             "train_bf16": bf16["launches"]["flash_fwd"],
                             "train_bf16_remat":
                                 bf16["remat"]["remat"]["launches"]["flash_fwd"],
                             "train_bf16_remat_dots":
                                 bf16["remat"]["dots"]["launches"]["flash_fwd"],
                             "train_bf16_fused": fused["fused"]["launches"]["flash_fwd"],
                             "train_bf16_telemetry":
                                 telem["planes_on"]["launches"]["flash_fwd"],
                             **{p: n["flash_fwd"] for p, n in zoo_paths.items()}},
        "max_abs_err": max(max(r["err_out"], r["err_lse"]) for r in rows),
        "ms": fwd_row["ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": fwd_row["bound_by"],
        "bound_basis": fwd_row["bound_basis"],
        "library_ms": fwd_row["library_ms"],
        "timed_case": "decode_1024 float32",
        "train_case": {k: fwd_train[k] for k in ("ms", "plain_ms", "bound_ms",
                                                  "bound_by", "bound_basis",
                                                  "fma_bound_ms", "library_ms")},
        "dropout_mask_equal": masks["flash_fwd"],
        "zoo_cases": zoo_rows(rows, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "err_out", "err_lse")),
        "cases": rows,
    }]
    for kname, key, errs in (("flash_bwd_dq", "dq", ("dq",)),
                             ("flash_bwd_dkv", "dkv", ("dk", "dv"))):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"fluxmpi_tpu_torch/ops/csrc/{kname}.cu",
            "replaces": ("fluxmpi_tpu/ops/flash_attention.py:306" if key == "dq"
                         else "fluxmpi_tpu/ops/flash_attention.py:399"),
            "launches": (train["launches"][kname] + bf16["launches"][kname]
                         + bf16["remat"]["remat"]["launches"][kname]
                         + bf16["remat"]["dots"]["launches"][kname]
                         + fused["fused"]["launches"][kname]
                         + telem["planes_on"]["launches"][kname]
                         + sum(n[kname] for n in zoo_paths.values())),
            "launches_by_path": {"train": train["launches"][kname],
                                 "train_bf16": bf16["launches"][kname],
                                 "train_bf16_remat":
                                     bf16["remat"]["remat"]["launches"][kname],
                                 "train_bf16_remat_dots":
                                     bf16["remat"]["dots"]["launches"][kname],
                                 "train_bf16_fused": fused["fused"]["launches"][kname],
                                 "train_bf16_telemetry":
                                     telem["planes_on"]["launches"][kname],
                                 **{p: n[kname] for p, n in zoo_paths.items()}},
            "max_abs_err": max(r["err"][e] for r in bwd_rows for e in errs),
            "ms": bwd_main[f"{key}_ms"],
            # The plain version computes dQ, dK and dV in one pass; the
            # yardstick is the whole SDPA backward: both beside the sum
            # dterm + dQ + dK/dV.
            "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main[f"{key}_bound_ms"],
            "bound_by": bwd_main[f"{key}_bound_by"],
            "bound_basis": bwd_main["bound_basis"],
            "fma_bound_ms": bwd_main[f"{key}_fma_bound_ms"],
            "library_ms": bwd_main["library_ms"],
            "dterm_ms": bwd_main["dterm_ms"],
            "sum_dterm_dq_dkv_ms": bwd_main["sum_ms"],
            "timed_case": "train_1024 float32",
            "dropout_mask_equal": masks[kname],
            "zoo_cases": zoo_rows(bwd_rows, (f"{key}_ms", "plain_ms", f"{key}_bound_ms",
                                             f"{key}_bound_by", "library_ms", "dterm_ms",
                                             "rel_err")),
            "cases": [{k: r[k] for k in ("case", "dtype", "err", "rel_err", "ok",
                                         f"{key}_ms", f"{key}_bound_ms")}
                      for r in bwd_rows],
        })
    return kernels, {"slice": stats, "train": train, "train_bf16": bf16,
                     "train_bf16_fused": fused, "train_bf16_telemetry": telem,
                     "vision": vision, "zoo": zoo}, failures


if __name__ == "__main__":
    sys.exit(main())
