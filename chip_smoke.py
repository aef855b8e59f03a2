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
   Serving plane phase (``serving_plane_phase``): GPT-2 small from an
   HF-layout state dict through ``lm_from_gpt2``, served through
   ``init(serving=..., request_log=..., telemetry=...)`` by a background
   ``InferenceEngine`` with SLOs in float32 and bfloat16 (f32 streams equal
   ``generate()`` token for token; bf16 streams bit-identical across
   admission orders and, where they differ from ``generate()``, first
   differing at a near-tie within delta = 4 x the largest |bf16 - f32|
   logit), a preemption drain, a ``serving.decode`` fault on the
   background thread, the request log and the registry's JSONL through
   ``scripts/check_metrics_schema.py`` and ``scripts/serving_report.py``,
   sampled/scan/``top_k=1`` ``generate`` and ``beam_search`` on the card;
   ``flash_fwd`` launches counted on every path.
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
11. Fine-tune phase (``finetune_phase``): stock GPT-2 small at dropout 0.1
   (see the function).
12. Health phase (``health_phase``): the fused bf16 run of ``fused_phase``
   with the anomaly detector, compile monitor, model stats, exporter,
   fleet collector, goodput and auto-profiler on beside every plane off
   (bit for bit, launches by the device counters, ms and host launch
   calls per update, ``goodput.mfu_productive`` against the steady
   state); a live scrape of ``/metrics``, ``/status`` and ``/healthz``
   through the schema, ``scripts/fluxmpi_top.py`` and
   ``scripts/fleet_report.py``; a later window of another width firing
   ``steady_state_retrace`` (``window_compile_seconds`` equal to its
   capture seconds, one auto-profiler trace); ``nan_grad`` halting on one
   layer's poisoned gradient and naming it; serving's ``slo_burn`` under an
   SLO no request meets, its board read by ``scripts/fluxmpi_top.py``.

13. Parallel phase (``parallel_phase``): ``init(parallel=ParallelConfig())``
   (the plan of one device over NCCL; its ``describe()`` printed) and
   ``MoETransformerLM`` at Switch-Base-8 widths (d_model 768, d_ff 3072,
   12 heads, 12 layers, 8 experts, top-1, capacity factor 1.25; GPT-2's
   vocabulary 50257 and max_len 1024; ``attention="flash"``; f32 masters,
   bf16 compute through ``policy=get_policy("bf16")``, adamw, batch 8 x
   1024 synthetic tokens): 8 updates with no plan, under
   ``make_train_step(parallel=plan)`` (``style="auto"``) and under
   ``style="shard_map"``, every loss, parameter and adamw moment
   bit-identical; the ``"auto"`` step through ``train_loop(fuse="auto")``
   and ``fuse=False`` (12 updates, windows of 4: captured and replayed)
   bit for bit; 12 launches of each kernel per update by the kernels'
   device counters and the wrappers' accounting; ms per update, tokens/s,
   peak memory, and device time by group from one traced update
   (attention kernels, expert matmuls, router and dispatch/combine
   einsums, the other matmuls, the rest by kernel group; matmuls told
   apart by their operands' shapes) with the 15 costliest kernels; then
   greedy ``generate`` of 16 tokens, ``prefill="auto"`` (the scan for MoE)
   equal to ``prefill="scan"``.
14. Autotune phase (``autotune_phase``): a GPT-2-small-width
   ``TransformerLM`` (f32, ``attention="flash"``, adamw, a sample batch of
   8 x 1024 synthetic tokens): 12 updates with no plan (``init()``), then
   ``shutdown()`` and ``init(parallel="auto")``; ``autotune`` at world 1
   (one candidate; its memory floor beside the card's ``bytes_limit``; one
   trial of one CUDA-graph capture and no re-capture; the record valid
   under the port's validator); a second ``autotune`` answered by the
   bank with the trial replaced by one that raises; a ``bytes_limit``
   below the floor raising "every candidate layout exceeds";
   ``make_train_step(parallel="auto")`` through ``train_loop(fuse="auto")``
   and ``fuse=False`` (12 updates, windows of 4), bit for bit against each
   other and against the run with no plan, 12 launches of each kernel per
   update by the device counters; a checkpoint save writing
   ``<path>.autotune.json`` and the manifest's fingerprint; ms per update,
   the trial's examples/s and the search's seconds.
15. Elastic phase (``elastic_phase``): GPT-2-small widths (bf16 compute,
   f32 masters, adamw 3e-4, ``attention="flash"``), ``lm_corpus(n=256)``
   in the device-gather loader with an id column whose rows each update
   logs into a device buffer (a graph replay runs no Python). (1) An
   uninterrupted fused epoch at global batch 8 (``flush_every=4``); a
   ``fuse=False`` run with ``save_every=4`` killed by
   ``data.fetch@step=13`` (newest committed step 12); its resume at
   global batch 16 (cursor 6, 10 updates in windows of 2): the ids the
   steps consumed equal the uninterrupted order exactly,
   ``resumed_from`` 12, ``train.resumes{topology_changed="true"}`` 1,
   finite losses. (2) ``init(resize=<bank>)`` and ``request_resize(1)``:
   the fused run drains at its first flush, saves and stamps; the resumed
   run's final parameters, moments and step are bit for bit the
   uninterrupted run's; one record, valid under the port's validator and
   ``scripts/check_metrics_schema.py``, its phase seconds printed; the
   stamp gone. (3) Four CPU gloo children (``--shard-child``) commit the
   f32 state sharded by ``fsdp_rule``; the card restores it with
   ``parallel=ParallelConfig(dp=1)`` and a meta ``like``: every leaf bit
   for bit the state built on the card, and 4 fused updates from each bit
   for bit; each child's bytes and the restore's seconds printed. Launches
   by the device counters for every run.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, without the last line, if CUDA is absent, the
package is missing, or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
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
        # Kernel dropout (the seed read from device memory) at the training
        # shape and ViT-B/16's.
        ("train_1024_dropout", 8, 1024, 1024, 12, 12, 64, True, None, None, 0.1),
        ("vit_197_dropout", 128, 197, 197, 12, 12, 64, False, None, None, 0.1),
    ]


# The dropout cases, timed beside their dropout-free shapes.
DROPOUT_TABLE_CASES = ("train_1024_dropout", "vit_197_dropout")
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
        (("train_1024_dropout", 8, 1024, 1024, 12, 12, 64, True, None, None, 0.1), False),
        (("vit_197_dropout", 128, 197, 197, 12, 12, 64, False, None, None, 0.1), False),
    ]


DROPOUT_SEED = 1234


def device_seed(device):
    """``DROPOUT_SEED`` as the kernels read it (an int32 on the card), made
    once outside the timed graphs, as the training path hands it over."""
    import torch

    return torch.tensor([DROPOUT_SEED], dtype=torch.int32, device=device)


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
                        seed=device_seed(device))
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
    iff the kernel kept it. The seed goes through the wrappers once as an
    int and once as a tensor on the card (the kernels read it from device
    memory either way); both must give the reference's mask. Returns
    {kernel: masks equal}."""
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
    lse = torch.zeros(b, h, s, device=device)
    dterm = torch.zeros(b, h, s, device=device)
    ones = torch.zeros(b, s, h, d, device=device)
    ones[..., 0] = 1.0
    equal = {"flash_fwd": True, "flash_bwd_dq": True, "flash_bwd_dkv": True}
    for seed in (DROPOUT_SEED, torch.tensor(DROPOUT_SEED, device=device)):
        opts = dict(dropout_rate=rate, seed=seed)
        out, _ = flash_fwd(zeros, zeros, eye, **opts)
        dq = flash_bwd_dq(zeros, eye, ones, None, None, ones, lse, dterm, **opts)
        _, dv = flash_bwd_dkv(zeros, zeros, zeros, None, None, eye, lse, dterm, **opts)
        torch.cuda.synchronize()
        for name, got in (("flash_fwd", out.permute(0, 2, 1, 3)),
                          ("flash_bwd_dq", dq.permute(0, 2, 1, 3)),
                          ("flash_bwd_dkv", dv.permute(0, 2, 3, 1))):
            equal[name] = equal[name] and bool(torch.equal(got != 0, keep))
    return {**equal, "keep_fraction": keep.float().mean().item()}


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
                        seed=device_seed(device))
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
            if name in TABLE_CASES or name in DROPOUT_TABLE_CASES:
                row["dterm_ms"] = device_ms(dterm_fn, **counts)
                row["plain_ms"] = device_ms(lambda: flash_attention_bwd_reference(
                    q, k, v, g, lse, dterm, q_seg=qseg, kv_seg=kseg, **opts), **counts)
                # A dropping SDPA draws its own random mask: no yardstick there.
                row["library_ms"], row["library_ms_repeats"] = (None, []) if rate else \
                    sdpa_backward_ms(q, k, v, g, case)
                row["sum_ms"] = row["dterm_ms"] + dq_ms + dkv_ms
            rows.append(row)
            extra = ""
            if "plain_ms" in row:
                extra = (f" dterm_ms={row['dterm_ms']:.4f} sum_ms={row['sum_ms']:.4f} "
                         f"plain_ms={row['plain_ms']:.4f} library_ms(sdpa bwd)="
                         + ("n/a" if row["library_ms"] is None else
                            f"{row['library_ms']:.4f} (median of "
                            f"{len(row['library_ms_repeats'])} graph replays: "
                            + " ".join(f"{t:.4f}" for t in row["library_ms_repeats"])
                            + ")"))
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


# GPT-2 small as HuggingFace's GPT2Config spells it (the stock config:
# gelu_new, pdrops 0.1, tied head), for serving_plane_phase.
GPT2_HF_CONFIG = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                      n_head=12, n_inner=None, layer_norm_epsilon=1e-5,
                      activation_function="gelu_new", resid_pdrop=0.1,
                      embd_pdrop=0.1, attn_pdrop=0.1)
SERVE_REQUESTS = 24
# Latency objectives (seconds): the slice phase's TTFT p50 on the card
# (16 requests, two waves of 8 slots) replaces SLO_TTFT_S when run_phases
# has it, so the first of the three waves of 24 requests meets it and the
# queued ones break it.
SLO_TTFT_S = 0.3
SLO_TOKEN_S = 0.05


def gpt2_state_dict(cfg: dict, seed: int = 0) -> dict:
    """GPT-2 weights under HF's key names and layouts (``Conv1D`` kernels
    ``[in, out]``): every matrix and embedding N(0, 0.02) from
    ``torch.Generator().manual_seed(seed)``, biases 0, LayerNorm scales 1,
    ``lm_head`` tied to ``wte``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d, v = cfg["n_embd"], cfg["vocab_size"]

    def normal(*shape):
        return torch.randn(shape, generator=g) * 0.02

    sd = {"transformer.wte.weight": normal(v, d),
          "transformer.wpe.weight": normal(cfg["n_positions"], d),
          "transformer.ln_f.weight": torch.ones(d), "transformer.ln_f.bias": torch.zeros(d)}
    for i in range(cfg["n_layer"]):
        h = f"transformer.h.{i}"
        sd.update({
            f"{h}.ln_1.weight": torch.ones(d), f"{h}.ln_1.bias": torch.zeros(d),
            f"{h}.attn.c_attn.weight": normal(d, 3 * d),
            f"{h}.attn.c_attn.bias": torch.zeros(3 * d),
            f"{h}.attn.c_proj.weight": normal(d, d), f"{h}.attn.c_proj.bias": torch.zeros(d),
            f"{h}.ln_2.weight": torch.ones(d), f"{h}.ln_2.bias": torch.zeros(d),
            f"{h}.mlp.c_fc.weight": normal(d, 4 * d), f"{h}.mlp.c_fc.bias": torch.zeros(4 * d),
            f"{h}.mlp.c_proj.weight": normal(4 * d, d), f"{h}.mlp.c_proj.bias": torch.zeros(d),
        })
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def replay_scores(model, prompt, tokens, *, temperature: float = 0.0, top_k=None,
                  top_p=None, seed: int = 0):
    """The scores ``generate(prefill="batched")`` takes the argmax of at
    each generated position, replayed with its run's ``tokens`` ``[b,
    new]`` fed back: the logits (greedy), or the filtered, scaled logits
    plus the Gumbel noise a generator seeded with ``seed`` on the model's
    device draws (sampling). The same calls as ``generate``, so the argmax
    of each row is ``generate``'s token. Returns float32 ``[new, b,
    vocab]``."""
    import torch

    from fluxmpi_tpu_torch.models.generate import _filter_logits, _gumbel, prefill_cache

    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, plen = prompt.shape
    new = tokens.shape[1]
    rng = None
    with torch.no_grad():
        cache, _ = prefill_cache(model, prompt[:, : plen - 1], plen + new)
        if temperature > 0:
            rng = torch.Generator(device=dev).manual_seed(seed)
            for _ in range(plen - 1):
                _gumbel(b, model.vocab_size, rng, dev)
        tok = prompt[:, plen - 1:]
        out = []
        for j in range(new):
            pos = torch.full((b,), plen - 1 + j, dtype=torch.long, device=dev)
            logits = model(tok, pos_offset=pos, kv_cache=cache)[:, -1]
            if rng is None:
                out.append(logits.float())
            else:
                out.append(_filter_logits(logits, temperature, top_k, top_p)
                           + _gumbel(b, model.vocab_size, rng, dev))
            tok = tokens[:, j:j + 1]
    return torch.stack(out)


def first_gaps(ref, got, scores) -> list:
    """For each row of ``ref`` and ``got`` (``[b, new]`` token arrays of two
    runs; ``scores`` the ``[new, b, vocab]`` that ``ref``'s run took the
    argmax of, from :func:`replay_scores`): ``None`` where the rows are
    equal, else ``(position, gap)`` at their first difference, ``gap`` =
    ``scores[ref token] - scores[got token]`` (0 for an exact tie). Raises
    if the replay's argmax is not ``ref``'s token up to there."""
    import numpy as np

    out = []
    for row in range(len(ref)):
        diff = np.flatnonzero(np.asarray(ref[row]) != np.asarray(got[row]))
        upto = int(diff[0]) if diff.size else len(ref[row]) - 1
        arg = scores[: upto + 1, row].argmax(-1).cpu().numpy()
        if not np.array_equal(arg, np.asarray(ref[row][: upto + 1])):
            raise RuntimeError(f"replay of row {row} disagrees with its run")
        if not diff.size:
            out.append(None)
            continue
        s = scores[upto, row]
        out.append((upto, float(s[int(ref[row][upto])] - s[int(got[row][upto])])))
    return out


def serving_plane_phase(device, slo_ttft_s: float = SLO_TTFT_S):
    """Serving through the plane at GPT-2-small width, from an HF-layout
    checkpoint: ``lm_from_gpt2`` of a ``SimpleNamespace`` config and state
    dict (:func:`gpt2_state_dict`; the stock pdrops 0.1, which inference
    ignores) on the CPU, its ``variables`` loaded into
    ``TransformerLM(attention="flash")`` on the card in float32 and in
    bfloat16 (f32 parameters, bf16 compute). Gates:

    - the card's f32 logits (flash) against the CPU conversion's (naive
      attention) on 2 x 40 tokens within 1e-3;
    - under ``init(serving={"slots": 8, "block_size": 16},
      request_log=<tmp>, telemetry=<tmp jsonl>)``, an engine with
      ``slo_ttft_s`` and ``slo_token_s=SLO_TOKEN_S`` serves 24 requests
      (prompts 8-200 tokens from ``default_rng(0)``, 16 new tokens, 64 for every 8th)
      from ``start()``; two are consumed with ``stream()`` on this thread,
      all awaited, then ``stop()``; in f32 and bf16. Every request
      finishes, ``serve_error`` is None, some requests break an SLO and
      some do not, ``flash_fwd`` launched at least layers x (prefills +
      decode steps) times; f32 streams equal ``generate()`` token for
      token; bf16 streams are bit-identical when the same requests are
      served inline with static batching and in a shuffled submit order,
      and where one differs from ``generate()`` its first difference is
      a near-tie: ``generate()``'s logit for the engine's token within
      delta of its top logit, delta = 4 x the largest |bf16 - f32| logit
      of the two models on the 24 prompts;
    - an inline ``run()`` of 12 requests whose first raises
      ``request_preemption()`` at its third token: ``preempted``, the 8
      active requests finish with the background run's tokens, the 4
      queued are rejected ``"preempted"``;
    - ``serving.decode`` armed to raise on a background run: the error is
      banked in ``serve_error``, every pending request is rejected with
      reason ``"error"``, ``close()`` drops the pools;
    - ``scripts/check_metrics_schema.py`` accepts the registry's JSONL and
      the request log, every request of the phase has a log line, and
      ``scripts/serving_report.py --json`` counts as many finished and
      rejected requests as ``serving.requests_completed`` and the
      ``serving.admission_rejects`` sum;
    - ``generate`` in f32 and bf16 on 2 x 40 tokens, 32 new: two sampled
      calls (``temperature=0.8, top_k=50, top_p=0.95``, a CUDA generator)
      with equal seeds are equal; scan equals batched, greedy and sampled;
      ``top_k=1`` equals greedy (bf16: equal, or the first difference a
      near-tie as above, delta / temperature on the sampled scores);
    - ``beam_search`` (f32): beam 4 gives finite scores, beam 1 equals
      greedy.

    ``flash_fwd``'s launches are counted on every path (zeroed before,
    read after each). Returns the stats and the failures."""
    import os
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, runtime, telemetry
    from fluxmpi_tpu_torch.errors import FaultInjectedError
    from fluxmpi_tpu_torch.models import (TransformerLM, beam_search, generate,
                                          lm_from_gpt2, load_flax_params)
    from fluxmpi_tpu_torch.ops.flash_attention import flash_fwd
    from fluxmpi_tpu_torch.serving import InferenceEngine

    failures = []
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    cfg = GPT2_HF_CONFIG
    layers, vocab = cfg["n_layer"], cfg["vocab_size"]
    sd = gpt2_state_dict(cfg)
    hf = SimpleNamespace(config=SimpleNamespace(**cfg), state_dict=lambda: sd)
    cpu_model, variables = lm_from_gpt2(hf, device="cpu")
    fields = dict(vocab_size=vocab, max_len=cpu_model.max_len, num_layers=layers,
                  d_model=cpu_model.d_model, num_heads=cpu_model.num_heads,
                  d_ff=cpu_model.d_ff, dropout=cpu_model.dropout, ln_eps=cpu_model.ln_eps)
    models = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        models[name] = load_flax_params(
            TransformerLM(**fields, attention="flash", dtype=dtype, device=device), variables)
    print(f"serving_plane: lm_from_gpt2 of GPT2Config {cfg} (N(0, 0.02) weights, "
          f"seed 0), dropout {cpu_model.dropout}, loaded into f32 and bf16 "
          f"TransformerLM(attention='flash') on the card in "
          f"{time.perf_counter() - t_phase:.2f}s", flush=True)

    toks = np.random.default_rng(1).integers(0, vocab, (2, 40))
    with torch.no_grad():
        card = models["f32"](torch.from_numpy(toks).to(device), train=False).cpu()
        ref = cpu_model(torch.from_numpy(toks), train=False)
    conv_err = float((card - ref).abs().max())
    ok = bool(torch.isfinite(card).all()) and conv_err <= 1e-3
    print(f"serving_plane: card f32 flash logits vs the CPU conversion (naive) "
          f"max_abs_err={conv_err:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("serving_plane: converted logits")
    del cpu_model, ref, card

    rng = np.random.default_rng(0)
    specs = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(8, 201))
        specs.append((rng.integers(0, vocab, plen).astype(np.int32),
                      64 if i % 8 == 7 else 16))
    lengths = tuple(len(p) for p, _ in specs)
    err = 0.0
    with torch.no_grad():
        for p, _ in specs:
            x = torch.from_numpy(p).to(device)[None]
            err = max(err, float((models["bf16"](x, train=False).float()
                                  - models["f32"](x, train=False)).abs().max()))
    delta = 4 * err
    print(f"serving_plane: largest |bf16 - f32| logit on the {len(specs)} prompts "
          f"{err:.4e}; delta = 4x = {delta:.4e}", flush=True)

    launches = {}
    stats = dict(card=card_line(), converted_logit_err=conv_err, bf16_logit_err=err,
                 delta=delta)
    all_ids = []  # every request the phase submits: each must be logged

    def counted(path, fn):
        flash_fwd.launches = 0
        out = fn()
        launches[path] = flash_fwd.launches
        return out

    def serve_background(name):
        model = models[name]
        eng = InferenceEngine(model, slo_ttft_s=slo_ttft_s, slo_token_s=SLO_TOKEN_S)
        eng.warmup(prompt_lengths=lengths)
        torch.cuda.synchronize()

        def drive():
            t0 = time.perf_counter()
            eng.start()
            reqs = [eng.submit(p, n) for p, n in specs]
            streamed = {i: list(reqs[i].stream(timeout=600)) for i in (0, 7)}
            done = all(r.wait(timeout=600) for r in reqs)
            wall = time.perf_counter() - t0
            return reqs, streamed, done, wall, eng.stop()

        reqs, streamed, done, wall, stopped = counted(f"serve_plane_{name}", drive)
        all_ids.extend(r.id for r in reqs)
        summary = eng.run()  # run() inline after stop(): the totals, a flush
        n = launches[f"serve_plane_{name}"]
        need = layers * (eng.prefills + summary["decode_steps"])
        ttft = np.array([r.ttft_s for r in reqs if r.ttft_s is not None])
        per_tok = np.array([r.per_token_s for r in reqs if r.per_token_s is not None])
        run = dict(slots=eng.slots, block_size=eng.block_size, wall_seconds=wall,
                   tokens=summary["tokens"], tokens_per_sec=summary["tokens"] / wall,
                   completed=summary["completed"], decode_steps=summary["decode_steps"],
                   prefills=eng.prefills, slo_violations=summary["slo_violations"],
                   slo_ok=sum(1 for r in reqs if r.status == "finished" and not (
                       r.ttft_s > slo_ttft_s or (r.per_token_s or 0) > SLO_TOKEN_S)),
                   ttft_p50_ms=float(np.median(ttft) * 1e3),
                   ttft_max_ms=float(ttft.max() * 1e3),
                   per_token_p50_ms=float(np.median(per_tok) * 1e3),
                   launches=n, need=need, serve_error=repr(eng.serve_error))
        print(f"serving_plane {name}: {run['completed']}/{len(specs)} served from the "
              f"background thread ({eng.slots} slots, block {eng.block_size}), "
              f"{run['tokens']} tokens in {wall:.3f}s = {run['tokens_per_sec']:.1f} "
              f"tokens/s; TTFT p50 {run['ttft_p50_ms']:.1f} ms max "
              f"{run['ttft_max_ms']:.1f} ms; per-token p50 {run['per_token_p50_ms']:.2f} "
              f"ms; SLO violations {run['slo_violations']} ({run['slo_ok']} requests "
              f"within both, TTFT {slo_ttft_s * 1e3:.1f} ms, per token "
              f"{SLO_TOKEN_S * 1e3:.0f} ms); decode_steps={run['decode_steps']} prefills="
              f"{run['prefills']}; flash_fwd launches={n} (need >= {need}); "
              f"serve_error={eng.serve_error!r}", flush=True)
        if not (done and stopped and eng.serve_error is None
                and all(r.status == "finished" for r in reqs)):
            failures.append(f"serving_plane {name}: background run did not finish "
                            f"cleanly (serve_error={eng.serve_error!r})")
        if any(streamed[i] != reqs[i].tokens for i in streamed):
            failures.append(f"serving_plane {name}: stream() differs from the tokens")
        if n < need or n == 0:
            failures.append(f"serving_plane {name}: flash_fwd launched {n} < {need}")
        if not (0 < run["slo_violations"] and 0 < run["slo_ok"]):
            failures.append(f"serving_plane {name}: SLOs broken by none or by all")
        eng.close()
        return run, [list(r.tokens) for r in reqs]

    def serve_inline(name, order, continuous):
        eng = InferenceEngine(models[name], continuous=continuous)
        reqs = {i: eng.submit(*specs[i]) for i in order}
        summary = counted(f"serve_plane_{name}_{'cont' if continuous else 'static'}",
                          eng.run)
        eng.close()
        all_ids.extend(r.id for r in reqs.values())
        if summary["completed"] != len(specs):
            failures.append(f"serving_plane {name}: an inline run left requests")
        return [list(reqs[i].tokens) for i in range(len(specs))]

    def references(name):
        return counted(f"generate_refs_{name}", lambda: [
            generate(models[name], p[None], n)[0, len(p):].tolist() for p, n in specs])

    prev = telemetry.set_registry(telemetry.MetricsRegistry())
    tmp = tempfile.mkdtemp()
    log_spec = os.path.join(tmp, "requests.{process}.jsonl")
    jsonl = os.path.join(tmp, "metrics.jsonl")
    try:
        fm.init(serving={"slots": 8, "block_size": 16}, request_log=log_spec,
                telemetry=jsonl)
        runs, streams = {}, {}
        for name in ("f32", "bf16"):
            runs[name], streams[name] = serve_background(name)
        stats["runs"] = runs

        f32_ref = references("f32")
        same = sum(a == b for a, b in zip(streams["f32"], f32_ref))
        print(f"serving_plane f32: {same}/{len(specs)} streams equal generate() token "
              f"for token", flush=True)
        if same != len(specs):
            failures.append(f"serving_plane f32: {len(specs) - same} streams differ "
                            f"from generate()")

        static = serve_inline("bf16", range(len(specs)), continuous=False)
        shuffled = serve_inline("bf16", np.random.default_rng(5).permutation(len(specs)),
                                continuous=True)
        orders = (static == streams["bf16"], shuffled == streams["bf16"])
        print(f"serving_plane bf16: streams bit-identical to the background run with "
              f"static batching {orders[0]}, in a shuffled submit order {orders[1]}",
              flush=True)
        if not all(orders):
            failures.append("serving_plane bf16: streams depend on admission order")
        bf16_ref = references("bf16")
        gaps = []
        for i, ((p, n), got, want) in enumerate(zip(specs, streams["bf16"], bf16_ref)):
            if got == want:
                continue
            scores = replay_scores(models["bf16"], p[None], [want])
            pos, gap = first_gaps([want], [got], scores)[0]
            gaps.append(dict(request=i, position=pos, gap=gap))
        bad = [g for g in gaps if g["gap"] > delta]
        stats["bf16_vs_generate"] = dict(differ=len(gaps), gaps=gaps)
        print(f"serving_plane bf16: {len(specs) - len(gaps)}/{len(specs)} streams equal "
              f"generate(); {len(gaps)} differ, each at a first difference where "
              f"generate()'s top logit leads the engine's token by: "
              + (", ".join(f"req {g['request']} pos {g['position']} gap {g['gap']:.4e}"
                           for g in gaps) or "-")
              + f" (delta {delta:.4e}) {'ok' if not bad else 'FAIL'}", flush=True)
        if bad:
            failures.append(f"serving_plane bf16: {len(bad)} streams differ from "
                            f"generate() by more than delta")

        # Preemption drain, inline.
        eng = InferenceEngine(models["f32"])
        seen = []

        def preempt(tok):
            seen.append(tok)
            if len(seen) == 3:
                runtime.request_preemption()

        pre = [eng.submit(p, n, on_token=preempt if i == 0 else None)
               for i, (p, n) in enumerate(specs[:12])]
        try:
            summ = counted("serve_plane_preempted", eng.run)
        finally:
            runtime.clear_preemption()
        eng.close()
        finished = [i for i, r in enumerate(pre) if r.status == "finished"]
        rejected = [r.reject_reason for r in pre if r.status == "rejected"]
        exact = all(pre[i].tokens == streams["f32"][i] for i in finished)
        ok = (summ["preempted"] and summ["drained"] == 8 and len(finished) == 8
              and rejected == ["preempted"] * 4 and exact)
        stats["preemption"] = dict(summary=summ, finished=len(finished), rejected=rejected)
        print(f"serving_plane preemption: preempted={summ['preempted']} drained="
              f"{summ['drained']} finished {len(finished)} (tokens equal the background "
              f"run {exact}), rejected {rejected} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append("serving_plane: preemption drain")
        all_ids += [r.id for r in pre]

        # A fault in the decode tick of a background run.
        eng = InferenceEngine(models["f32"])
        with faults.scope("serving.decode@step=3"):
            eng.start()
            bad_reqs = [eng.submit(p, n) for p, n in specs[:4]]
            waited = all(r.wait(timeout=300) for r in bad_reqs)
        eng.stop()
        banked = eng.serve_error
        eng.close()
        ok = (waited and isinstance(banked, FaultInjectedError)
              and all(r.reject_reason == "error" for r in bad_reqs)
              and eng.cache._k_pool is None and eng.cache._v_pool is None)
        stats["fault"] = dict(serve_error=repr(banked),
                              reasons=[r.reject_reason for r in bad_reqs])
        print(f"serving_plane fault: serve_error={banked!r}, reasons "
              f"{[r.reject_reason for r in bad_reqs]}, pools dropped by close() "
              f"{eng.cache._k_pool is None} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append("serving_plane: fault in the decode tick")
        all_ids += [r.id for r in bad_reqs]
    finally:
        runtime.clear_preemption()
        reg = telemetry.get_registry()
        fm.shutdown()  # closes the request log, flushes the registry's JSONL
        telemetry.set_registry(prev)
    counters = {}
    for m in reg.snapshot():
        if m["type"] == "counter" and m["name"].startswith("serving."):
            counters[m["name"]] = counters.get(m["name"], 0) + m["value"]
    log_path = log_spec.format(process=0)
    with open(log_path) as f:
        logged = {json.loads(line)["request_id"] for line in f}
    missing = [i for i in all_ids if i not in logged]
    check = subprocess.run([sys.executable, str(root / "scripts" / "check_metrics_schema.py"),
                            jsonl, log_path], capture_output=True, text=True, timeout=300)
    report = subprocess.run([sys.executable, str(root / "scripts" / "serving_report.py"),
                             "--json", log_path], capture_output=True, text=True, timeout=300)
    try:
        rep = json.loads(report.stdout)
    except ValueError:
        rep = {}
    ok = (check.returncode == 0 and report.returncode == 0 and not missing
          and rep.get("finished") == counters.get("serving.requests_completed")
          and rep.get("rejected") == counters.get("serving.admission_rejects"))
    stats["readers"] = dict(logged=len(logged), report={k: rep.get(k) for k in (
        "requests", "finished", "rejected", "reject_reasons", "slo_ok")}, counters=counters)
    print(f"serving_plane readers: check_metrics_schema rc={check.returncode}, "
          f"serving_report rc={report.returncode}: {stats['readers']['report']}; "
          f"serving.requests_completed={counters.get('serving.requests_completed')} "
          f"serving.admission_rejects={counters.get('serving.admission_rejects')}; "
          f"{len(logged)} requests logged, {len(missing)} of the checked ones missing "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("serving_plane: the stdlib readers disagree with the registry "
                        f"({check.stdout[-500:]}{check.stderr[-500:]}{report.stderr[-500:]})")

    # generate and beam_search on the card.
    prompt = torch.from_numpy(toks).to(device)
    samp = dict(temperature=0.8, top_k=50, top_p=0.95)
    gen_stats = {}
    for name, model in models.items():
        def gen(path, seed=None, **kw):
            rng = None if seed is None else torch.Generator(device=device).manual_seed(seed)
            out = counted(f"generate_{name}_{path}", lambda: generate(model, prompt, 32,
                                                                      rng=rng, **kw))
            if launches[f"generate_{name}_{path}"] < layers * 32:
                failures.append(f"serving_plane generate {name} {path}: flash_fwd "
                                f"launched {launches[f'generate_{name}_{path}']} times")
            return out[:, 40:].tolist()

        greedy = gen("greedy")
        sampled = gen("sampled", 0, **samp)
        checks = {
            "sampled twice": (sampled, gen("sampled_again", 0, **samp), None),
            "scan = batched, greedy": (greedy, gen("scan", prefill="scan"), {}),
            "scan = batched, sampled": (sampled,
                                        gen("sampled_scan", 0, prefill="scan", **samp),
                                        dict(seed=0, **samp)),
            "top_k=1 = greedy": (greedy, gen("top_k1", 1, temperature=0.8, top_k=1), {}),
        }
        results = {}
        for what, (ref_t, got_t, replay) in checks.items():
            if ref_t == got_t:
                results[what] = "equal"
                continue
            if name == "f32" or replay is None:
                results[what] = "DIFFER"
                failures.append(f"serving_plane generate {name}: {what} differ")
                continue
            scores = replay_scores(model, prompt, ref_t, **replay)
            limit = delta / replay.get("temperature", 1.0)
            found = [g for g in first_gaps(ref_t, got_t, scores) if g is not None]
            results[what] = [dict(position=p, gap=g) for p, g in found]
            if any(g > limit for _, g in found):
                failures.append(f"serving_plane generate {name}: {what} differ by more "
                                f"than delta")
        gen_stats[name] = results
        print(f"serving_plane generate {name} (2 x 40 tokens, 32 new): {results}",
              flush=True)
    beam4, scores4 = counted("beam_search_f32_beam4",
                             lambda: beam_search(models["f32"], prompt, 32, beam_size=4))
    beam1, _ = beam_search(models["f32"], prompt, 32, beam_size=1)
    greedy = generate(models["f32"], prompt, 32)
    ok = (bool(torch.isfinite(scores4).all()) and torch.equal(beam1, greedy)
          and beam4.shape == greedy.shape
          and launches["beam_search_f32_beam4"] >= layers * 32)
    gen_stats["beam_search"] = dict(scores=scores4.tolist(),
                                    beam1_equals_greedy=torch.equal(beam1, greedy))
    print(f"serving_plane beam_search f32: beam 4 scores {scores4.tolist()}, beam 1 "
          f"equals greedy {torch.equal(beam1, greedy)}, flash_fwd launches "
          f"{launches['beam_search_f32_beam4']} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("serving_plane: beam_search")
    stats["generate"] = gen_stats
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"serving_plane: flash_fwd launches by path {launches}; phase "
          f"{stats['seconds']:.1f}s; {stats['card']}", flush=True)
    del models
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
                              (name, ms / n) for name, ms in list(by_name.items())[:15]],
                          kernel_names=sorted(by_name))
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
        differ = sorted(((float((got[k].float() - want[k].float()).abs().max()), k)
                         for k in want if k not in same), reverse=True)
        print(f"vision resnet50: the {len(differ)} leaves that differ, largest "
              f"max|fused - pipelined| first: {differ[:12]}; flush losses fused "
              f"{flush(fused_sum)} pipelined {flush(pipe_sum)}", flush=True)
        a, b = (set(r["profile"]["kernel_names"]) for r in (pipe, fused))
        print(f"vision resnet50: kernels only in the pipelined traced window "
              f"{sorted(a - b)}; only in the fused one {sorted(b - a)}", flush=True)
        # Which side moved: a second fuse=False run against the first.
        _, again_sum, again, _ = resnet_run(dev, corpus, False, updates, flush_every)
        print(f"vision resnet50: a second fuse=False run: "
              f"{sum(torch.equal(again[k], want[k]) for k in want)} of {len(want)} leaves "
              f"bit-identical to the first, flush losses "
              f"{'identical' if flush(again_sum) == flush(pipe_sum) else 'DIFFER'}; to the "
              f"fused run {sum(torch.equal(again[k], got[k]) for k in got)}", flush=True)
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


# Fine-tuning phase (slice 9): stock GPT-2 small as serving_plane_phase
# builds it (HF's GPT2Config, pdrops 0.1, so dropout 0.1), bf16 compute
# with f32 masters, batch 8 x 1024, adamw(3e-4), world 1 over NCCL.
FINETUNE_BATCH = 8
FINETUNE_ROWS = 512        # the transformed host dataset: rows of
FINETUNE_ROW_TOKENS = 1088  # lm_corpus tokens, cropped to 1025 per row


def _tree_digest(tree) -> str:
    """SHA-256 over a tree's tensor leaves (name order), bytes as stored:
    two trees with the same digest are bit-identical."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].detach().contiguous().cpu()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_staging_ops(params, grads):
    """``synchronize`` on ``params``, then ``allreduce``, ``bcast``,
    ``reduce`` and ``iallreduce`` on ``grads``: per op the seconds (host
    wall, the card synchronized on both sides) and the result's digest."""
    import torch

    import fluxmpi_tpu_torch as fm

    def iallreduce(tree):
        value, request = fm.iallreduce(tree)
        request.wait()
        return value

    out = {}
    for name, fn, tree in (("synchronize", fm.synchronize, params),
                           ("allreduce", fm.allreduce, grads), ("bcast", fm.bcast, grads),
                           ("reduce", fm.reduce, grads), ("iallreduce", iallreduce, grads)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(tree)
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.perf_counter() - t0, digest=_tree_digest(result))
        del result
    return out


def staging_child(workdir: str) -> int:
    """The host-staging side of ``finetune_phase``, in its own process
    started with ``FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES=1``: the parent's
    parameters and gradients (``workdir/trees.pt``) through the staged
    collectives at world 1; the digests, times, flight-recorder paths and
    ``comm.calls`` rows go to ``workdir/child.json``."""
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import config, telemetry

    reg = telemetry.MetricsRegistry()
    telemetry.set_registry(reg)
    dev = fm.init()
    trees = torch.load(Path(workdir) / "trees.pt")
    params = {k: v.to(dev) for k, v in trees["params"].items()}
    grads = {k: v.to(dev) for k, v in trees["grads"].items()}
    del trees
    results = run_staging_ops(params, grads)
    flight = telemetry.get_flight_recorder().dump()["entries"]
    calls = {f"{m['labels']['op']}/{m['labels']['path']}": m["value"]
             for m in reg.snapshot() if m["name"] == "comm.calls"}
    (Path(workdir) / "child.json").write_text(json.dumps(dict(
        staging=bool(config.DEVICE_COLLECTIVES_DISABLED), device=str(dev),
        results=results, flight=[(e["op"], e["path"]) for e in flight],
        comm_calls=calls)))
    fm.shutdown()
    return 0


def finetune_phase(device, flash_updates: int = 8, kernel_updates: int = 32,
                   flush_every: int = 8, host_updates: int = 20, crash_hit: int = 13,
                   save_every: int = 5):
    """Fine-tuning stock GPT-2 small on the card, four runs: (1) the flash
    LM at dropout 0.1, pipelined, bit for bit against dropout 0.0 (flax's
    keyword filter hands the kernels no rate); (2) an ``attention_fn`` that
    drops inside the kernels with a seed drawn on the card, in CUDA-graph
    windows (``fuse="auto"``) beside ``fuse=False``; (3) a transformed
    host dataset through the C++ prefetcher, killed by
    ``FLUXMPI_TPU_FAULTS`` at a batch fetch and resumed; (4) the
    host-staging collectives in a child process against NCCL."""
    import os
    import subprocess
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import data as fm_data
    from fluxmpi_tpu_torch import faults, optim, runtime
    from fluxmpi_tpu_torch.io import NativePrefetcher, native_available
    from fluxmpi_tpu_torch.models import TransformerLM, load_flax_params, lm_from_gpt2
    from fluxmpi_tpu_torch.ops import flash_attention, flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.utils import CheckpointManager

    failures = []
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    t_phase = time.perf_counter()
    cfg = GPT2_HF_CONFIG
    sd = gpt2_state_dict(cfg)
    cpu_model, variables = lm_from_gpt2(
        SimpleNamespace(config=SimpleNamespace(**cfg), state_dict=lambda: sd), device="cpu")
    rate = cpu_model.dropout
    fields = dict(vocab_size=cfg["vocab_size"], max_len=cpu_model.max_len,
                  num_layers=cpu_model.num_layers, d_model=cpu_model.d_model,
                  num_heads=cpu_model.num_heads, d_ff=cpu_model.d_ff,
                  ln_eps=cpu_model.ln_eps)
    layers, seq = cpu_model.num_layers, cpu_model.max_len
    del cpu_model, sd
    dev = fm.init()
    corpus = lm_corpus(cfg["vocab_size"], seq=seq)
    stats = dict(dropout=rate)
    print(f"finetune: lm_from_gpt2 of GPT2Config (dropout {rate}), bf16 compute with "
          f"f32 masters, batch {FINETUNE_BATCH} x {seq}, adamw(3e-4), world "
          f"{fm.total_workers()} over {torch.distributed.get_backend()}; set-up "
          f"{time.perf_counter() - t_phase:.2f}s", flush=True)

    # The attention_fn of run 2: flax passes it the dropout keywords its
    # signature names; it draws a uint32 seed on the card from dropout_rng
    # (no host read) and drops inside the kernels. The last seed drawn is
    # copied to `seen`, which the flush hook reads outside the graph.
    seen = torch.zeros((), dtype=torch.int64, device=dev)

    def kernel_dropout(query, key, value, mask=None, dropout_rng=None,
                       dropout_rate=0.0, deterministic=True):
        if deterministic or not dropout_rate:
            return flash_attention(query, key, value, causal=True)
        runtime.note_graph_generator(dropout_rng)
        seed = torch.randint(0, 2 ** 32, (), generator=dropout_rng, dtype=torch.int64,
                             device=query.device)
        seen.copy_(seed)
        return flash_attention(query, key, value, causal=True, dropout_rate=dropout_rate,
                               dropout_seed=seed)

    def build(dropout, attention_fn=None):
        model = load_flax_params(TransformerLM(
            **fields, dropout=dropout, attention="naive" if attention_fn else "flash",
            attention_fn=attention_fn, dtype=torch.bfloat16, device=dev), variables)
        fm.synchronize(model)
        gen = torch.Generator(device=dev).manual_seed(7)

        def loss_fn(params, model_state, batch):
            x, y = batch
            return model(x, targets=y, dropout_rng=gen).mean(), model_state

        opt = optim.adamw(3e-4)
        return (model, gen, loss_fn, make_train_step(loss_fn, opt),
                TrainState.create(model, opt))

    def corpus_loader():
        return fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=FINETUNE_BATCH, shuffle=True)

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return {k: v.detach().clone() for k, v in out.items()}

    def flushes(summary):
        return [(f["updates"], f["loss"], f["loss_mean"], f["loss_max"])
                for f in summary["flushes"]]

    def same_bits(a, b):
        return sum(torch.equal(a[k], b[k]) for k in a), len(a)

    # 1. The flash LM at dropout 0.1 against dropout 0.0, pipelined.
    runs = {}
    for label, dropout in (("dropout", rate), ("no_dropout", 0.0)):
        model, gen, loss_fn, step, state = build(dropout)
        loader = corpus_loader()
        for kern in kernels:
            kern.launches = 0
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=flash_updates,
                               flush_every=flash_updates // 2, fuse=False))
        runs[label] = dict(bits=leaves(state), flushes=flushes(summ), launches=launches)
        del model, gen, loss_fn, step, state, loader
        torch.cuda.empty_cache()
    n_same, n_all = same_bits(runs["dropout"]["bits"], runs["no_dropout"]["bits"])
    need = layers * flash_updates
    flash_ok = (n_same == n_all and runs["dropout"]["flushes"] == runs["no_dropout"]["flushes"]
                and runs["dropout"]["launches"] == {k.__name__: need for k in kernels})
    stats["flash_dropout"] = dict(updates=flash_updates, bit_identical=n_same, leaves=n_all,
                                  flushes=runs["dropout"]["flushes"],
                                  launches=runs["dropout"]["launches"])
    print(f"finetune [flash, dropout {rate} vs 0.0]: {flash_updates} pipelined updates; "
          f"{n_same} of {n_all} parameters, adamw moments and the count bit-identical; "
          f"flush losses {[f[1] for f in runs['dropout']['flushes']]} vs "
          f"{[f[1] for f in runs['no_dropout']['flushes']]}; launches "
          f"{runs['dropout']['launches']} (need {need} each) "
          f"{'ok' if flash_ok else 'FAIL'}", flush=True)
    if not flash_ok:
        failures.append("finetune: the flash LM at dropout 0.1 differs from dropout 0.0")
    del runs

    # 2. Kernel dropout: fuse="auto" (CUDA-graph windows) beside fuse=False.
    def kernel_run(fuse):
        model, gen, loss_fn, step, state = build(rate, kernel_dropout)
        loader = corpus_loader()
        seeds = []
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=kernel_updates,
                               flush_every=flush_every, fuse=fuse,
                               metrics=lambda record: seeds.append(int(seen.item()))))
        wall = time.perf_counter() - t0
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        run = dict(fuse=fuse, bits=leaves(state), flushes=flushes(summ),
                   updates=summ["updates"], dispatches=summ["dispatches"],
                   fused_window=summ["fused_window"], seeds=seeds, launches=launches,
                   accounted={n: counted[n] + extra[n] for n in counted},
                   graphs=graph_stats(step), wall_seconds=wall)
        # A second run of as many updates (every window replays) for the time.
        state, timed = train_loop(step, state, loader, steps=kernel_updates,
                                  flush_every=flush_every, fuse=fuse)
        torch.cuda.synchronize()
        run["median_update_ms"] = float(np.median(
            [ms / flush_every for ms in timed["step_ms"]] if fuse else timed["step_ms"]))
        return run, (model, gen, loss_fn, loader)

    pipe, _ = kernel_run(False)
    torch.cuda.empty_cache()
    fused, (model, gen, loss_fn, loader) = kernel_run("auto")
    n_same, n_all = same_bits(fused["bits"], pipe["bits"])
    need = layers * kernel_updates
    replays = sum(g["replays"] for g in fused["graphs"])
    windows = kernel_updates // flush_every
    first_loss, last_loss = fused["flushes"][0][2], fused["flushes"][-1][2]
    # One update's gradients through the kernels against the plain versions,
    # both at the seeds the generator draws from the same state.
    x, y = next(iter(loader))
    params = list(model.parameters())

    def grads():
        gen.manual_seed(11)
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
    grad_ok = all(np.isfinite(r) and r <= BF16_TRAIN_GRAD_TOL for r in rel.values())
    del model, gen, loss_fn, loader, g_kernel, g_plain, params
    torch.cuda.empty_cache()
    replay_seeds = fused["seeds"][1:]
    checks = {
        "every window after the first replays": (
            fused["fused_window"] == flush_every and fused["dispatches"] == windows
            and replays == windows - 1),
        "fused bit-identical to fuse=False": (n_same == n_all
                                              and fused["flushes"] == pipe["flushes"]),
        "launches per update": all(
            r["launches"] == {k.__name__: need for k in kernels}
            and r["accounted"] == r["launches"] for r in (pipe, fused)),
        "replays drew fresh seeds": len(set(replay_seeds)) >= 2,
        "loss falls": bool(np.isfinite(first_loss) and last_loss < first_loss),
        "gradients vs plain": grad_ok,
    }
    stats["kernel_dropout"] = dict(
        updates=kernel_updates, flush_every=flush_every, bit_identical=n_same, leaves=n_all,
        replays=replays, seeds_fused=fused["seeds"], seeds_pipelined=pipe["seeds"],
        launches=fused["launches"], launches_pipelined=pipe["launches"],
        accounted=fused["accounted"], graphs=fused["graphs"],
        median_update_ms_fused=fused["median_update_ms"],
        median_update_ms_pipelined=pipe["median_update_ms"],
        first_flush_loss_mean=first_loss, last_flush_loss_mean=last_loss,
        grad_rel_err_max=rel[worst], grad_rel_err_worst=worst, checks=checks)
    print(f"finetune [kernel dropout {rate}, attention_fn]: {kernel_updates} updates, "
          f"flush_every {flush_every}: fused {fused['dispatches']} windows, {replays} graph "
          f"replays; {n_same} of {n_all} leaves bit-identical to fuse=False; seeds after "
          f"each window {fused['seeds']} (pipelined {pipe['seeds']}); device launches "
          f"{fused['launches']} (need {need} each; the wrappers' with the graphs' "
          f"{fused['accounted']}); pipelined {pipe['launches']}; mean loss first flush "
          f"{first_loss:.4f} -> last {last_loss:.4f}; median ms per update fused "
          f"{fused['median_update_ms']:.2f} vs pipelined {pipe['median_update_ms']:.2f}; "
          f"gradients vs the plain versions worst {rel[worst]:.3e} ({worst}; tol "
          f"{BF16_TRAIN_GRAD_TOL:g}); " + ", ".join(
              f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()), flush=True)
    failures += [f"finetune kernel dropout: {k}" for k, v in checks.items() if not v]
    del pipe, fused

    # 3. A transformed dataset on the host path through the C++ prefetcher.
    rows = lm_corpus(cfg["vocab_size"], n=FINETUNE_ROWS, seq=FINETUNE_ROW_TOKENS - 1,
                     seed=3)
    calls = [0]

    def crop(batch, rng):
        """Crop each row at a random offset to seq + 1 tokens; inputs from
        the first leaf, targets (shifted by one) from the second."""
        calls[0] += 1
        a, b = batch
        off = rng.integers(0, a.shape[1] - seq, size=a.shape[0])
        idx = off[:, None] + np.arange(seq)[None]
        return np.take_along_axis(a, idx, 1), np.take_along_axis(b, idx + 1, 1)

    def host_loader():
        return fm.DistributedDataLoader(fm.ArrayDataset((rows, rows)),
                                        global_batch_size=FINETUNE_BATCH, shuffle=True,
                                        transform=crop)

    native = native_available()
    model, gen, loss_fn, step, state = build(rate)
    loader = host_loader()
    served0, calls[0] = NativePrefetcher.served, 0
    for kern in kernels:
        kern.launches = 0
    (state, ref), launches = kernel_launches(
        lambda: train_loop(step, state, loader, steps=host_updates, flush_every=save_every))
    served = NativePrefetcher.served - served0
    want = leaves(state)
    host_calls = calls[0]
    (_, tsum), busy_ms, wall_ms, nk, _ = traced(
        lambda: train_loop(step, state, loader, steps=save_every, flush_every=save_every))
    idle = (1 - busy_ms / wall_ms) if nk else None
    del model, gen, loss_fn, step, state, loader
    torch.cuda.empty_cache()

    class NumpyPrefetcher:
        """The numpy path in the prefetcher's place: ``array[rows]``."""

        def __init__(self, array, order, batch_rows):
            self.array, self.order, self.n = array, order, batch_rows

        def __iter__(self):
            for i in range(len(self.order) // self.n):
                yield self.array[self.order[i * self.n:(i + 1) * self.n]]

    def host_ms(prefetcher):
        fm_data.NativePrefetcher = prefetcher
        try:
            loader = host_loader()
            t0 = time.perf_counter()
            n = 0
            for _ in loader:
                n += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n
        finally:
            fm_data.NativePrefetcher = NativePrefetcher

    per_batch = {"native": [], "numpy": []}
    for kind in ("native", "numpy", "numpy", "native"):
        per_batch[kind].append(host_ms(NativePrefetcher if kind == "native"
                                       else NumpyPrefetcher))
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "run")
        fm.shutdown()
        os.environ["FLUXMPI_TPU_FAULTS"] = f"data.fetch@step={crash_hit}"
        try:
            fm.init()
            armed = [str(s) for s in faults.active()]
            model, gen, loss_fn, step, state = build(rate)
            loader = host_loader()
            mgr = CheckpointManager(ckdir, async_save=False)
            crashed = False
            try:
                train_loop(step, state, loader, steps=host_updates, flush_every=save_every,
                           checkpoint=mgr, save_every=save_every)
            except fm.FaultInjectedError:
                crashed = True
            banked = mgr.latest_step()
            mgr.close()
        finally:
            del os.environ["FLUXMPI_TPU_FAULTS"]
        del model, gen, loss_fn, step, state, loader
        torch.cuda.empty_cache()
        fm.shutdown()
        cleared = not faults.active()
        fm.init()
        model, gen, loss_fn, step, state = build(rate)
        loader = host_loader()
        mgr = CheckpointManager(ckdir, async_save=False)
        state, res = train_loop(step, state, loader, steps=host_updates,
                                flush_every=save_every, checkpoint=mgr, save_every=save_every,
                                resume=True)
        torch.cuda.synchronize()
        mgr.close()
        back = leaves(state)
        del model, gen, loss_fn, step, state, loader
    torch.cuda.empty_cache()
    n_same, n_all = same_bits(back, want)
    need = layers * host_updates
    checks = {
        "native prefetcher built": native,
        "the prefetcher served every host batch": served == 2 * host_calls > 0,
        "host path (not fused)": ref["fused_window"] is None,
        "launches": launches == {k.__name__: need for k in kernels},
        "C.9: init armed FLUXMPI_TPU_FAULTS, shutdown cleared it": bool(armed) and cleared,
        "killed and resumed": crashed and bool(banked) and res["resumed_from"] == banked,
        "resume bit-identical": n_same == n_all
                                and flushes(res) == flushes(ref)[-len(res["flushes"]):],
    }
    stats["host_transform"] = dict(
        updates=host_updates, served=served, transform_calls=host_calls,
        launches=launches, armed=armed, banked=banked, resumed_from=res["resumed_from"],
        bit_identical=n_same, leaves=n_all, host_ms_per_batch=per_batch,
        traced_updates=tsum["updates"], idle_share=idle, device_busy_ms=busy_ms,
        wall_ms=wall_ms, checks=checks)
    print(f"finetune [host path, transform, C++ prefetcher]: {host_updates} pipelined "
          f"updates over {FINETUNE_ROWS} rows of {FINETUNE_ROW_TOKENS} tokens cropped to "
          f"{seq + 1}; native_available {native}; the prefetcher served {served} leaf "
          f"batches for {host_calls} transformed batches; launches {launches} (need "
          f"{need} each); armed {armed} by init from FLUXMPI_TPU_FAULTS, killed at "
          f"fetch {crash_hit} ({'raised' if crashed else 'DID NOT RAISE'}) with step "
          f"{banked} committed, resumed from {res['resumed_from']}: {n_same} of {n_all} "
          f"leaves bit-identical to the uninterrupted run; host ms per batch (an "
          f"epoch through the loader, transform and copy included) native "
          f"{per_batch['native']} vs numpy {per_batch['numpy']}; traced "
          f"{tsum['updates']} updates: busy {busy_ms:.3f} of {wall_ms:.3f} ms (idle share "
          f"{idle if idle is None else round(idle, 4)}); " + ", ".join(
              f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()), flush=True)
    failures += [f"finetune host path: {k}" for k, v in checks.items() if not v]

    # 4. Host staging in a child process against NCCL here.
    model, gen, loss_fn, step, state = build(rate)
    x, y = next(iter(corpus_loader()))
    params = dict(model.named_parameters())
    g = torch.autograd.grad(loss_fn(None, None, (x, y))[0], list(params.values()))
    grads = {name: t.detach().float() for name, t in zip(params, g)}
    params = {k: v.detach() for k, v in params.items()}
    values = sum(t.numel() for t in grads.values())
    del g, step, state, loss_fn, gen
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"params": {k: v.cpu() for k, v in params.items()},
                    "grads": {k: v.cpu() for k, v in grads.items()}},
                   Path(tmp) / "trees.pt")
        nccl = run_staging_ops(params, grads)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--staging-child", tmp],
            env=dict(os.environ, FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES="1"),
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        report = (json.loads((Path(tmp) / "child.json").read_text())
                  if child.returncode == 0 else None)
    del model, params, grads
    torch.cuda.empty_cache()
    if report is None:
        failures.append(f"finetune staging: the child exited {child.returncode}")
        print(f"finetune [host staging]: child FAILED ({child.returncode}):\n"
              f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}", flush=True)
    else:
        staged = report["results"]
        paths = {op: sorted({p for o, p in report["flight"] if o == op})
                 for op in ("allreduce", "bcast", "reduce")}
        checks = {
            "the child staged": report["staging"],
            "bit-identical to NCCL": all(staged[op]["digest"] == nccl[op]["digest"]
                                         for op in nccl),
            "flight recorder path host": all(p == ["host"] for p in paths.values()),
            "comm.calls path host": report["comm_calls"] == {
                "allreduce/host": 2, "bcast/host": 1, "reduce/host": 1},
        }
        stats["host_staging"] = dict(values=values, nccl=nccl, staged=staged,
                                     flight_paths=paths, comm_calls=report["comm_calls"],
                                     child_seconds=child_s, checks=checks)
        print(f"finetune [host staging]: {values} gradient values "
              f"({values * 4 / 1e6:.1f} MB f32); seconds per op, NCCL vs staged "
              f"(FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES=1 child, {child_s:.1f}s in all): "
              + ", ".join(f"{op} {nccl[op]['seconds']:.4f} vs {staged[op]['seconds']:.4f}"
                          for op in nccl)
              + f"; flight paths {paths}; comm.calls {report['comm_calls']}; "
              + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items())
              + f"; {card_line()}", flush=True)
        failures += [f"finetune staging: {k}" for k, v in checks.items() if not v]
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"finetune: phase {stats['seconds']:.1f}s", flush=True)
    fm.shutdown()
    return stats, failures


# Health phase: the run-health and live-export planes on the fused bf16 LM
# and on the serving plane.
HEALTH_POISON_LAYER = "encoder.block_5.ff1.kernel"


def _http_get(port: int, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def health_phase(device, updates: int = 32, flush_every: int = 8,
                 retrace_width: int = 4):
    """The run-health and live-export planes at GPT-2-small width on one
    card, on ``fused_phase``'s model and corpus (bf16 compute, f32 masters,
    batch 8 x 1024, ``steps=32, flush_every=8``: four CUDA-graph windows):

    1. Planes on against off: the run with every plane off, then under
       ``init(anomaly=, model_stats=3, compileplane=, export=<127.0.0.1
       port 0>, goodput=True, profile=)`` and ``init(fleet=<a
       FleetCollector scraping that exporter every second, banking its
       snapshots>)``. Gates: every parameter and adamw moment bit-identical;
       12 launches of each kernel per update by the kernels' device counters,
       equal to the wrappers' accounting. Prints ms per update (median over
       the windows of a second run) and host launch calls per update, on
       and off, and ``goodput.mfu_productive`` against the steady state's
       MFU (FLOPs per update over the median update time at 989.4 TFLOP/s).
    2. A live scrape: a thread reads ``/metrics``, ``/status`` and
       ``/healthz`` while the planes-on run trains. Gates: every series
       demangles into ``schema.KNOWN_METRIC_NAMES``; ``/status`` validates;
       ``/healthz`` answers 200; ``scripts/fluxmpi_top.py --once`` renders
       the exporter and ``scripts/fleet_report.py`` the snapshot bank.
    3. A retrace: with the compile monitor spanning the loop's runs (its
       warmup does not reopen per run), a later run at another width
       (``flush_every=4``) captures a new window program: ``steady_state_
       retrace`` fires naming ``train_loop.window``, the run's
       ``window_compile_seconds`` equals that program's capture seconds,
       and the auto-profiler, triggered by the rule, leaves one Chrome
       trace.
    4. NaN provenance: a second short run (``flush_every=1``) whose
       ``encoder.block_5.ff1.kernel`` gradient is multiplied by a device
       flag the flush hook turns to NaN after window 1: ``nan_grad`` halts
       the loop at the next flush with ``summary["anomaly"] ==
       "nan_grad"``, the event names ``params/encoder/block_5``, and the
       diagnostics bundle is written and valid.
    5. Serving: GPT-2 small in f32 (seeded weights) through
       ``InferenceEngine(attention="flash")`` with ``init(request_log=
       True)`` under a TTFT objective no request can meet: ``slo_burn``
       fires, ``flash_fwd`` launched, and ``/status``'s serving board reads
       through ``scripts/fluxmpi_top.py``."""
    import os
    import tempfile
    import threading
    import warnings

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim, telemetry
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.serving import InferenceEngine
    from fluxmpi_tpu_torch.telemetry import schema
    from fluxmpi_tpu_torch.telemetry.compileplane import CompileMonitor
    from fluxmpi_tpu_torch.telemetry.export import exposed_base_name
    from fluxmpi_tpu_torch.utils.profiling import AutoProfiler, get_auto_profiler

    failures = []
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    corpus = lm_corpus(GPT2_SMALL["vocab_size"], seq=GPT2_SMALL["max_len"])
    need = GPT2_SMALL["num_layers"] * updates
    dev = fm.init()

    class SpanningMonitor(CompileMonitor):
        """A compile monitor over a process that runs the loop several
        times: a new run's first windows are not a new warmup."""

        def reset_run(self):
            self.retraces = []

    def build(flag=None, model_stats=None):
        model = TransformerLM(**GPT2_SMALL, attention="flash", dropout=0.0,
                              dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(0))
        fm.synchronize(model)
        if flag is not None:
            model.get_parameter(HEALTH_POISON_LAYER).register_hook(lambda g: g * flag)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=8, shuffle=True)

        def loss_fn(params, model_state, batch):
            x, y = batch
            return model(x, targets=y).mean(), model_state

        opt = optim.adamw(3e-4)
        return model, loader, make_train_step(loss_fn, opt, model_stats=model_stats), \
            TrainState.create(model, opt)

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return out

    def drive(during=None, model_stats=None):
        """The main path (counts zeroed just before, read just after), a
        second run of as many updates for the times, and the host's launch
        calls over one more window."""
        model, loader, step, state = build(model_stats=model_stats)
        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=updates,
                               flush_every=flush_every))
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        bits = {k: v.detach().clone() for k, v in leaves(state).items()}
        if during is not None:
            during()
        state, timed = train_loop(step, state, loader, steps=updates,
                                  flush_every=flush_every)
        (_, hsum), calls, _ = host_launches(
            lambda: train_loop(step, state, loader, steps=flush_every,
                               flush_every=flush_every))
        # The main run's wall less its later windows (CUDA events from one
        # window's completion to the next's; the second's holds its
        # capture): the eager first window with its one-time warm-up.
        first_s = summ["seconds"] - sum(summ["step_ms"]) / 1e3
        run = dict(updates=summ["updates"], dispatches=summ["dispatches"],
                   fused_window=summ["fused_window"], anomaly=summ["anomaly"],
                   window_compile_seconds=summ.get("window_compile_seconds"),
                   seconds=summ["seconds"], first_window_seconds=first_s,
                   median_update_ms=float(np.median(
                       [ms / flush_every for ms in timed["step_ms"]])),
                   launches=launches,
                   accounted_launches={n: counted[n] + extra[n] for n in counted},
                   host_launches_per_update=calls / hsum["updates"],
                   goodput=summ.get("goodput"), graphs=graph_stats(step))
        return run, bits, (model, loader, step, state)

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        off, want, held = drive()
        del held
        torch.cuda.empty_cache()

        # Planes on. The exporter's port is known once it is bound: the
        # fleet collector that scrapes it comes in a second init call.
        exporter = telemetry.Exporter(0, "127.0.0.1", deadline=600.0)
        monitor = SpanningMonitor()
        # The step-time and data-stall rules judge host timings that the
        # traced and profiled runs of this phase distort; they are off here
        # so that the one auto-profiler capture is the retrace's.
        detector = telemetry.AnomalyDetector(
            dump_dir=os.path.join(tmp, "anomaly"),
            policies={"step_time_regression": "off", "data_stall": "off"})
        profile_dir = os.path.join(tmp, "profile")
        bank = os.path.join(tmp, "fleet.jsonl")
        prev_reg = telemetry.set_registry(telemetry.MetricsRegistry())
        scraped = {"metrics": [], "status": [], "healthz": []}
        stop = threading.Event()

        def scrape():
            while not stop.wait(0.25):
                for ep in scraped:
                    try:
                        scraped[ep].append(_http_get(exporter.port, f"/{ep}"))
                    except Exception as exc:  # noqa: BLE001 - recorded, gated below
                        scraped[ep].append((None, repr(exc).encode()))

        scraper = threading.Thread(target=scrape, daemon=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fm.init(anomaly=detector, model_stats=3, compileplane=monitor,
                        export=exporter, goodput=True,
                        profile=AutoProfiler(profile_dir, seconds=1.0))
            collector = telemetry.FleetCollector([f"127.0.0.1:{exporter.port}"],
                                                 interval=1.0, log=bank)
            fm.init(fleet=collector)
            scraper.start()
            on, got, held = drive(during=stop.set)
            scraper.join(10)
            model, loader, step, state = held
            same = [k for k in want if torch.equal(got[k], want[k])]
            # The same planes with the step built without the model stats:
            # what the stats' reductions inside each graph cost. Its own
            # compile monitor: its programs' captures are its warmup.
            fm.init(compileplane=SpanningMonitor())
            nostats, got_ns, held_ns = drive(model_stats=False)
            del held_ns
            torch.cuda.empty_cache()
            same_ns = [k for k in want if torch.equal(got_ns[k], want[k])]
            rep = on["goodput"] or {}
            fpu = rep.get("flops_per_update") or 0.0
            steady_mfu = fpu / (on["median_update_ms"] / 1e3 * H100_PEAK_BF16)
            stats.update(planes_off=off, planes_on=on, planes_on_no_model_stats=nostats,
                         leaves=len(want), bit_identical=len(same),
                         bit_identical_no_model_stats=len(same_ns), flops_per_update=fpu,
                         mfu=rep.get("mfu"), mfu_productive=rep.get("mfu_productive"),
                         mfu_steady=steady_mfu, goodput_buckets=rep.get("buckets"))
            print(f"health_phase: planes off {off['median_update_ms']:.3f} ms per update, "
                  f"on {on['median_update_ms']:.3f} ms, on without the model stats "
                  f"{nostats['median_update_ms']:.3f} ms (median over the windows of a "
                  f"second run of {updates}); host launch calls per update off "
                  f"{off['host_launches_per_update']:.3f}, on "
                  f"{on['host_launches_per_update']:.3f}, on without the model stats "
                  f"{nostats['host_launches_per_update']:.3f}; {len(same)} of "
                  f"{len(want)} leaves bit-identical ({len(same_ns)} without the model "
                  f"stats); launches off {off['launches']} (wrappers "
                  f"{off['accounted_launches']}), on {on['launches']} (wrappers "
                  f"{on['accounted_launches']}), need {need} each; goodput.mfu "
                  f"{rep.get('mfu')}, mfu_productive {rep.get('mfu_productive')} against "
                  f"the steady state's {steady_mfu:.4f} (FLOPs per update {fpu:.4g} over "
                  f"{on['median_update_ms']:.3f} ms at {H100_PEAK_BF16:.4g}); buckets "
                  f"{rep.get('buckets')}; the main runs' eager first window with its "
                  f"warm-up {off['first_window_seconds']:.3f}s off, "
                  f"{on['first_window_seconds']:.3f}s on (of {off['seconds']:.3f}s, "
                  f"{on['seconds']:.3f}s); {card_line()}", flush=True)
            if len(same) != len(want) or len(same_ns) != len(want):
                failures.append(f"health_phase: {len(want) - len(same)} leaves differ "
                                f"with the planes on ({len(want) - len(same_ns)} "
                                f"without the model stats)")
            for run, name in ((off, "off"), (on, "on")):
                if run["launches"] != {k.__name__: need for k in kernels} or \
                        run["accounted_launches"] != run["launches"]:
                    failures.append(f"health_phase [{name}]: launches {run['launches']} "
                                    f"(wrappers {run['accounted_launches']}), not {need}")
            if on["anomaly"] is not None or not on["goodput"]:
                failures.append(f"health_phase: planes-on run anomaly {on['anomaly']}, "
                                f"goodput {bool(on['goodput'])}")

            # The live scrape.
            ok_metrics = [b for c, b in scraped["metrics"] if c == 200]
            ok_status = [b for c, b in scraped["status"] if c == 200]
            health_codes = sorted({c for c, _ in scraped["healthz"]}, key=str)
            names, bad_names, bad_status = set(), set(), []
            for body in ok_metrics:
                for line in body.decode().splitlines():
                    if line and not line.startswith("#"):
                        name = exposed_base_name(line.split("{")[0].split(" ")[0])
                        (names if name in schema.KNOWN_METRIC_NAMES else bad_names).add(name)
            for body in ok_status:
                bad_status += schema.validate_status_record(json.loads(body))
            collector.collect_once()
            top = subprocess.run([sys.executable, str(root / "scripts" / "fluxmpi_top.py"),
                                  f"http://127.0.0.1:{exporter.port}", "--once"],
                                 capture_output=True, text=True, timeout=120)
            report = subprocess.run([sys.executable,
                                     str(root / "scripts" / "fleet_report.py"), bank,
                                     "--json"], capture_output=True, text=True, timeout=120)
            fleet_rep = json.loads(report.stdout) if report.returncode == 0 else None
            last = json.loads(ok_status[-1]) if ok_status else {}
            stats["scrape"] = dict(
                metrics=len(ok_metrics), status=len(ok_status), healthz=health_codes,
                series_names=len(names), unknown=sorted(bad_names),
                status_errors=bad_status[:5], top_rc=top.returncode,
                fleet_report_rc=report.returncode, fleet_report=fleet_rep,
                model_board=last.get("model"), train_board=last.get("train"))
            print(f"health_phase scrape: {len(ok_metrics)} /metrics, {len(ok_status)} "
                  f"/status, /healthz codes {health_codes} during the run; "
                  f"{len(names)} metric names, unknown {sorted(bad_names)}; status "
                  f"errors {bad_status[:3]}; model board {last.get('model')}; "
                  f"fluxmpi_top rc {top.returncode}, fleet_report rc {report.returncode} "
                  f"({fleet_rep})", flush=True)
            if not ok_metrics or not ok_status or bad_names or bad_status \
                    or health_codes != [200]:
                failures.append(f"health_phase: live scrape ({len(ok_metrics)} metrics, "
                                f"{len(ok_status)} status, healthz {health_codes}, "
                                f"unknown {sorted(bad_names)}, {bad_status[:3]})")
            if top.returncode != 0 or "MODEL" not in top.stdout:
                failures.append(f"health_phase: fluxmpi_top: {top.stderr[-800:]}")
            if report.returncode != 0 or not fleet_rep or not fleet_rep.get("snapshots"):
                failures.append(f"health_phase: fleet_report: {report.stderr[-800:]}")

            # A retrace: a later run at another width captures a new program.
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                state, rsum = train_loop(step, state, loader, steps=2 * retrace_width,
                                         flush_every=retrace_width)
            get_auto_profiler().wait(60)
            progs = [g for g in graph_stats(step) if g["width"] == retrace_width]
            monitor = telemetry.get_compile_monitor()
            retraces = [e for e in detector.triggered
                        if e["rule"] == "steady_state_retrace"]
            traces = sorted(os.listdir(profile_dir)) if os.path.isdir(profile_dir) else []
            captured = progs[0]["capture_seconds"] if progs else None
            stats["retrace"] = dict(events=retraces, window_compile_seconds=rsum.get(
                "window_compile_seconds"), capture_seconds=captured, traces=traces,
                retraces_logged=monitor.retraces)
            print(f"health_phase retrace: a {retrace_width}-update window after the "
                  f"warmup: events {retraces}; window_compile_seconds "
                  f"{rsum.get('window_compile_seconds')} vs capture seconds {captured}; "
                  f"auto-profiler traces {traces}", flush=True)
            if not retraces or retraces[-1].get("function") != "train_loop.window":
                failures.append("health_phase: no steady_state_retrace naming "
                                "train_loop.window")
            if captured is None or rsum.get("window_compile_seconds") != captured:
                failures.append("health_phase: window_compile_seconds differs from the "
                                "capture seconds")
            if len(traces) != 1:
                failures.append(f"health_phase: {len(traces)} auto-profiler traces, not 1")
            del model, loader, step, state, held
            torch.cuda.empty_cache()

            # NaN provenance: one layer's gradient turns NaN after window 1. A
            # fresh compile monitor: this run's capture is its warmup, not a
            # retrace whose bundle would replace the NaN's.
            fm.init(compileplane=CompileMonitor())
            flag = torch.ones((), device=dev)
            model, loader, step, state = build(flag)

            def poison(record):
                flag.fill_(float("nan"))

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, nsum = train_loop(step, state, loader, steps=4, flush_every=1,
                                     metrics=poison)
            nan_events = [e for e in detector.triggered if e["rule"] == "nan_grad"]
            bundle_path = os.path.join(tmp, "anomaly", "fluxmpi_anomaly.0.json")
            bundle = None
            if os.path.exists(bundle_path):
                with open(bundle_path) as f:
                    bundle = json.load(f)
            bundle_errors = (schema.validate_watchdog_dump(bundle) if bundle is not None
                             else ["missing"])
            layer = nan_events[-1].get("layer") if nan_events else None
            # The poisoned parameter's group at depth 3: params/encoder/block_k.
            named = "/".join(["params"] + HEALTH_POISON_LAYER.split(".")[:2])
            stats["nan"] = dict(anomaly=nsum["anomaly"], updates=nsum["updates"],
                                dispatches=nsum["dispatches"], layer=layer,
                                bundle_anomaly=(bundle or {}).get("anomaly"),
                                bundle_errors=bundle_errors[:3])
            print(f"health_phase NaN provenance: {HEALTH_POISON_LAYER}'s gradient x NaN "
                  f"from window 2: summary anomaly {nsum['anomaly']!r} after "
                  f"{nsum['updates']} updates in {nsum['dispatches']} windows; event "
                  f"layer {layer!r}; bundle {(bundle or {}).get('anomaly')} errors "
                  f"{bundle_errors[:3]}", flush=True)
            if nsum["anomaly"] != "nan_grad" or layer != named:
                failures.append(f"health_phase: NaN run anomaly {nsum['anomaly']!r}, "
                                f"layer {layer!r}")
            if bundle_errors or (bundle or {}).get("anomaly", {}).get("layer") != named:
                failures.append(f"health_phase: anomaly bundle {bundle_errors[:3]}")
            del model, loader, step, state
            torch.cuda.empty_cache()

            # Serving under an SLO it cannot meet.
            fm.init(request_log=True)
            lm = TransformerLM(**GPT2_SMALL, attention="flash", device=dev,
                               generator=torch.Generator().manual_seed(0))
            eng = InferenceEngine(lm, slots=8, block_size=16, slo_ttft_s=1e-9,
                                  attention="flash")
            rng = np.random.default_rng(0)
            before = len(detector.triggered)
            flash_fwd.launches = 0
            for _ in range(8):
                eng.submit(rng.integers(0, GPT2_SMALL["vocab_size"], 48).tolist(), 8)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ssum = eng.run()
            serve_launches = flash_fwd.launches
            burn = [e for e in detector.triggered[before:] if e["rule"] == "slo_burn"]
            code, body = _http_get(exporter.port, "/status")
            board = json.loads(body).get("serving") if code == 200 else None
            stop_top = subprocess.run(
                [sys.executable, str(root / "scripts" / "fluxmpi_top.py"),
                 f"http://127.0.0.1:{exporter.port}", "--once"],
                capture_output=True, text=True, timeout=120)
            eng.close()
            stats["serving"] = dict(summary=ssum, slo_burn_events=len(burn),
                                    flash_fwd_launches=serve_launches, board=board,
                                    top_rc=stop_top.returncode)
            print(f"health_phase serving: {ssum['completed']} requests, "
                  f"{ssum['slo_violations']} SLO violations, slo_burn events {len(burn)} "
                  f"({burn[:1]}); flash_fwd launches {serve_launches}; serving board "
                  f"phase {(board or {}).get('phase')}, burn {(board or {}).get('burn_rate')}; "
                  f"fluxmpi_top rc {stop_top.returncode}", flush=True)
            if not burn or serve_launches <= 0:
                failures.append(f"health_phase: serving slo_burn events {len(burn)}, "
                                f"flash_fwd launches {serve_launches}")
            if (board or {}).get("phase") != "finished" or stop_top.returncode != 0 \
                    or "SERVING" not in stop_top.stdout:
                failures.append(f"health_phase: serving board {board}, fluxmpi_top "
                                f"{stop_top.stderr[-400:]}")
            del eng, lm
        finally:
            stop.set()
            fm.shutdown()
            telemetry.set_registry(prev_reg)
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"health_phase: phase {stats['seconds']:.1f}s", flush=True)
    return stats, failures


# Parallel phase: the plan of one device and the MoE LM at Switch-Base-8
# widths (Fedus et al. 2021, google/switch-base-8: d_model 768, d_ff 3072,
# 12 heads, 12 layers per stack, 8 experts), one decoder-only stack over
# GPT-2's vocabulary, every block MoE as the reference's class builds it.
SWITCH_BASE_8 = dict(vocab_size=50257, max_len=1024, num_layers=12, d_model=768,
                     num_heads=12, d_ff=3072, num_experts=8, capacity_factor=1.25,
                     top_k=1)
PARALLEL_SEQS = 64  # eight batches of 8 per epoch


def _moe_groups(prof, capacity: int, experts: int, d_ff: int) -> tuple[dict, dict]:
    """Device ms of one traced MoE update by group: the attention kernels
    by name; the matmul ops by their operands' shapes (the expert matmuls
    carry ``d_ff``, the dispatch and combine einsums ``experts *
    capacity``, the router a 2-D operand ``experts`` wide; the other
    matmuls apart); the rest, the remainder of all kernel time, split by
    ``_kernel_group`` of the kernels' names. Also the 15 costliest kernels
    by name."""
    import torch

    total = attention = 0.0
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        total += ms
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        if "flash_" in evt.name:
            attention += ms
    mm = {"expert matmuls": 0.0, "router and dispatch/combine einsums": 0.0,
          "other matmuls (attention projections, the fused head)": 0.0}
    ec = experts * capacity
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or evt.name not in (
                "aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"):
            continue
        shapes = [tuple(s) for s in (evt.input_shapes or []) if s]
        ms = getattr(evt, "device_time_total", 0.0) / 1e3
        if any(d_ff in s for s in shapes):
            mm["expert matmuls"] += ms
        elif any(ec in s for s in shapes) or any(
                len(s) == 2 and s[-1] == experts for s in shapes):
            mm["router and dispatch/combine einsums"] += ms
        else:
            mm["other matmuls (attention projections, the fused head)"] += ms
    rest: dict = {}
    for name, ms in by_name.items():
        group = _kernel_group(name)
        if "flash_" in name or group == "matmul":
            continue
        rest[group] = rest.get(group, 0.0) + ms
    groups = {"attention kernels (flash_fwd, flash_bwd_dq, flash_bwd_dkv)": attention,
              **mm,
              "the rest": total - attention - sum(mm.values()),
              "total": total}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    return groups, {"rest_by_kernel_group": dict(sorted(rest.items(), key=lambda kv: -kv[1])),
                    "top_kernels": top}


def parallel_phase(device, updates: int = 8, fused_updates: int = 12,
                   flush_every: int = 4, new_tokens: int = 16):
    """The parallel layouts' path on one card (module docstring, item 13).
    Returns its stats and failures."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MoETransformerLM, generate
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState, make_train_step,
                                            train_loop)
    from fluxmpi_tpu_torch.utils import get_policy

    failures = []
    card = card_line()
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    if fm.is_initialized():
        fm.shutdown()
    dev = fm.init()
    cfg = SWITCH_BASE_8
    corpus = lm_corpus(cfg["vocab_size"], n=PARALLEL_SEQS, seq=cfg["max_len"])
    tokens_per_update = 8 * cfg["max_len"]
    t0 = time.perf_counter()
    model = MoETransformerLM(**cfg, attention="flash", dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    n_params = sum(v.numel() for v in start.values())
    policy = get_policy("bf16")
    print(f"parallel: MoETransformerLM at Switch-Base-8 widths, {n_params} parameters "
          f"(f32 masters, bf16 compute by policy), built in "
          f"{time.perf_counter() - t0:.2f}s; {card}", flush=True)

    def loss_fn(params, model_state, batch):
        x, y = batch
        out = torch.func.functional_call(model, params, (x,), {"targets": y})
        return out.mean(), model_state

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return out

    def run(name, steps, flush, fuse, **step_kw):
        """A fresh state from the same weights through ``train_loop``;
        the counts set to 0 just before and read just after."""
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(start[k])
        opt = optim.adamw(3e-4)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:]))),
            global_batch_size=8, shuffle=True)
        step = make_train_step(loss_fn, opt, policy=policy, **step_kw)
        state = TrainState.create(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for kern in kernels:
            kern.launches = 0
        t1 = time.perf_counter()
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=steps, flush_every=flush,
                               fuse=fuse))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        accounted = {n: counted[n] + extra[n] for n in counted}
        need = cfg["num_layers"] * steps
        if launches != {k.__name__: need for k in kernels}:
            failures.append(f"parallel_phase {name}: launches {launches}, not {need} each")
        if accounted != launches:
            failures.append(f"parallel_phase {name}: the wrappers' counts {accounted} "
                            f"differ from the device's {launches}")
        flush_losses = [f["loss"] for f in summ["flushes"]]
        if not all(math.isfinite(x) for x in flush_losses):
            failures.append(f"parallel_phase {name}: a loss is not finite")
        out = dict(name=name, summary=summ, launches=launches, accounted=accounted,
                   wall_seconds=wall, peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   losses=flush_losses, graphs=graph_stats(step), step=step,
                   bits={k: v.detach().clone() for k, v in leaves(state).items()})
        paths[f"parallel_{name.replace('=', '_').replace(' ', '_')}"] = launches
        print(f"parallel {name}: {summ['updates']} updates, losses {flush_losses}, "
              f"{wall:.3f}s, peak memory {out['peak_memory_gb']:.2f} GB, launches "
              f"{launches} (wrappers with the graphs: {accounted})", flush=True)
        return out

    def same(a, b):
        return (a["losses"] == b["losses"]
                and all(torch.equal(a["bits"][k], b["bits"][k]) for k in a["bits"]))

    stats = dict(card=card, parameters=n_params, config=dict(cfg), batch=[8, cfg["max_len"]])
    paths = stats["launches_by_path"] = {}
    plain = run("no plan", updates, 1, False)
    plain_bits = plain.pop("bits")
    fm.shutdown()
    dev = fm.init(parallel=ParallelConfig())
    plan = fm.global_plan()
    stats["plan"] = plan.describe()
    print(f"parallel: init(parallel=ParallelConfig()) on {dev}: "
          f"{json.dumps(stats['plan'])}", flush=True)
    auto = run("style=auto", updates, 1, False, parallel=plan)
    shard = run("style=shard_map", updates, 1, False, style="shard_map")
    plain["bits"] = plain_bits
    three = same(plain, auto) and same(plain, shard)
    stats["three_ways_bit_identical"] = three
    print(f"parallel: no plan, style='auto' and style='shard_map': "
          f"{'bit-identical' if three else 'DIFFER'} ({len(plain_bits)} leaves, "
          f"{updates} losses)", flush=True)
    if not three:
        failures.append("parallel_phase: the three steps differ")
    del plain, auto, shard, plain_bits
    torch.cuda.empty_cache()

    fused = run("style=auto fused", fused_updates, flush_every, "auto", parallel=plan)
    pipe = run("style=auto pipelined", fused_updates, flush_every, False, parallel=plan)
    fused_same = same(fused, pipe)
    captured = sum(g["captured"] for g in fused["graphs"])
    replays = sum(g["replays"] for g in fused["graphs"])
    print(f"parallel: fused vs fuse=False: {'bit-identical' if fused_same else 'DIFFER'}; "
          f"window graphs captured {captured}, replays {replays} "
          f"({fused['summary']['dispatches']} dispatches, fused_window "
          f"{fused['summary']['fused_window']})", flush=True)
    if not fused_same:
        failures.append("parallel_phase: the fused run differs from fuse=False")
    if not captured or not replays:
        failures.append("parallel_phase: no window was captured and replayed")
    # ms per update: the replayed windows (each of flush_every updates) and
    # the pipelined updates of the last window.
    per_update = [ms / flush_every for ms in fused["summary"]["step_ms"][1:]]
    stats["fused"] = dict(median_update_ms=float(np.median(per_update)),
                          tokens_per_sec=tokens_per_update / float(np.median(per_update)) * 1e3,
                          peak_memory_gb=fused["peak_memory_gb"], graphs=fused["graphs"],
                          launches=fused["launches"], bit_identical=fused_same)
    pipe_ms = float(np.median(pipe["summary"]["step_ms"][-flush_every:]))
    stats["pipelined"] = dict(median_update_ms=pipe_ms,
                              tokens_per_sec=tokens_per_update / pipe_ms * 1e3,
                              peak_memory_gb=pipe["peak_memory_gb"],
                              launches=pipe["launches"])
    step = pipe["step"]
    del fused, pipe
    torch.cuda.empty_cache()

    # One traced update of the pipelined step, by group.
    opt = optim.adamw(3e-4)
    state = TrainState.create(model, opt)
    x = torch.from_numpy(corpus[:8, :-1]).to(dev)
    y = torch.from_numpy(corpus[:8, 1:]).to(dev)
    step(state, (x, y))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, (x, y))
        torch.cuda.synchronize()
    capacity = max(1, int(-(-cfg["max_len"] * cfg["capacity_factor"] * cfg["top_k"]
                             // cfg["num_experts"])))
    groups, detail = _moe_groups(prof, capacity, cfg["num_experts"], cfg["d_ff"])
    stats["device_ms_by_group"] = groups
    stats["device_ms_detail"] = detail
    if not groups["total"]:
        failures.append("parallel_phase: the trace holds no device time")
    for g, ms in groups.items():
        share = ms / groups["total"] if groups["total"] else float("nan")
        print(f"parallel profile: {g:60s} {ms:9.3f} ms  {share:6.1%}", flush=True)
    for g, ms in detail["rest_by_kernel_group"].items():
        print(f"parallel profile:   the rest, {g:49s} {ms:9.3f} ms", flush=True)
    for name, ms in detail["top_kernels"].items():
        print(f"parallel profile:   kernel {name[:90]:90s} {ms:9.3f} ms", flush=True)
    print(f"parallel: {card}: fused {stats['fused']['median_update_ms']:.3f} ms per "
          f"update = {stats['fused']['tokens_per_sec']:.1f} tokens/s, pipelined "
          f"{pipe_ms:.3f} ms = {stats['pipelined']['tokens_per_sec']:.1f} tokens/s, "
          f"peak memory {stats['fused']['peak_memory_gb']:.2f} GB", flush=True)
    del state, opt
    torch.cuda.empty_cache()

    # Greedy generate: the "auto" prefill is the scan for MoE.
    prompt = torch.from_numpy(corpus[:2, :16].astype(np.int64)).to(dev)
    flash_fwd.launches = 0
    with torch.no_grad():
        toks, launches = kernel_launches(lambda: generate(model, prompt, new_tokens))
        counted = flash_fwd.launches
        scan = generate(model, prompt, new_tokens, prefill="scan")
    torch.cuda.synchronize()
    gen_same = torch.equal(toks, scan)
    stats["generate"] = dict(tokens=toks.tolist(), scan_equal=gen_same,
                             flash_fwd_launches=launches["flash_fwd"], counted=counted)
    print(f"parallel generate: {new_tokens} greedy tokens, 'auto' "
          f"{'equals' if gen_same else 'DIFFERS FROM'} 'scan'; flash_fwd launches "
          f"{launches['flash_fwd']} (wrappers {counted})", flush=True)
    if not gen_same:
        failures.append("parallel_phase: generate's auto prefill differs from scan")
    if launches["flash_fwd"] != counted or not counted:
        failures.append("parallel_phase: generate's flash_fwd launches disagree")
    paths["parallel_generate"] = {"flash_fwd": launches["flash_fwd"], "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}
    del model, start
    torch.cuda.empty_cache()
    fm.shutdown()
    return stats, failures


def autotune_phase(device, updates: int = 12, flush_every: int = 4):
    """The layout autotuner on one card (module docstring, item 14).
    Returns its stats and failures."""
    import tempfile

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    import fluxmpi_tpu_torch.parallel.autotune  # noqa: F401
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step, train_loop
    from fluxmpi_tpu_torch.telemetry.memory import device_memory_stats
    from fluxmpi_tpu_torch.telemetry.schema import validate_autotune_record
    from fluxmpi_tpu_torch.utils import manifest
    from fluxmpi_tpu_torch.utils.checkpoint import save_checkpoint

    at = sys.modules["fluxmpi_tpu_torch.parallel.autotune"]
    failures = []
    card = card_line()
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    cfg = GPT2_SMALL
    corpus = lm_corpus(cfg["vocab_size"], n=32, seq=cfg["max_len"]).astype(np.int64)
    # The search's sample batch; the runs take 4 batches per epoch (windows
    # of 4).
    sample = (corpus[:8, :-1], corpus[:8, 1:])
    tokens_per_update = 8 * cfg["max_len"]
    if fm.is_initialized():
        fm.shutdown()
    dev = fm.init()
    model = TransformerLM(**cfg, attention="flash", device=dev,
                          generator=torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}

    def loss_fn(params, model_state, batch):
        x, y = batch
        out = torch.func.functional_call(model, params, (x,), {"targets": y})
        return out.mean(), model_state

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return out

    def run(name, fuse, **step_kw):
        """12 updates from the start weights through ``train_loop``, the
        counts set to 0 just before and read just after."""
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(start[k])
        opt = optim.adamw(3e-4)
        loader = fm.DistributedDataLoader(
            fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:])), global_batch_size=8)
        step = make_train_step(loss_fn, opt, **step_kw)
        # A world of one: the winner (dp=1) shards nothing.
        state = TrainState.create(model, opt)
        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        t1 = time.perf_counter()
        (state, summ), launches = kernel_launches(
            lambda: train_loop(step, state, loader, steps=updates,
                               flush_every=flush_every, fuse=fuse))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step)
        accounted = {n: counted[n] + extra[n] for n in counted}
        need = cfg["num_layers"] * updates
        if launches != {k.__name__: need for k in kernels}:
            failures.append(f"autotune_phase {name}: launches {launches}, not {need} each")
        if accounted != launches:
            failures.append(f"autotune_phase {name}: the wrappers' counts {accounted} "
                            f"differ from the device's {launches}")
        losses = [f["loss"] for f in summ["flushes"]]
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"autotune_phase {name}: a loss is not finite")
        paths[f"autotune_{name.replace(' ', '_').replace('=', '_')}"] = launches
        print(f"autotune {name}: {summ['updates']} updates, losses {losses}, {wall:.3f}s, "
              f"launches {launches} (wrappers with the graphs: {accounted})", flush=True)
        return dict(summary=summ, losses=losses, graphs=graph_stats(step), wall=wall,
                    state=state, bits={k: v.detach().clone()
                                       for k, v in leaves(state).items()})

    def same(a, b):
        return (a["losses"] == b["losses"]
                and all(torch.equal(a["bits"][k], b["bits"][k]) for k in a["bits"]))

    stats = dict(card=card, config=dict(cfg), batch=[8, cfg["max_len"]])
    paths = stats["launches_by_path"] = {}
    plain = run("no plan", False)
    plain.pop("state")
    fm.shutdown()

    dev = fm.init(parallel="auto", compileplane=True)
    if not fm.runtime.auto_parallel() or fm.global_plan() is not None:
        failures.append("autotune_phase: init(parallel='auto') did not arm the autotuner")
    limit = device_memory_stats(dev).get("bytes_limit")
    opt = optim.adamw(3e-4)
    at.clear_bank()
    t0 = time.perf_counter()
    res = at.autotune(loss_fn, opt, model, sample)
    search_s = time.perf_counter() - t0
    rec = res.record
    (cand,) = rec["candidates"] if len(rec["candidates"]) == 1 else (None,)
    trial = (cand or {}).get("trial") or {}
    errors = validate_autotune_record(rec)
    stats["search"] = dict(seconds=search_s, record=rec, bytes_limit=limit,
                           validator_errors=errors)
    print(f"autotune: {len(rec['candidates'])} candidate(s), memory floor "
          f"{(cand or {}).get('mem_bytes_per_device')} bytes against the card's bytes_limit "
          f"{limit:.0f}; score {(cand or {}).get('score')}; trial {json.dumps(trial)}; "
          f"search {search_s:.3f}s; record valid: {not errors}", flush=True)
    if cand is None:
        failures.append(f"autotune_phase: {len(rec['candidates'])} candidates, not 1")
    if rec["trials"] != 1 or trial.get("captures") != 1 or trial.get("steady_compiles") != 0:
        failures.append(f"autotune_phase: the trial is not one capture with no "
                        f"re-capture: {trial}")
    if errors:
        failures.append(f"autotune_phase: the record is invalid: {errors}")
    if fm.global_plan() is not res.plan:
        failures.append("autotune_phase: the winner is not the installed plan")

    real = at._run_trial

    def boom(*a, **k):
        raise AssertionError("a trial ran on a bank hit")

    at._run_trial = boom
    try:
        hit = at.autotune(loss_fn, opt, model, sample)
    finally:
        at._run_trial = real
    print(f"autotune: second search from the bank: {hit.from_bank}", flush=True)
    if not hit.from_bank or hit.record["winner"] != rec["winner"]:
        failures.append("autotune_phase: the second search was not answered by the bank")
    floor = cand["mem_bytes_per_device"] if cand else 1
    try:
        at.autotune(loss_fn, opt, model, sample, bytes_limit=floor - 1, force=True)
        failures.append("autotune_phase: a budget below the floor did not raise")
    except RuntimeError as exc:
        print(f"autotune: bytes_limit {floor - 1}: {exc}", flush=True)
        if "every candidate layout exceeds" not in str(exc):
            failures.append(f"autotune_phase: the budget error is not JAX's: {exc}")

    fused = run("auto fused", "auto", parallel="auto")
    pipe = run("auto pipelined", False, parallel="auto")
    captured = sum(g["captured"] for g in fused["graphs"])
    all_same = same(fused, pipe) and same(fused, plain)
    print(f"autotune: parallel='auto' fused vs fuse=False vs no plan: "
          f"{'bit-identical' if all_same else 'DIFFER'}; window graphs captured "
          f"{captured}", flush=True)
    if not all_same:
        failures.append("autotune_phase: the autotuned runs differ from each other or "
                        "from the run with no plan")
    if not captured:
        failures.append("autotune_phase: no window was captured")
    per_update = [ms / flush_every for ms in fused["summary"]["step_ms"][1:]]
    stats["fused"] = dict(median_update_ms=float(np.median(per_update)),
                          tokens_per_sec=tokens_per_update / float(np.median(per_update)) * 1e3,
                          bit_identical=all_same)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        save_checkpoint(path, fused["state"])
        side = path + ".autotune.json"
        sidecar = os.path.exists(side)
        side_ok = False
        if sidecar:
            with open(side) as f:
                side_ok = not validate_autotune_record(json.load(f))
        man = manifest.read_manifest(path) or {}
        fp = (man.get("parallel") or {}).get("autotune_fingerprint")
    stats["checkpoint"] = dict(sidecar=sidecar, sidecar_valid=side_ok, manifest_fingerprint=fp)
    print(f"autotune: checkpoint sidecar written {sidecar} (valid {side_ok}), manifest "
          f"fingerprint {fp} (record {rec['model_fingerprint']})", flush=True)
    if not side_ok or fp != rec["model_fingerprint"]:
        failures.append("autotune_phase: the checkpoint lacks the sidecar or the fingerprint")
    print(f"autotune: {card}: fused {stats['fused']['median_update_ms']:.3f} ms per update "
          f"= {stats['fused']['tokens_per_sec']:.1f} tokens/s; trial "
          f"{trial.get('examples_per_sec')} examples/s; search {search_s:.3f}s", flush=True)
    del fused, pipe, plain, model, start
    at.clear_bank()
    fm.shutdown()
    return stats, failures


SHARD_WORKERS = 4  # the CPU gloo world that writes the sharded checkpoint


def _tiny_state_moments(state):
    """Give a fresh TrainState non-trivial adamw moments and count (the
    same in the card process and the sharding children): mu = p / 2,
    nu = p * p, count 1."""
    import torch

    with torch.no_grad():
        for k, p in state.params.items():
            state.opt_state["mu"][k].copy_(p * 0.5)
            state.opt_state["nu"][k].copy_(p * p)
        state.opt_state["count"].fill_(1)
    state.step = 1
    return state


def shard_child(workdir: str, rank: int, world: int) -> int:
    """One CPU worker of ``elastic_phase``'s sharded save, in its own
    process: the f32 GPT-2-small TrainState from seed 0 (the moments of
    :func:`_tiny_state_moments`), laid out by ``fsdp_rule`` over a
    ``world``-worker mesh and committed as step 1 through a
    ``CheckpointManager`` in ``workdir/ckpt``; its bytes written and
    seconds go to ``workdir/child<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // world))
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(workdir) / "store"), world),
                            rank=rank, world_size=world)
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.parallel import TrainState
    from fluxmpi_tpu_torch.parallel.sharding import Mesh, fsdp_rule, shard_tree
    from fluxmpi_tpu_torch.utils import CheckpointManager

    fm.init(device="cpu")
    t0 = time.perf_counter()
    model = TransformerLM(**GPT2_SMALL, attention="flash", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    state = _tiny_state_moments(TrainState.create(model, optim.adamw(3e-4)))
    mesh = Mesh(np.arange(world), ("dp",))
    placed, _ = shard_tree(state, mesh, fsdp_rule(mesh))
    del state, model
    built = time.perf_counter() - t0
    mgr = CheckpointManager(str(Path(workdir) / "ckpt"), async_save=False)
    t1 = time.perf_counter()
    mgr.save(1, placed)
    saved = time.perf_counter() - t1
    mgr.close()
    shard = Path(workdir) / "ckpt" / "step_00000001" / f"shard_{rank}.pt"
    (Path(workdir) / f"child{rank}.json").write_text(json.dumps(dict(
        bytes=shard.stat().st_size, build_seconds=built, save_seconds=saved)))
    fm.shutdown()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def elastic_phase(device, flush_every: int = 4, resume_flush: int = 2):
    """Sharded checkpoints, elastic resume and the live resize on one card
    (module docstring, item 15). Returns its stats and failures."""
    import tempfile

    import numpy as np
    import torch

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import faults, optim
    from fluxmpi_tpu_torch.errors import FaultInjectedError
    from fluxmpi_tpu_torch.fleet import resize
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from fluxmpi_tpu_torch.parallel import (ParallelConfig, TrainState, make_train_step,
                                            train_loop)
    from fluxmpi_tpu_torch.telemetry import MetricsRegistry
    from fluxmpi_tpu_torch.telemetry.schema import validate_resize_record
    from fluxmpi_tpu_torch.utils import CheckpointManager

    failures = []
    card = card_line()
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    cfg = GPT2_SMALL
    corpus = lm_corpus(cfg["vocab_size"], n=256, seq=cfg["max_len"])
    ids = np.arange(len(corpus), dtype=np.int32)
    stats = dict(card=card, config=dict(cfg))
    paths = stats["launches_by_path"] = {}
    if fm.is_initialized():
        fm.shutdown()
    dev = fm.init()

    def build(gbs, dtype=torch.bfloat16, prefetch=2, model=None):
        """A fresh model (seed 0), its TrainState, the device-gather loader
        over (tokens, targets, ids) and a step whose loss logs the ids each
        update consumed into a device buffer (a CUDA-graph replay runs no
        Python, so the log is device work the graph holds)."""
        if model is None:
            model = TransformerLM(**cfg, attention="flash", dropout=0.0, dtype=dtype,
                                  device=dev, generator=torch.Generator().manual_seed(0))
        log = torch.full((2 * len(corpus),), -1, dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int64, device=dev)

        def loss_fn(params, model_state, batch):
            x, y, rows = batch
            n = rows.shape[0]
            log.index_copy_(0, pos + torch.arange(n, device=dev), rows)
            pos.add_(n)
            out = torch.func.functional_call(model, params, (x,), {"targets": y})
            return out.mean(), model_state

        opt = optim.adamw(3e-4)
        loader = fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((corpus[:, :-1], corpus[:, 1:], ids))),
            global_batch_size=gbs, shuffle=True, prefetch=prefetch)
        state = TrainState.create({k: v.detach().clone().requires_grad_()
                                   for k, v in model.named_parameters()}, opt)
        return dict(model=model, state=state, loader=loader, log=log, pos=pos,
                    step=make_train_step(loss_fn, opt))

    def leaves(state):
        out = {f"params/{k}": v for k, v in state.params.items()}
        for m in ("mu", "nu"):
            out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
        out["count"] = state.opt_state["count"]
        return out

    def drive(name, run, step, updates, fused):
        """``run()`` on the main path: the counts set to 0 just before and
        read just after, by the wrappers (with the graphs' replays) and by
        the kernels' device counters; ``updates`` launches of each per
        layer."""
        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        out, launches = kernel_launches(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {k.__name__: k.launches for k in kernels}
        extra = graph_launches(step) if fused else {n: 0 for n in counted}
        accounted = {n: counted[n] + extra[n] for n in counted}
        need = cfg["num_layers"] * updates
        if launches != {k.__name__: need for k in kernels}:
            failures.append(f"elastic_phase {name}: launches {launches}, not {need} each")
        if accounted != launches:
            failures.append(f"elastic_phase {name}: the wrappers' counts {accounted} differ "
                            f"from the device's {launches}")
        paths[f"elastic_{name}"] = launches
        print(f"elastic {name}: {updates} updates in {wall:.3f}s, launches {launches}",
              flush=True)
        return out

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # -- 1. Elastic resume across batch geometry: 8 -> 16 -------------
        ref = build(8)
        ref_state, ref_sum = drive("reference", lambda: train_loop(
            ref["step"], ref["state"], ref["loader"], epochs=1, flush_every=flush_every),
            ref["step"], 32, True)
        reference = ref["log"][:int(ref["pos"])].tolist()
        ref_bits = {k: v.detach().clone() for k, v in leaves(ref_state).items()}
        ref_step = ref_state.step
        del ref, ref_state

        killed = build(8, prefetch=0)
        mgr = CheckpointManager(os.path.join(tmp, "elastic"), max_to_keep=1)

        def crash():
            with faults.scope("data.fetch@step=13"):
                try:
                    train_loop(killed["step"], killed["state"], killed["loader"], epochs=1,
                               flush_every=flush_every, save_every=4, checkpoint=mgr,
                               fuse=False)
                except FaultInjectedError:
                    return "killed"
            return "finished"

        outcome = drive("killed_8", crash, killed["step"], 12, False)
        mgr.close()
        prefix = killed["log"][:int(killed["pos"])].tolist()
        latest = mgr.latest_step()
        del killed
        resumed = build(16)
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        _, res_sum = drive("resumed_16", lambda: train_loop(
            resumed["step"], resumed["state"], resumed["loader"], epochs=1,
            flush_every=resume_flush, checkpoint=CheckpointManager(
                os.path.join(tmp, "elastic"), max_to_keep=1), resume=True, metrics=reg),
            resumed["step"], 10, True)
        resume_s = time.perf_counter() - t0
        tail = resumed["log"][:int(resumed["pos"])].tolist()
        labeled = reg.counter("train.resumes", topology_changed="true").value
        losses = [f["loss"] for f in res_sum["flushes"]]
        exact = prefix + tail == reference and len(reference) == 256
        stats["elastic"] = dict(outcome=outcome, latest=latest,
                                resumed_from=res_sum["resumed_from"],
                                fused_window=res_sum["fused_window"],
                                prefix=len(prefix), tail=len(tail), sample_exact=exact,
                                resumes_topology_changed=labeled, losses=losses,
                                resume_seconds=resume_s)
        print(f"elastic: killed {outcome} at latest step {latest}, {len(prefix)} ids; "
              f"resumed at global batch 16 from {res_sum['resumed_from']} with "
              f"{res_sum['updates'] - 12} more updates (windows of "
              f"{res_sum['fused_window']}), {len(tail)} ids; prefix + tail == the "
              f"uninterrupted batch-8 order: {exact}; train.resumes{{topology_changed}} "
              f"{labeled}; losses {losses}; {resume_s:.3f}s", flush=True)
        if outcome != "killed" or latest != 12 or res_sum["resumed_from"] != 12:
            failures.append(f"elastic_phase: the kill and resume are not at step 12 "
                            f"({outcome}, latest {latest}, resumed_from "
                            f"{res_sum['resumed_from']})")
        if not exact:
            failures.append("elastic_phase: the consumed ids differ from the "
                            "uninterrupted epoch's order")
        if labeled != 1:
            failures.append(f"elastic_phase: train.resumes{{topology_changed}} is {labeled}")
        if not losses or not all(math.isfinite(x) for x in losses):
            failures.append("elastic_phase: a resumed loss is not finite")
        del resumed

        # -- 2. The live resize round trip (fused) -----------------------
        fm.shutdown()
        bank = os.path.join(tmp, "resize_bank.jsonl")
        dev = fm.init(resize=bank)
        rz_dir = os.path.join(tmp, "resize")
        first = build(8)
        resize.request_resize(1, reason="elastic_phase")
        mgr = CheckpointManager(rz_dir, max_to_keep=1)
        _, drained = drive("resize_drain", lambda: train_loop(
            first["step"], first["state"], first["loader"], epochs=1,
            flush_every=flush_every, checkpoint=mgr), first["step"], flush_every, True)
        mgr.close()
        stamped = resize.read_handoff(rz_dir) is not None
        del first
        second = build(8)
        mgr = CheckpointManager(rz_dir, max_to_keep=1)
        state, after = drive("resize_resume", lambda: train_loop(
            second["step"], second["state"], second["loader"], epochs=1,
            flush_every=flush_every, checkpoint=mgr, resume=True), second["step"],
            32 - flush_every, True)
        mgr.close()
        bits = {k: v.detach() for k, v in leaves(state).items()}
        same = (state.step == ref_step
                and all(torch.equal(bits[k], ref_bits[k]) for k in ref_bits))
        with open(bank) as f:
            records = [json.loads(line) for line in f if line.strip()]
        errors = [validate_resize_record(r) for r in records]
        check = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "scripts"
                                                    / "check_metrics_schema.py"), bank],
                               capture_output=True, text=True)
        gone = resize.read_handoff(rz_dir) is None
        phases = records[0]["phases"] if records else {}
        stats["resize"] = dict(drained_at=drained["updates"], resized_to=drained["resized_to"],
                               stamp_written=stamped, stamp_removed=gone,
                               resumed_from=after["resumed_from"], updates=after["updates"],
                               bit_identical=same, records=len(records),
                               validator_errors=errors, schema_check_rc=check.returncode,
                               phase_seconds=phases)
        print(f"resize: drained at update {drained['updates']} to "
              f"{drained['resized_to']} worker(s), stamp written {stamped}; resumed from "
              f"{after['resumed_from']} to {after['updates']} updates; final state bit for "
              f"bit the uninterrupted run's: {same}; {len(records)} record(s), valid "
              f"{errors == [[]]}, check_metrics_schema rc={check.returncode}; phase "
              f"seconds {json.dumps(phases)}; stamp removed {gone}", flush=True)
        if drained["resized_to"] != 1 or drained["updates"] != flush_every or not stamped:
            failures.append(f"elastic_phase: the resize did not drain at the first flush "
                            f"({drained['updates']}, {drained['resized_to']}, {stamped})")
        if not same or after["updates"] != 32:
            failures.append("elastic_phase: the resized run differs from the uninterrupted "
                            "one")
        if len(records) != 1 or errors != [[]] or check.returncode:
            failures.append(f"elastic_phase: the resize bank is not one valid record "
                            f"({len(records)}, {errors}, rc {check.returncode}: "
                            f"{check.stderr[-300:]})")
        if not gone:
            failures.append("elastic_phase: the handoff stamp is still there")
        del second, state, bits, ref_bits
        fm.shutdown()
        dev = fm.init()
        settle("elastic_phase's sharded restore")

        # -- 3. A sharded checkpoint written by 4 CPU workers, on the card
        work = os.path.join(tmp, "shards")
        os.makedirs(work)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
        env.pop("FLUXMPI_TPU_RESIZE", None)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--shard-child", work, str(r), str(SHARD_WORKERS)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(SHARD_WORKERS)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        children_s = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            failures.append(f"elastic_phase: a sharding child failed: {outs[-1][-2000:]}")
            fm.shutdown()
            return stats, failures
        kids = [json.loads(Path(work, f"child{r}.json").read_text())
                for r in range(SHARD_WORKERS)]
        unsharded = build(8, dtype=torch.float32)
        _tiny_state_moments(unsharded["state"])
        # Structure, global shapes and dtypes only: meta tensors.
        like = TrainState(step=0, params={k: torch.empty(v.shape, dtype=v.dtype,
                                                         device="meta")
                                          for k, v in unsharded["state"].params.items()},
                          opt_state={"count": torch.empty((), dtype=torch.int32,
                                                          device="meta"),
                                     **{m: {k: torch.empty(v.shape, dtype=v.dtype,
                                                           device="meta")
                                            for k, v in unsharded["state"].params.items()}
                                        for m in ("mu", "nu")}})
        mgr = CheckpointManager(os.path.join(work, "ckpt"), async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_no, restored = mgr.restore(like, parallel=ParallelConfig(dp=1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = leaves(unsharded["state"])
        got = leaves(restored)
        on_card = all(v.device.type == "cuda" for v in got.values())
        leaves_same = (restored.step == unsharded["state"].step
                       and all(torch.equal(got[k], want[k]) for k in want))
        twin = build(8, dtype=torch.float32, model=unsharded["model"])
        for v in restored.params.values():
            v.requires_grad_()  # the step differentiates the parameters
        twin["state"] = restored
        a_state, _ = drive("sharded_unsharded", lambda: train_loop(
            unsharded["step"], unsharded["state"], unsharded["loader"], steps=4,
            flush_every=2), unsharded["step"], 4, True)
        b_state, _ = drive("sharded_restored", lambda: train_loop(
            twin["step"], twin["state"], twin["loader"], steps=4, flush_every=2),
            twin["step"], 4, True)
        a, b = leaves(a_state), leaves(b_state)
        updates_same = all(torch.equal(a[k], b[k]) for k in a)
        total = sum(v.numel() * v.element_size() for v in want.values())
        stats["sharded"] = dict(workers=SHARD_WORKERS, step=step_no,
                                child_bytes=[k["bytes"] for k in kids],
                                child_save_seconds=[k["save_seconds"] for k in kids],
                                children_seconds=children_s, state_bytes=total,
                                restore_seconds=restore_s, on_card=on_card,
                                leaves_bit_identical=leaves_same,
                                updates_bit_identical=updates_same)
        print(f"sharded: {SHARD_WORKERS} CPU workers wrote step {step_no} (bytes "
              f"{[k['bytes'] for k in kids]} of a {total}-byte state; save seconds "
              f"{[round(k['save_seconds'], 3) for k in kids]}; {children_s:.3f}s with start-up); "
              f"restored on the card with parallel=ParallelConfig(dp=1) and a meta like in "
              f"{restore_s:.3f}s, on the card {on_card}: every leaf bit for bit "
              f"{leaves_same}; 4 updates from it "
              f"bit for bit the unsharded state's {updates_same}", flush=True)
        if not leaves_same:
            failures.append("elastic_phase: the 4 -> 1 restore differs from the unsharded "
                            "state")
        if not on_card:
            failures.append("elastic_phase: the 4 -> 1 restore did not land on the card")
        if not updates_same:
            failures.append("elastic_phase: the updates from the restored state differ")
        del unsharded, twin, restored, a_state, b_state
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"elastic: {card}: phase {stats['seconds']:.3f}s", flush=True)
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


def settle(before: str) -> None:
    """Between phases: free what the last one left (its CUDA graphs'
    private pools go with the objects that hold them, reference cycles
    included), empty the allocator's cache, and print what stays on the
    card before ``before`` runs."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"memory before {before}: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved, {free / 1e9:.3f} of "
          f"{total / 1e9:.3f} GB free on the card", flush=True)


def run_phases(device):
    """All phases on ``device``; returns the kernels' rows, the serving and
    training results, and the failures."""
    rows, failures = kernel_phase(device)
    bwd_rows, masks, bwd_failures = backward_phase(device)
    failures += bwd_failures
    settle("slice_phase")
    stats, slice_failures = slice_phase(device)
    failures += slice_failures
    settle("serving_plane_phase")
    plane, plane_failures = serving_plane_phase(device, stats["ttft_p50_ms"] / 1e3)
    failures += plane_failures
    settle("train_phase")
    train, train_failures = train_phase(device)
    failures += train_failures
    settle("bf16_phase")
    bf16, bf16_failures = bf16_phase(device, train)
    failures += bf16_failures
    settle("fused_phase")
    fused, fused_failures = fused_phase(device, bf16)
    failures += fused_failures
    settle("telemetry_phase")
    telem, telem_failures = telemetry_phase(device)
    failures += telem_failures
    settle("vision_phase")
    vision, vision_failures = vision_phase(device)
    failures += vision_failures
    settle("zoo_phase")
    zoo, zoo_failures = zoo_phase(device)
    failures += zoo_failures
    settle("finetune_phase")
    tune, tune_failures = finetune_phase(device)
    failures += tune_failures
    settle("health_phase")
    health, health_failures = health_phase(device)
    failures += health_failures
    settle("parallel_phase")
    par, par_failures = parallel_phase(device)
    failures += par_failures
    settle("autotune_phase")
    tune_auto, auto_failures = autotune_phase(device)
    failures += auto_failures
    settle("elastic_phase")
    elastic, elastic_failures = elastic_phase(device)
    failures += elastic_failures
    par_paths = {**par.get("launches_by_path", {}),
                 **tune_auto.get("launches_by_path", {}),
                 **elastic.get("launches_by_path", {})}
    health_paths = {f"health_planes_{name}": health[f"planes_{name}"]["launches"]
                    for name in ("off", "on") if f"planes_{name}" in health}
    tune_paths = {"finetune_flash_dropout": tune["flash_dropout"]["launches"],
                  "finetune_kernel_dropout_fused": tune["kernel_dropout"]["launches"],
                  "finetune_kernel_dropout_pipelined":
                      tune["kernel_dropout"]["launches_pipelined"],
                  "finetune_host_transform": tune["host_transform"]["launches"]}
    zoo_paths = {f"zoo_{kind}{'' if run == 'fused' else '_pipelined'}":
                 zoo[kind][run]["launches"] for kind in ("vit", "unet")
                 for run in ("pipelined", "fused")}

    def zoo_rows(rows, keys):
        return {f"{r['case']} {r['dtype']}": {k: r.get(k) for k in keys}
                for r in rows if r["case"] in ZOO_TABLE_CASES}

    def dropout_rows(rows, keys):
        return {f"{r['case']} {r['dtype']}": {k: r.get(k) for k in keys}
                for r in rows if r["case"] in DROPOUT_TABLE_CASES}

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
                     + sum(n["flash_fwd"] for n in zoo_paths.values())
                     + sum(n["flash_fwd"] for n in tune_paths.values())
                     + sum(n["flash_fwd"] for n in health_paths.values())
                     + sum(n["flash_fwd"] for n in par_paths.values())
                     + health.get("serving", {}).get("flash_fwd_launches", 0)
                     + sum(plane["launches"].values())),
        "launches_by_path": {"serve": stats["launches"], **plane["launches"],
                             "train": train["launches"]["flash_fwd"],
                             "train_bf16": bf16["launches"]["flash_fwd"],
                             "train_bf16_remat":
                                 bf16["remat"]["remat"]["launches"]["flash_fwd"],
                             "train_bf16_remat_dots":
                                 bf16["remat"]["dots"]["launches"]["flash_fwd"],
                             "train_bf16_fused": fused["fused"]["launches"]["flash_fwd"],
                             "train_bf16_telemetry":
                                 telem["planes_on"]["launches"]["flash_fwd"],
                             **{p: n["flash_fwd"] for p, n in zoo_paths.items()},
                             **{p: n["flash_fwd"] for p, n in tune_paths.items()},
                             **{p: n["flash_fwd"] for p, n in health_paths.items()},
                             **{p: n["flash_fwd"] for p, n in par_paths.items()},
                             "health_serving": health.get("serving", {}).get(
                                 "flash_fwd_launches", 0)},
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
        "dropout_cases": dropout_rows(rows, ("ms", "plain_ms", "bound_ms", "bound_by",
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
                         + sum(n[kname] for n in zoo_paths.values())
                         + sum(n[kname] for n in tune_paths.values())
                         + sum(n[kname] for n in health_paths.values())
                         + sum(n[kname] for n in par_paths.values())),
            "launches_by_path": {"train": train["launches"][kname],
                                 "train_bf16": bf16["launches"][kname],
                                 "train_bf16_remat":
                                     bf16["remat"]["remat"]["launches"][kname],
                                 "train_bf16_remat_dots":
                                     bf16["remat"]["dots"]["launches"][kname],
                                 "train_bf16_fused": fused["fused"]["launches"][kname],
                                 "train_bf16_telemetry":
                                     telem["planes_on"]["launches"][kname],
                                 **{p: n[kname] for p, n in zoo_paths.items()},
                                 **{p: n[kname] for p, n in tune_paths.items()},
                                 **{p: n[kname] for p, n in health_paths.items()},
                                 **{p: n[kname] for p, n in par_paths.items()}},
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
            "dropout_cases": dropout_rows(bwd_rows, (f"{key}_ms", "plain_ms",
                                                     f"{key}_bound_ms", "dterm_ms",
                                                     "rel_err")),
            "cases": [{k: r[k] for k in ("case", "dtype", "err", "rel_err", "ok",
                                         f"{key}_ms", f"{key}_bound_ms")}
                      for r in bwd_rows],
        })
    return kernels, {"slice": stats, "serving_plane": plane, "train": train,
                     "train_bf16": bf16,
                     "train_bf16_fused": fused, "train_bf16_telemetry": telem,
                     "vision": vision, "zoo": zoo, "finetune": tune,
                     "health": health, "parallel": par, "autotune": tune_auto,
                     "elastic": elastic}, failures


if __name__ == "__main__":
    if sys.argv[1:2] == ["--staging-child"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(staging_child(sys.argv[2]))
    if sys.argv[1:2] == ["--shard-child"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(shard_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
