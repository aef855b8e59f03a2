"""The port stands alone: importing ``fluxmpi_tpu_torch`` loads no JAX,
flax, ``transformers`` or ``fluxmpi_tpu`` module (every module of the port, the training
slice's included), its sources import none, its entry points refuse a
missing CUDA device unless the caller asked for the CPU, and
``chip_smoke.py`` fails (and prints no result) without a card or without
the package beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fluxmpi_tpu_torch
from fluxmpi_tpu_torch.models import TransformerLM
from fluxmpi_tpu_torch.runtime import resolve_device
from fluxmpi_tpu_torch.serving import BlockKVCache

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fluxmpi_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "transformers", "fluxmpi_tpu"}


def _forbidden(name: str) -> bool:
    # Exact root names: "fluxmpi_tpu_torch" shares the prefix and is fine.
    return name.split(".")[0] in FORBIDDEN_ROOTS


def test_import_loads_no_jax_flax_or_reference_package():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import fluxmpi_tpu_torch, fluxmpi_tpu_torch.ops._build\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    loaded = out.stdout.split()
    assert "fluxmpi_tpu_torch.serving.engine" in loaded
    ported = {f"fluxmpi_tpu_torch.{m}" for m in (
        "comm", "data", "errors", "logging", "optim", "optimizer", "runtime",
        "sync", "ops.flash_attention", "ops.fused_ce", "models.mlp",
        "models.convert", "models.transformer", "parallel.train",
        "parallel.loop", "faults", "utils.precision", "utils.manifest",
        "utils.checkpoint", "config", "models.cnn", "models.resnet", "models.deq",
        "models._layers", "models.vit", "models.unet", "utils.ema",
        "telemetry", "telemetry.schema", "telemetry.registry", "telemetry.sinks",
        "telemetry.tracing", "telemetry.flight_recorder", "telemetry.watchdog",
        "telemetry.memory", "telemetry.monitor", "telemetry.goodput",
        "utils.flops", "serving.cache", "serving.observe", "models.generate",
        "models.hf_gpt2", "io", "io.native", "telemetry.anomaly",
        "telemetry.compileplane", "telemetry.modelstats", "telemetry.export",
        "telemetry.fleet", "utils.profiling", "parallel.plan", "parallel.sharding",
        "parallel.collectives", "_collective_ops", "models.moe", "fleet",
        "fleet.resize")}
    assert ported <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_importing_telemetry_initializes_neither_cuda_nor_a_group():
    """The JAX package's import-safe contract: importing the telemetry
    package (and its profiling helpers) touches no device and brings up
    no process group; every module of it imports no JAX."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "before = set(sys.modules)\n"
        "import fluxmpi_tpu_torch.telemetry as t\n"
        "import fluxmpi_tpu_torch.utils.profiling, fluxmpi_tpu_torch.utils.flops\n"
        "t.get_registry().counter('x').inc()\n"
        "t.tracing.configure(True); t.instant('x')\n"
        "t.get_flight_recorder().dump(); t.memory.record_hbm()\n"
        "t.get_goodput_tracker().report()\n"
        "print(torch.cuda.is_initialized(), dist.is_initialized())\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    first, *loaded = out.stdout.split("\n")
    assert first == "False False"
    assert "fluxmpi_tpu_torch.telemetry.watchdog" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_sources_import_no_jax_flax_or_reference_package():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert len(files) > 10 and offenders == []


def test_the_native_loader_is_the_ports_own_copy():
    """The port builds its own copy of the C++ prefetcher's source, into a
    path of its own: the JAX package's library and the port's never share
    a file."""
    from fluxmpi_tpu.io import native as jnative
    from fluxmpi_tpu_torch.io import native

    assert native._SRC.parent == PKG / "io"
    assert native._SRC.read_text() != ""
    assert native._lib_path().parent == PKG / "io" / "_build"
    assert str(native._lib_path()) != jnative._lib_path()


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(vocab_size=11, max_len=8, num_layers=1, d_model=8,
                      num_heads=2, d_ff=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockKVCache(num_layers=1, num_heads=1, head_dim=4, num_blocks=4,
                     block_size=8, max_blocks_per_seq=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    from types import SimpleNamespace

    from fluxmpi_tpu_torch.models import lm_from_gpt2

    cfg = SimpleNamespace(vocab_size=11, n_positions=8, n_embd=8, n_layer=1, n_head=2,
                          layer_norm_epsilon=1e-5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_from_gpt2(SimpleNamespace(config=cfg, state_dict=dict))
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
    assert fluxmpi_tpu_torch.resolve_device is resolve_device


def test_training_entry_points_refuse_missing_cuda(monkeypatch):
    from fluxmpi_tpu_torch.models import MLP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not fluxmpi_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluxmpi_tpu_torch.init()
    assert not fluxmpi_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MLP()
    ds = fluxmpi_tpu_torch.ArrayDataset(np.zeros((8, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluxmpi_tpu_torch.DistributedDataLoader(ds, global_batch_size=4)
    loader = fluxmpi_tpu_torch.DistributedDataLoader(ds, global_batch_size=4,
                                                     device="cpu")
    assert next(iter(loader)).device.type == "cpu"


def test_zoo_entry_points_refuse_missing_cuda(monkeypatch):
    """The slice-6 models and the schedule default to the card, and refuse
    its absence unless the caller names the CPU."""
    from fluxmpi_tpu_torch.models import (EncoderBlock, TransformerEncoder, UNet, ViT,
                                          cosine_beta_schedule)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(
        ViT=lambda **kw: ViT(num_classes=2, patch=4, num_layers=1, d_model=8, num_heads=2,
                             d_ff=8, image_size=8, **kw),
        UNet=lambda **kw: UNet(base_channels=8, channel_mults=(1,), groups=4,
                               image_size=8, **kw),
        TransformerEncoder=lambda **kw: TransformerEncoder(1, 8, 2, 8, **kw),
        EncoderBlock=lambda **kw: EncoderBlock(8, 2, 8, 0.0, torch.float32, **kw),
        cosine_beta_schedule=lambda **kw: cosine_beta_schedule(10, **kw))
    for name, make in small.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        out = make(device="cpu")
        where = out.device if torch.is_tensor(out) else next(out.parameters()).device
        assert where.type == "cpu", name


def test_waiting_options_raise_instead_of_being_ignored():
    from fluxmpi_tpu_torch.parallel import make_eval_step, make_train_step, train_loop

    # Ported in the layout slice: meshes, plans and the step's layout
    # arguments, with the JAX package's errors.
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        fluxmpi_tpu_torch.init(device="cpu", mesh_shape={"dp": 2})
    assert not fluxmpi_tpu_torch.is_initialized()
    with pytest.raises(ValueError, match="must be a ParallelConfig"):
        make_train_step(lambda p, s, b: (None, s), None, parallel=True)
    with pytest.raises(ValueError, match="require style='auto'"):
        make_train_step(lambda p, s, b: (None, s), None, style="shard_map",
                        batch_spec=("dp",))
    with pytest.raises(ValueError, match="style must be"):
        make_train_step(lambda p, s, b: (None, s), None, style="pjit")
    # Ported in the run-health slice: the model stats built into the step.
    step = make_train_step(lambda p, s, b: (None, s), None, model_stats=True)
    assert step.__fluxmpi_window_meta__["aux"] == ("loss", "grad_norm", "model_stats")
    from fluxmpi_tpu_torch.parallel.sharding import Mesh

    make_eval_step(lambda p, s, b: None, mesh=Mesh([0], ("dp",)))
    # Ported in the telemetry slice: metrics= on the step and the loop.
    make_train_step(lambda p, s, b: (None, s), None, metrics=True)
    assert train_loop(lambda s, b: (s, b), None, [], metrics=True)[1]["updates"] == 0
    # Ported since: fuse="window" gives the JAX package's reasons.
    with pytest.raises(ValueError, match="not a DistributedDataLoader"):
        train_loop(lambda s, b: (s, b), None, [], fuse="window")
    # Ported in the mixed-precision, fault-tolerant slice: accepted now.
    from fluxmpi_tpu_torch.utils import get_policy

    make_train_step(lambda p, s, b: (None, s), None, remat=True,
                    policy=get_policy("bf16"))
    make_eval_step(lambda p, s, b: None, policy=get_policy("bf16"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on a GPU host
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
