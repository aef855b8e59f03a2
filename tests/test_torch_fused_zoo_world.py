"""ViT and the DDPM UNet fused across workers: a tiny ViT (embedding
dropout and kernel-path attention dropout from one CPU generator) and a
tiny UNet (``ddpm_loss``'s timesteps and noise from one CPU generator)
through ``train_loop(fuse="window")`` beside ``fuse=False`` in a 2-rank
gloo world of ``tests/_torch_zoo_world_worker.py`` (``fused``), on the
CPU, where a window runs eagerly (on the cards each window is one CUDA
graph a card: ``chip_smoke.py``'s multi-card ``vit``/``unet`` cases). Every
parameter and adam moment and every flush bit for bit on every rank, the
fused run in windows of 2."""

from pathlib import Path

import pytest

from _torch_worlds import join_world, start_world

WORKER = Path(__file__).resolve().parent / "_torch_zoo_world_worker.py"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return join_world(*start_world("fused", tmp_path_factory.mktemp("zoo_fused"), 2, "-",
                                   worker=WORKER))


@pytest.mark.parametrize("kind", ["vit", "unet"])
def test_zoo_fused_across_workers_bit_identical_to_pipelined(ranks, kind):
    for res in ranks:
        assert int(res[f"{kind}/same"]) == int(res[f"{kind}/leaves"]) > 0
        assert bool(res[f"{kind}/flushes_equal"])
        # 32 images, 8 a global batch: 4 updates an epoch, 2 epochs.
        assert int(res[f"{kind}/updates_window"]) == int(res[f"{kind}/updates_False"]) == 8
        assert int(res[f"{kind}/fused_window_window"]) == 2
        assert int(res[f"{kind}/dispatches_window"]) == 4
        assert int(res[f"{kind}/fused_window_False"]) == 0
