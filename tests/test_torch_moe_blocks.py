"""The sequence-parallel pieces of the plan compositions in one process,
at small widths on the CPU, through the same functions ``chip_smoke.py``'s
``compose_phase`` runs on the card:

- the MoE layer's routing of sequence blocks (``models/moe.py``
  ``block_layout``, ``MoEMLP.route_block`` and ``choose_block``, the whole
  groups' router probabilities passed in as the sp path gathers them)
  against routing the whole sequence from the same probabilities: each
  block's dispatch and combine (expert choice: picks and gates) equal to
  the whole one's rows bit for bit, the output and balance loss within
  1e-5; for top-1, top-2 and expert choice, one group per row and
  ``n_groups`` that cut across the blocks unevenly (a block holding
  several runs of a group, and none of another);
- the dense ring with dropout (``parallel/ring.py`` ``_ring_dense``):
  every tick's keep mask the slice of the whole-sequence draw bit for bit,
  the output within 1e-6 of flax's dense attend with that mask.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from fluxmpi_tpu_torch.models import MoEMLP
from fluxmpi_tpu_torch.models._layers import dense_dropout_keep
from fluxmpi_tpu_torch.models.moe import block_layout
from fluxmpi_tpu_torch.ops.flash_attention import _draw_dropout_seed

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("routing", ["top1", "top2", "experts"])
@pytest.mark.parametrize("b,s,n,n_groups", [(3, 32, 4, None), (2, 24, 2, 3), (2, 32, 4, 4),
                                            (3, 20, 2, 5)])
def test_block_routing_equals_the_whole_sequence(routing, b, s, n, n_groups):
    kw = dict(routing="experts") if routing == "experts" else dict(top_k=int(routing[-1]))
    layer = MoEMLP(num_experts=4, d_ff=16, capacity_factor=1.0, n_groups=n_groups,
                   d_model=8, device="cpu", generator=torch.Generator().manual_seed(1), **kw)
    x = torch.randn((b, s, 8), generator=torch.Generator().manual_seed(2))
    got = chip_smoke.moe_blocks_against_whole(layer, x, n)
    assert got["equal"], got
    assert got["out_rel"] <= chip_smoke.COMPOSE_MOE_TOL, got
    assert got["aux_rel"] <= chip_smoke.COMPOSE_MOE_TOL, got


def test_uneven_group_layouts_pad_and_map_back():
    """``n_groups=5`` over 2 rows of 20 tokens in 2 blocks of 10: groups of
    8 tokens; block 0 (row 0's tokens 0-9, row 1's 20-29) holds 8, 2, 4, 6
    and 0 tokens of groups 0-4 (padded to 8), at their group positions,
    and maps each token back."""
    lay = block_layout(2, 10, 2, 0, 5, torch.device("cpu"))
    assert (lay.groups, lay.gs, lay.m, lay.regular) == (5, 8, 8, False)
    assert lay.valid.sum(1).tolist() == [8, 2, 4, 6, 0]
    assert lay.pos[1, :2].tolist() == [0, 1] and lay.pos[2, :4].tolist() == [4, 5, 6, 7]
    assert lay.pos[3, :6].tolist() == [0, 1, 2, 3, 4, 5]
    flat = lay.index.reshape(-1)[lay.back]
    assert flat.tolist() == list(range(20))
    assert block_layout(3, 8, 4, 2, None, torch.device("cpu")).regular


def test_dense_ring_dropout_drops_the_whole_sequence_mask():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 48, 2, 8), generator=g) for _ in range(3))
    seed = _draw_dropout_seed(torch.Generator().manual_seed(4))
    out, ticks = chip_smoke.dense_ring_dropout(q, k, v, 4, 0.25, seed)
    rows = torch.arange(48)
    whole = dense_dropout_keep(seed, rows, rows, 0.75)
    assert len(ticks) == 10
    assert all(torch.equal(keep, whole[qp][:, kp]) for qp, kp, keep in ticks)
    ref = chip_smoke.dense_dropout_reference(q, k, v, whole, 0.25, chunk=16)
    assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
