"""FLOPs and MFU accounting for the live training loop (counterpart of
:mod:`fluxmpi_tpu.utils.flops`).

The peak table holds NVIDIA cards, looked up by the name
``torch.cuda.get_device_name`` gives. FLOPs per update are counted once,
at a step's first dispatch, by :func:`count_flops`: PyTorch's
``FlopCounterMode`` counts the matrix products it sees (``mm``,
``addmm``, ``bmm``, convolutions, SDPA), and the hand-written attention
kernels, which it cannot see into, report their own count through
:func:`kernel_flops`: the JAX package's ``pallas_kernel_cost`` for the
same kernels, the grid times the kernel body's matrix products, with no
tile skipped (a causal kernel skips tiles; the count does not, so the
MFU never treats attention as cheaper than the JAX package does).

Nothing here imports CUDA state at module scope.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

__all__ = [
    "PEAK_FLOPS",
    "chip_peak_flops",
    "count_flops",
    "kernel_flops",
    "mfu",
]

# Peak dense bf16 FLOP/s per card by device-name substring; first match
# wins. "H100 80GB HBM3" is the SXM part (the name nvidia-smi and
# torch.cuda.get_device_name give it): 989.4e12, NVIDIA's H100 datasheet
# figure for BF16 Tensor Core without sparsity. A spec-sheet peak, not a
# measurement.
PEAK_FLOPS: tuple[tuple[str, float], ...] = (
    ("h100 80gb hbm3", 989.4e12),
)


def chip_peak_flops(device_kind: str) -> float | None:
    """Peak bf16 FLOP/s for a card name, or None when unknown (the CPU,
    cards not in the table)."""
    kind = device_kind.lower()
    for sub, peak in PEAK_FLOPS:
        if sub in kind:
            return peak
    return None


def mfu(
    flops_per_step: float | None,
    rate: float,
    n_dev: int,
    device_kind: str | None = None,
    *,
    peak: float | None = None,
) -> float | None:
    """Model FLOPs utilization per card: FLOPs/step × steps/sec ÷
    (cards × peak), rounded to 4 places.

    Returns None when the FLOPs count or the peak is unknown (``peak``
    overrides the ``device_kind`` table lookup). The raw value is
    returned even when it exceeds 1.0 — an impossible number means a
    broken clock or FLOPs count, and the caller decides what to do with
    it."""
    if not flops_per_step:
        return None
    if peak is None:
        if device_kind is None:
            return None
        peak = chip_peak_flops(device_kind)
    if peak is None or peak <= 0 or n_dev < 1:
        return None
    return round(flops_per_step * rate / (n_dev * peak), 4)


class _Count:
    """What one :func:`count_flops` block counted: ``total`` (all FLOPs),
    ``kernels`` (the hand-written kernels' share, by kernel name)."""

    def __init__(self) -> None:
        self.kernels: dict[str, float] = {}
        self.total = 0.0


# The count_flops blocks open now (a kernel adds its FLOPs to each).
_open: list[_Count] = []


@contextlib.contextmanager
def count_flops() -> Iterator[_Count]:
    """Count the FLOPs of the work run inside the block; the result is
    the yielded object's ``total``, read after the block::

        with count_flops() as c:
            state, loss = step(state, batch)
        flops_per_update = c.total

    The block runs under ``torch.utils.flop_counter.FlopCounterMode``
    (forward and backward matrix products) and collects what the
    hand-written kernels report through :func:`kernel_flops`. It counts;
    it does not change what runs. Call it once, outside the hot loop."""
    from torch.utils.flop_counter import FlopCounterMode

    count = _Count()
    mode = FlopCounterMode(display=False)
    _open.append(count)
    try:
        with mode:
            yield count
    finally:
        _open.remove(count)
    count.total = float(mode.get_total_flops()) + sum(count.kernels.values())


@contextlib.contextmanager
def kernel_flops(name: str, flops: float) -> Iterator[None]:
    """Wrap one hand-written kernel's launch (or, on the CPU, its plain
    version): inside a :func:`count_flops` block, the kernel's ``flops``
    are added under ``name`` and the work inside is hidden from the FLOP
    counter, which would otherwise count the plain version's matrix
    products instead of the kernel's. Outside one, a list check."""
    if not _open:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    for count in _open:
        count.kernels[name] = count.kernels.get(name, 0.0) + float(flops)
    with _disable_current_modes():
        yield


def attention_flops(q: Any, k: Any) -> dict[str, float]:
    """The three attention kernels' FLOPs for queries ``q`` ``[b, sq, h,
    d]`` against keys ``k`` ``[b, sk, h_kv, d]``: the JAX package's
    ``pallas_kernel_cost`` of its forward, dQ and dK/dV kernels (grid ×
    body matrix products: 2, 3 and 4 products of ``2·bq·bk·d`` per tile,
    over ``b·h·(sq/bq)·(sk/bk)`` tiles)."""
    b, sq, h, d = (int(x) for x in q.shape)
    unit = 2.0 * b * h * sq * int(k.shape[1]) * d
    return {"flash_fwd": 2 * unit, "flash_bwd_dq": 3 * unit,
            "flash_bwd_dkv": 4 * unit}
