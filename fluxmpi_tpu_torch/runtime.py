"""Device resolution for the port's entry points.

The port runs on an NVIDIA GPU. Every entry point takes ``device=``; the
default is the first CUDA device, and the CPU is used only when the
caller names it. A machine without CUDA is an error unless the caller
asked for ``"cpu"``: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` → ``cuda:0``; ``"cpu"`` → the CPU; any CUDA
    device requires CUDA to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda", 0 if dev.index is None else dev.index)
