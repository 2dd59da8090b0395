"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks for
    the CPU. Raises when a CUDA device is asked for and none is present; the
    port never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
