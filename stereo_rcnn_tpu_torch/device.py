"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device`` (a CUDA device with its index);
    ``None`` means the CUDA card, and raises when there is none (pass
    ``device="cpu"`` to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
