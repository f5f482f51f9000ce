"""Device selection for the port's entry points.

The trainer, the driver and the merge run on the GPU unless the caller
passes ``device="cpu"``; with no GPU and no explicit CPU request they
raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raising when there is none);
    anything else → ``torch.device(device)``, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port's entry points run on "
                "the GPU by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
