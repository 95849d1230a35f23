"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking
for CUDA where there is none raises: nothing falls back to the CPU
silently, so a number produced on the CPU can never pass for a card's.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` is taken only when
    asked for by name.  Raises ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev
