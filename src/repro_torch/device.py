"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA where no card is visible
    raises: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but no CUDA card is visible; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
