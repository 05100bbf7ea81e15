"""Where the port runs: the card unless the caller names the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None -> the first card; raises when no card is visible (the port
    never falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run the plain versions")
        device = "cuda"
    return torch.device(device)
