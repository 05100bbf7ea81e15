"""Magnitude pruning for the ACSR/AIDA compressors."""
from __future__ import annotations

import torch


def prune_topk(dense: torch.Tensor, density: float) -> torch.Tensor:
    """Magnitude pruning to a target density (Deep-Compression style):
    keep every entry with |w| >= the k-th largest |w|, k = round(density
    * size)."""
    k = max(1, int(round(density * dense.numel())))
    mag = dense.abs()
    thresh = torch.kthvalue(mag.reshape(-1), dense.numel() - k + 1).values
    return dense * (mag >= thresh)
