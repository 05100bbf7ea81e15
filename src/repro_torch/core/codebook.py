"""Codebook weight sharing: 1-D k-means over a layer's nonzeros."""
from __future__ import annotations

import torch


def kmeans_1d(x: torch.Tensor, k: int = 16, iters: int = 25) -> torch.Tensor:
    """Lloyd's k-means on a flat array; returns sorted centroids [k] f32.

    Linear initialisation between min and max, ``iters`` Lloyd steps; a
    centroid with no members keeps its place; ties go to the lower
    centroid.  In one dimension with sorted centroids every cluster is a
    contiguous range of the sorted data (and the centroids stay sorted),
    so cluster sums are differences of one f64 prefix sum: no scatter-add,
    whose atomics would make the result vary from run to run on the card.
    """
    xs = torch.sort(x.reshape(-1).float()).values
    prefix = torch.cat([xs.new_zeros(1, dtype=torch.float64),
                        torch.cumsum(xs.double(), 0)])
    lo, hi = xs[0], xs[-1]
    cents = lo + (hi - lo) * (torch.arange(k, dtype=torch.float32,
                                           device=xs.device) + 0.5) / k
    for _ in range(iters):
        assign = (xs[:, None] - cents[None, :]).abs().argmin(dim=1)
        cnts = torch.bincount(assign, minlength=k)
        ends = torch.cumsum(cnts, 0)
        sums = prefix[ends] - prefix[ends - cnts]
        cents = torch.where(cnts > 0,
                            (sums / torch.clamp(cnts, min=1)).float(), cents)
    return torch.sort(cents).values
