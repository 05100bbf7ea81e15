"""Codebook weight sharing: 1-D k-means, nearest-centroid codes and 4-bit
packing (two codes per byte, low nibble first)."""
from __future__ import annotations

from typing import Tuple

import torch

#: elements per nearest-centroid pass: bounds the [n, k] distance tensor
#: (a 14336 x 4096 matrix would otherwise need 3.8 GB of it)
ASSIGN_CHUNK = 1 << 22


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid code of every element (the first centroid wins a
    tie); uint8 [x.shape].  Runs in chunks of ``ASSIGN_CHUNK`` elements,
    which changes nothing in the result.  Where the centroids rise
    strictly by gaps far above f32 rounding (:func:`_bracketing`), each
    element is held against the two centroids that bracket it only: any
    other is farther by a whole gap, more than the rounding of either
    distance, so the code is the argmin's, bit for bit, from a few
    elementwise passes instead of a distance to every centroid."""
    flat = x.reshape(-1).float()
    cents = centroids.float()
    codes = torch.empty(flat.shape, dtype=torch.uint8, device=flat.device)
    bracket = _bracketing(flat, cents)
    for i in range(0, flat.numel(), ASSIGN_CHUNK):
        part = flat[i:i + ASSIGN_CHUNK]
        if bracket:
            pos = torch.searchsorted(cents, part)   # first c >= x
            lo = torch.clamp(pos - 1, min=0)
            hi = torch.clamp(pos, max=cents.numel() - 1)
            near = (part - cents[lo]).abs() <= (part - cents[hi]).abs()
            codes[i:i + ASSIGN_CHUNK] = torch.where(near, lo, hi).to(
                torch.uint8)
        else:
            codes[i:i + ASSIGN_CHUNK] = (part[:, None] - cents[None, :]) \
                .abs().argmin(dim=1).to(torch.uint8)
    return codes.reshape(x.shape)


def _bracketing(flat: torch.Tensor, cents: torch.Tensor) -> bool:
    """Whether every gap between consecutive centroids exceeds 2**-16 of
    M, the largest magnitude among the elements and centroids.  An f32
    distance |x - c| <= 2M is off by at most M * 2**-23, so a centroid
    farther than another by a gap of more than M * 2**-22 stays farther
    in f32: the argmin lies between the two centroids around x."""
    if cents.numel() < 2 or flat.numel() == 0:
        return False
    m = torch.maximum(flat.abs().max(), cents.abs().max())
    return bool(((cents[1:] - cents[:-1]) > m * 2.0 ** -16).all())


def counts(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [k]: how many of ``codes`` (each < k) hold each value — what
    ``torch.bincount(codes, minlength=k)`` gives, as sums of compares in
    chunks of ``ASSIGN_CHUNK``: exact, and on the card far faster than
    bincount's atomic adds into a few bins."""
    flat = codes.reshape(-1)
    ar = torch.arange(k, dtype=flat.dtype, device=flat.device)
    out = torch.zeros(k, dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), ASSIGN_CHUNK):
        out += (flat[i:i + ASSIGN_CHUNK, None] == ar).sum(dim=0)
    return out


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
        cnts = counts(assign(xs, cents), k)
        ends = torch.cumsum(cnts, 0)
        sums = prefix[ends] - prefix[ends - cnts]
        cents = torch.where(cnts > 0,
                            (sums / torch.clamp(cnts, min=1)).float(), cents)
    return torch.sort(cents).values


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes two per byte along the last axis (even length),
    the even position in the low nibble."""
    if codes.shape[-1] % 2:
        raise ValueError("the last axis must be even to pack")
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4`; doubles the last axis."""
    out = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize(w: torch.Tensor, k: int = 16,
             iters: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster a weight tensor to a k-entry codebook (k <= 16); returns the
    sorted centroids [k] f32 and the codes packed 4 bits each along the last
    axis."""
    if k > 16:
        raise ValueError("packing takes 4-bit codes (k <= 16)")
    cents = kmeans_1d(w, k=k, iters=iters)
    return cents, pack4(assign(w, cents))
