"""Launcher of the tiled FC product shared by the int8 (K4) and codebook4
(K5) kernels (``csrc/fc_tile.cuh``): validates the operands, sizes the
split of K and calls the kernel's C entry point."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

BN, BK = 64, 64                # output channels / K depth of a tile (.cuh)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def launch(lib: str, x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
           n: int, bias: Optional[torch.Tensor],
           activation: Optional[str]) -> torch.Tensor:
    """act(x [M, K] @ W.T (+ bias)) -> [M, n] f32 through
    ``csrc/<lib>.cu``'s ``<lib>_launch``; ``w`` holds the compressed
    weights and ``aux`` their scales (K4) or centroids (K5)."""
    m, k = x.shape
    dev = x.device
    if activation not in ref.ACT_CODES:
        raise ValueError(f"unknown fused activation {activation!r}")
    if x.dtype != torch.float32 or aux.dtype != torch.float32:
        raise TypeError(f"{lib} takes f32 x and f32 scales / centroids")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (n,)):
        raise ValueError(f"{lib}: bias must be f32 [{n}]")
    for t in (x, w, aux) + (() if bias is None else (bias,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{lib} operands must be contiguous and on one "
                             "device")
    # split K until the card has ~2 blocks per SM, keeping >= 4 tiles of K
    # per split
    rows = 8 if m <= 8 else 32
    steps = cdiv(k, BK)
    ksplit = max(1, min(cdiv(2 * build.sm_count(dev),
                             cdiv(n, BN) * cdiv(m, rows)), cdiv(steps, 4)))
    per_split = cdiv(steps, ksplit)
    ksplit = cdiv(steps, per_split)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((ksplit * m * n if ksplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    fn = getattr(build.library(lib), f"{lib}_launch")
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 6 + [ctypes.c_int] * 6 + [ptr]
        fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), w.data_ptr(), aux.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                part.data_ptr(), m, n, k, ksplit, per_split * BK,
                ref.ACT_CODES[activation],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, lib)
    return out
