"""Launcher of the FC product shared by the int8 (K4) and codebook4 (K5)
kernels (``csrc/fc_tile.cuh``): validates the operands, plans the split of
K and calls the kernel's C entry point (one launch a call)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

BN, BK = 64, 128           # channels of a group, k of a stage (.cuh)
#: blocks a split plan aims at per SM (at most; the grid is one wave)
BLOCKS_PER_SM = 2
#: the compression mode of each library, as the tuner keys it
_MODES = {"int8_matmul": "int8", "lut_matmul": "codebook4"}


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def tile_rows(m: int) -> int:
    """Rows of x a block takes for an M-row call (the .cuh's MR)."""
    return 8 if m <= 8 else 32


def plan_of(k: int, ksplit: int) -> Tuple[Tuple[int, int], ...]:
    """The K ranges of a split into at most ``ksplit`` parts: whole stages
    of BK from k 0, equal but the last, none empty."""
    steps = cdiv(k, BK)
    per = cdiv(steps, max(1, min(steps, ksplit))) * BK
    return tuple((k0, min(k, k0 + per)) for k0 in range(0, k, per))


def split_plan(n: int, k: int, sms: int) -> Tuple[Tuple[int, int], ...]:
    """The K ranges ``[k0, k1)`` a block of BN output channels sums on its
    own, in the order the kernel adds their partials: whole stages of BK
    from k 0, equal but the last, none empty, as many as keep
    ``ceil(n / BN)`` channel tiles within BLOCKS_PER_SM blocks an SM.  No
    row count enters, so a row's sum order, and bits, are the same alone
    or among others.  This is the untuned plan: :func:`launch_plan` takes
    a tuned geometry's winner instead."""
    return aimed_plan(n, k, sms, BLOCKS_PER_SM)


def aimed_plan(n: int, k: int, sms: int,
               blocks_per_sm: int) -> Tuple[Tuple[int, int], ...]:
    """:func:`split_plan` aimed at ``blocks_per_sm`` blocks an SM (the
    tuner's candidates)."""
    if n < 1 or k < 1 or sms < 1:
        raise ValueError(f"split_plan: n={n}, k={k}, sms={sms}")
    return plan_of(k, max(1, blocks_per_sm * sms // cdiv(n, BN)))


def launch_plan(n: int, k: int, sms: int, split_n: Optional[int] = None,
                mode: Optional[str] = None) -> Tuple[Tuple[int, int], ...]:
    """The K ranges a launch of ``n`` channels runs: its own plan, or on a
    band of a larger matrix that of the whole's ``split_n`` channels, so
    the band's rows sum in the whole's order, bit for bit.  With ``mode``
    ("int8" / "codebook4"), a geometry the tuner has a winner for
    (`kernels.tune`, keyed without the row count) runs the winner's
    ksplit, any other :func:`split_plan`."""
    if split_n is not None and split_n < n:
        raise ValueError(f"split_n {split_n} is below the band's {n} "
                         "channels")
    whole = split_n or n
    if mode is not None:
        from repro_torch.kernels import tune
        choice = tune.lookup(tune.fc_key(mode, whole, k, sms))
        if choice is not None and choice.tile("ksplit") is not None:
            return plan_of(k, choice.tile("ksplit"))
    return split_plan(whole, k, sms)


def launch(lib: str, x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
           n: int, bias: Optional[torch.Tensor],
           activation: Optional[str],
           split_n: Optional[int] = None) -> torch.Tensor:
    """act(x [M, K] @ W.T (+ bias)) -> [M, n] f32 through
    ``csrc/<lib>.cu``'s ``<lib>_launch``; ``w`` holds the compressed
    weights and ``aux`` their scales (K4) or centroids (K5).  ``split_n``:
    on a band of output channels, the whole matrix's channel count, whose
    K split the band follows (so its rows get the whole's bits)."""
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
    plan = launch_plan(n, k, build.sm_count(dev), split_n,
                       _MODES[lib])
    ksplit, per = len(plan), cdiv(plan[0][1], BK) * BK
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((ksplit * m * n if ksplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cnt = build.counters(dev, stream, cdiv(n, BN) * cdiv(m, tile_rows(m)))
    fn = getattr(build.library(lib), f"{lib}_launch")
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 6 + [ptr]
        fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), w.data_ptr(), aux.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                part.data_ptr(), cnt.data_ptr(), m, n, k, ksplit, per,
                ref.ACT_CODES[activation], stream)
    build.check(status, lib)
    return out
