"""Codebook FCs, 4-bit weight codes two per byte, low nibble first.

* :func:`lut_matmul` — codes x real activations,
  ``act(x @ centroids[unpack4(codes)].T + bias)``: the hand-written CUDA
  kernel ``csrc/lut_matmul.cu`` (K5) for tensors on the card, its plain
  version :func:`lut_matmul_ref` for tensors on the CPU.
* :func:`lut_product_matmul` — codes x coded activations, every multiply a
  look-up in an nc x nc product table (AIDA's fully-coded mode): the
  kernel ``csrc/lut_product.cu`` (K6) on the card, its plain version
  :func:`repro_torch.kernels.ref.lut_product_matmul_ref` on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.codebook import unpack4
from repro_torch.kernels import build
from repro_torch.kernels import fc_tile
from repro_torch.kernels import ref


def lut_matmul_ref(x: torch.Tensor, codes_packed: torch.Tensor,
                   centroids: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None) -> torch.Tensor:
    """Plain version: the dense [N, K] weights materialised from the codes,
    an f32 product, plus the bias, then the activation.  x [M, K], codes
    [N, K/2] uint8, centroids [16] -> [M, N]."""
    w = centroids.float()[unpack4(codes_packed).long()]
    y = torch.matmul(x.float(), w.T)
    if bias is not None:
        y = y + bias.float()
    return ref.apply_activation(activation, y)


def lut_matmul(x: torch.Tensor, codes_packed: torch.Tensor,
               centroids: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               split_n: Optional[int] = None) -> torch.Tensor:
    """act(x [M, K] @ dequant(codes [N, K/2], centroids [16]).T + bias [N])
    -> [M, N] f32.  A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version.  ``split_n``: see `fc_tile.launch`."""
    n, kb = codes_packed.shape
    if codes_packed.dtype != torch.uint8 or x.shape[-1] != 2 * kb or \
            centroids.numel() != 16:
        raise ValueError(f"lut_matmul: x {tuple(x.shape)}, codes "
                         f"{tuple(codes_packed.shape)} "
                         f"{codes_packed.dtype}, centroids "
                         f"{tuple(centroids.shape)} do not fit")
    if x.device.type == "cpu":
        return lut_matmul_ref(x, codes_packed, centroids, bias, activation)
    out = fc_tile.launch("lut_matmul", x.float().contiguous(),
                         codes_packed.contiguous(),
                         centroids.float().contiguous(), n,
                         None if bias is None else bias.float().contiguous(),
                         activation, split_n)
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0


#: K6's geometry (``csrc/lut_product.cu``): output rows a block, weight
#: bytes a step (a K split is whole steps), x rows a block at most
K6_ROWS, K6_STEP, K6_XROWS = 512, 32, 32


def lut_product_plan(b: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(ksplit, steps a split) of K6: the row tiles times the x row groups
    fill the card's SMs once (a block an SM) or K is split in whole steps
    of K6_STEP weight bytes until they nearly do.  The sums are exact
    integers, so the plan changes no bit of the result."""
    steps = fc_tile.cdiv(k // 2, K6_STEP)
    blocks = fc_tile.cdiv(n, K6_ROWS) * fc_tile.cdiv(b, K6_XROWS)
    ksplit = max(1, min(steps, sms // blocks))
    per = fc_tile.cdiv(steps, ksplit)
    return fc_tile.cdiv(steps, per), per


def lut_product_matmul(x_codes: torch.Tensor, codes_packed: torch.Tensor,
                       lut: torch.Tensor) -> torch.Tensor:
    """out[b, n] = Σ_{k<K} lut[w[n, k], x[b, k]]: x_codes [B, K] uint8,
    codes_packed [N, K/2] uint8, lut [nc, nc] (nc <= 16, every code < nc)
    -> [B, N] f32, in the arithmetic of
    :func:`repro_torch.kernels.ref.lut_product_matmul_ref`.  A CUDA tensor
    launches K6 (or raises); a CPU tensor takes the plain version."""
    b, kdim = x_codes.shape
    n, kb = codes_packed.shape
    nc = lut.shape[0]
    if x_codes.dtype != torch.uint8 or codes_packed.dtype != torch.uint8 \
            or kdim != 2 * kb or lut.shape != (nc, nc) or not 1 <= nc <= 16:
        raise ValueError(f"lut_product_matmul: x codes {tuple(x_codes.shape)}"
                         f" {x_codes.dtype}, codes {tuple(codes_packed.shape)}"
                         f" {codes_packed.dtype}, lut {tuple(lut.shape)} do "
                         "not fit")
    if x_codes.device.type == "cpu":
        return ref.lut_product_matmul_ref(x_codes, codes_packed, lut)
    dev = x_codes.device
    if codes_packed.device != dev or lut.device != dev:
        raise ValueError("lut_product_matmul operands must be on one device")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if out.numel() == 0 or kdim == 0:
        return out.zero_()
    x_codes, codes_packed = x_codes.contiguous(), codes_packed.contiguous()
    lut = lut.to(torch.float32).contiguous()
    ksplit, per = lut_product_plan(b, n, kdim, build.sm_count(dev))
    # kept-zero scratch: a counter per (row tile, x row group), then the
    # splits' int64 sums [N, B] at an 8-byte offset
    tiles = fc_tile.cdiv(n, K6_ROWS) * fc_tile.cdiv(b, K6_XROWS)
    sums_at = 2 * fc_tile.cdiv(tiles, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = build.counters(dev, stream,
                             sums_at + 2 * n * b if ksplit > 1 else 1)
    fn = build.library("lut_product").lut_product_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    status = fn(x_codes.data_ptr(), codes_packed.data_ptr(), lut.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), b, n, kdim, nc, ksplit,
                per, 4 * sums_at, stream)
    build.check(status, "lut_product_launch")
    lut_product_matmul.launches += 1
    return out


lut_product_matmul.launches = 0
