"""Codebook4-weight FC: ``act(x @ centroids[unpack4(codes)].T + bias)``,
4-bit codes two per byte, low nibble first.

:func:`lut_matmul` launches the hand-written CUDA kernel
``csrc/lut_matmul.cu`` (K5) for tensors on the card and takes its plain
version :func:`lut_matmul_ref` for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codebook import unpack4
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
               activation: Optional[str] = None) -> torch.Tensor:
    """act(x [M, K] @ dequant(codes [N, K/2], centroids [16]).T + bias [N])
    -> [M, N] f32.  A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version."""
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
                         activation)
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0
