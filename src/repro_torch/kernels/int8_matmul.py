"""int8-weight FC: ``act(x @ (q * scale).T + bias)`` with the per-output-
channel scale applied after the accumulate.

:func:`int8_matmul` launches the hand-written CUDA kernel
``csrc/int8_matmul.cu`` (K4) for tensors on the card and takes its plain
version :func:`int8_matmul_ref` for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fc_tile
from repro_torch.kernels import ref


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """Plain version: f32 ``x @ q.T``, times the scale, plus the bias, then
    the activation.  x [M, K], q [N, K] int8, scale [N, 1] -> [M, N]."""
    y = torch.matmul(x.float(), q.float().T) * scale.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float()
    return ref.apply_activation(activation, y)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                split_n: Optional[int] = None) -> torch.Tensor:
    """act(x [M, K] @ (q [N, K] int8 * scale [N, 1]).T + bias [N]) ->
    [M, N] f32.  A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version.  ``split_n``: see `fc_tile.launch`."""
    n, k = q.shape
    if q.dtype != torch.int8 or x.shape[-1] != k or scale.numel() != n:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)} {q.dtype}, scale "
                         f"{tuple(scale.shape)} do not fit")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale, bias, activation)
    out = fc_tile.launch("int8_matmul", x.float().contiguous(),
                         q.contiguous(), scale.float().contiguous(), n,
                         None if bias is None else bias.float().contiguous(),
                         activation, split_n)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
