"""Symmetric per-output-channel int8 quantization (the int8 FC mode)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    """Per-output-channel int8 tensor: w ~ q * scale."""
    q: torch.Tensor         # int8 [n, k]
    scale: torch.Tensor     # f32 [n, 1]


def quantize_int(w: torch.Tensor) -> QTensor:
    """Symmetric int8 quantization of an [n, k] matrix, one scale per row;
    rounds half to even, as the JAX package's ``jnp.round``."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=1, keepdim=True), min=1e-8) / 127
    q = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize_int(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale
