"""Gradient compression round trip (the port's copy of the JAX package's
``runtime/compression.roundtrip``): compress, then decompress, where the
cross-replica all-reduce would move the compressed payload.

  bf16 - cast the f32 grads to bf16 and back;
  int8 - per-chunk (2048 values) symmetric int8 with f32 scales.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map

CHUNK = 2048


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1).float()
    n = flat.numel()
    ch = torch.nn.functional.pad(flat, (0, (-n) % CHUNK)).reshape(-1, CHUNK)
    scale = ch.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(ch / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return (q.float() * scale).reshape(-1)[:n].reshape(g.shape)


def roundtrip(grads: Any, scheme: str) -> Any:
    """grads after compress -> decompress under ``scheme`` (bf16 | int8)."""
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
    if scheme == "int8":
        return tree_map(_int8_roundtrip, grads)
    raise ValueError(scheme)
