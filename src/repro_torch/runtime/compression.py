"""Gradient compression for the data-parallel gradient exchange (the
port's copy of the JAX package's ``runtime/compression.py``).

Two schemes:

  bf16 - cast f32 grads to bf16 for the exchange (2x traffic cut),
  int8 - per-chunk (2048 values) symmetric int8 with f32 scales (about 4x
         cut) plus error feedback: the quantization residual is added back
         into the next step's gradient, keeping the optimizer unbiased over
         time.

On a data-parallel mesh (``train.trainer.make_train_step(mesh=)``) the
wire carries the compressed payload: each rank compresses (as
``roundtrip`` does, with no error feedback, so that one rank gives the
single-device bits and a resumed run the uninterrupted one's), the
payloads are all-gathered, and each rank decompresses every payload.  On
one device ``roundtrip`` stands where that exchange would be.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.optim.adamw import tree_map

CHUNK = 2048


def int8_encode(g: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = g.reshape(-1).float()
    ch = torch.nn.functional.pad(
        flat, (0, (-flat.numel()) % CHUNK)).reshape(-1, CHUNK)
    scale = ch.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(ch / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def int8_decode(enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (enc["q"].float() * enc["scale"]).reshape(-1)[:n].reshape(shape)


def _is_enc(x) -> bool:
    return isinstance(x, dict) and "q" in x


def payload_leaves(tree) -> list:
    """The int8 payloads ({"q", "scale"} dicts) of a compressed tree, in
    sorted-key order (the order of the grads' leaves)."""
    if _is_enc(tree):
        return [tree]
    return [e for k in sorted(tree) for e in payload_leaves(tree[k])]


def _map_enc(fn, tree):
    """``fn`` on every int8 payload ({"q", "scale"} dict) of ``tree``."""
    if _is_enc(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_enc(fn, v) for k, v in tree.items()}
    return fn(tree)


def compress_grads(grads: Any, scheme: str) -> Any:
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    if scheme == "int8":
        return tree_map(int8_encode, grads)
    raise ValueError(scheme)


def roundtrip(grads: Any, scheme: str) -> Any:
    """compress -> (the gradient exchange happens here) -> decompress."""
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
    if scheme == "int8":
        return tree_map(lambda g: int8_decode(int8_encode(g), g.shape), grads)
    raise ValueError(scheme)


def decompress_grads(payload: Any, scheme: str, shapes=None) -> Any:
    """The f32 grads of ``payload``.  An int8 payload decodes to its
    leaves' ``shapes`` (a tree like the grads', of shapes) where given,
    else to a ``"__shape__"`` the payload carries, else to the flat,
    chunk-padded values, as the JAX package's does."""
    if scheme == "bf16":
        return tree_map(lambda g: g.float(), payload)
    if scheme == "int8":
        if shapes is not None:
            return _zip_enc(lambda e, s: int8_decode(e, tuple(s)), payload,
                            shapes)
        return _map_enc(
            lambda e: int8_decode(e, e["__shape__"]) if "__shape__" in e
            else (e["q"].float() * e["scale"]).reshape(-1), payload)
    raise ValueError(scheme)


def _zip_enc(fn, payload, shapes):
    if _is_enc(payload):
        return fn(payload, shapes)
    return {k: _zip_enc(fn, v, shapes[k]) for k, v in payload.items()}


class ErrorFeedback:
    """Residual accumulator for biased compressors (int8)."""

    def __init__(self, params_template):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_template)

    def encode(self, grads):
        """The int8 payload of g + r; r becomes (g + r) - its decode."""
        gplus = _zip(torch.add, grads, self.residual)
        enc = tree_map(int8_encode, gplus)
        self.residual = _zip(
            lambda g, e: g - int8_decode(e, g.shape), gplus, enc)
        return enc

    def apply(self, grads):
        """g' = compress(g + r); r = (g + r) - decompress(g')."""
        return _zip(lambda g, e: int8_decode(e, g.shape), grads,
                    self.encode(grads))


def _zip(fn, a, b):
    """``fn`` leaf by leaf over two trees of one structure (``b`` may hold
    int8 payloads where ``a`` holds tensors)."""
    if isinstance(a, dict):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)
