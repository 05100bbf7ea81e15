"""Attention with the flash kernels' gradient: the port's counterpart of
the JAX package's ``kernels/ops.attention`` and its ``custom_vjp``.

``impl="flash"`` runs K7 forward and K8 backward through a
``torch.autograd.Function``; ``impl="ref"`` is the plain masked softmax,
differentiated by autograd.  CPU tensors take the kernels' plain versions
inside the same function; nothing falls back from the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


class _Flash(torch.autograd.Function):
    """o = K7(q, k, v) cast to q's type; the backward casts do to f32,
    runs K8 and casts dq / dk / dv back to the input types."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        opts = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale)
        o, lse = fa.flash_attention_fwd(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do.float(),
                                            **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              impl: str = "flash") -> torch.Tensor:
    """Self-attention q [B, H, T, D] x k / v [B, Hkv, T, D] -> [B, H, T, D]
    in q's type (training / prefill)."""
    if impl == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale).to(q.dtype)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _Flash.apply(q, k, v, causal, window, softcap, scale)
