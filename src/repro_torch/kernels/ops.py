"""Public kernel API of the port, the counterpart of the JAX package's
``kernels/ops.py``: attention with the flash kernels' gradient, the RWKV6
recurrence and the fully-coded LUT product.

``attention(impl="flash")`` runs K7 forward and K8 backward through a
``torch.autograd.Function``; ``impl="ref"`` is the plain masked softmax,
differentiated by autograd.  ``rwkv6`` runs K9 and ``lut_product_matmul``
K6.  CPU tensors take the kernels' plain versions inside the same
functions; nothing falls back from the card.  The Mamba scan and the two
decode steps have no kernel in the JAX package (a ``lax.scan`` and plain
``jnp``), so they are plain tensor ops here on every device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import lut_matmul as lm
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


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, *, impl: str = "scan",
          chunk: int = 64) -> torch.Tensor:
    """RWKV6 WKV over a whole sequence: r, k, w [B, H, T, Dk], v [B, H, T,
    Dv], u [H, Dk] -> o [B, H, T, Dv] f32.

    The JAX package's two routes, ``impl="scan"`` (its differentiable
    ``lax.scan``) and ``impl="kernel"`` (its Pallas kernel, which steps T
    in chunks and asserts that ``chunk`` divides T), have one counterpart
    here: CPU tensors take the plain sequential version, differentiable
    by autograd; CUDA tensors launch K9, which takes any T and has no
    backward (it raises under autograd).  ``impl="kernel"`` keeps the
    reference's contract and raises where its kernel asserts."""
    if impl not in ("scan", "kernel"):
        raise ValueError(f"unknown rwkv6 impl {impl!r}")
    t = r.shape[2]
    if impl == "kernel" and t and t % min(chunk, t):
        raise ValueError(f"rwkv6 impl='kernel' steps T in chunks of "
                         f"min({chunk}, T): T = {t} is not a multiple")
    return ls.rwkv6_scan(r, k, v, w, u)


def rwkv6_decode_step(S: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """One WKV token: S [B, H, Dk, Dv]; r, k, w [B, H, Dk]; v [B, H, Dv] ->
    (S', o [B, H, Dv]), plain tensor ops as in the JAX package."""
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhkv,bhk->bhv", S + u[None, :, :, None] * kv, r)
    return w[..., :, None] * S + kv, o


def mamba(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Selective SSM over a whole sequence (differentiable): x, dt [B, T,
    D], A [D, N], B, C [B, T, N] -> y [B, T, D] f32."""
    return ref.mamba_ref(x, dt, A, B, C)


def mamba_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                      A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One SSM token: h [B, D, N]; x, dt [B, D]; B, C [B, N] -> (h', y
    [B, D])."""
    decay = torch.exp(dt[..., None] * A[None])            # [B, D, N]
    h = decay * h + (dt * x)[..., None] * B[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, C)


def lut_product_matmul(x_codes: torch.Tensor, codes_packed: torch.Tensor,
                       lut: torch.Tensor) -> torch.Tensor:
    """Fully-coded FC through an nc x nc product table: x_codes [B, K]
    uint8, codes_packed [N, K/2] uint8, lut [nc, nc] -> [B, N] f32 (K6 on
    the card).  The reference's tile sizes (bm, bn, bk) are not carried
    over: the kernel fixes its own, and tiling changes no result."""
    return lm.lut_product_matmul(x_codes, codes_packed, lut)
