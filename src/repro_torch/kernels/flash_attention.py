"""Blockwise (flash) self-attention, forward (K7) and recompute backward
(K8: dq, and dk / dv summed over the query group), in hand-written CUDA
(``csrc/flash_attention.cu``).

Each wrapper launches its kernel for tensors on the card and takes its
plain version (``kernels.ref.flash_attention_*_ref``, the same arithmetic
untiled) for tensors on the CPU.  q [B, H, T, D], k / v [B, Hkv, T, D],
bf16 or f32; everything the kernels write is f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_KINDS = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 80, 96, 128, 256)


def _opts(q, window, softcap, scale):
    """Validated (window, scale): window None or >= 1 (every row keeps its
    own key, which the kernels' tile skipping relies on)."""
    if window is not None and int(window) < 1:
        raise ValueError(f"flash attention window must be None or >= 1, "
                         f"got {window}")
    if softcap is not None and softcap == 0:
        raise ValueError("softcap must be None or non-zero")
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    return (None if window is None else int(window)), scale


def _check(q, k, v, *rest):
    """Geometry, types and placement the kernels take; raises otherwise."""
    b, h, t, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[2] != t or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes bf16 or f32 q / k / v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    for x in (q, k, v, *rest):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("flash attention operands must be contiguous "
                             "and on one device")
    if rest:
        do, lse, delta = rest
        if do.shape != q.shape or lse.shape != (b, h, t, 1) or \
                delta.shape != (b, h, t, 1):
            raise ValueError("do must be shaped as q, lse and delta "
                             "[B, H, T, 1]")
        if any(x.dtype != torch.float32 for x in rest):
            raise TypeError("do, lse and delta must be f32")


def _fn(name: str, n_ptr: int):
    fn = getattr(build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _tail(q, k, causal, window, softcap, scale):
    """The launchers' trailing arguments after the pointers."""
    b, h, t, d = q.shape
    return (_KINDS[q.dtype], b, h, k.shape[1], t, d, int(bool(causal)),
            -1 if window is None else window, scale,
            0.0 if softcap is None else float(softcap),
            int(softcap is not None),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """-> (o [B, H, T, D] f32, lse [B, H, T, 1] f32).  A CUDA tensor
    launches K7 (or raises); a CPU tensor takes the plain version."""
    window, scale = _opts(q, window, softcap, scale)
    if q.device.type == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, causal, window, softcap,
                                           scale)
    _check(q, k, v)
    b, h, t, d = q.shape
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    status = _fn("flash_attention_fwd_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_tail(q, k, causal, window, softcap, scale))
    build.check(status, "flash_attention_fwd_launch")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dq [B, H, T, D] f32 from do (f32), lse and delta [B, H, T, 1].  A
    CUDA tensor launches K8's dq kernel (or raises); a CPU tensor takes the
    plain version."""
    window, scale = _opts(q, window, softcap, scale)
    if q.device.type == "cpu":
        return ref.flash_attention_dq_ref(q, k, v, do, lse, delta, causal,
                                          window, softcap, scale)
    _check(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    status = _fn("flash_attention_dq_launch", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_tail(q, k, causal, window, softcap, scale))
    build.check(status, "flash_attention_dq_launch")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """(dk, dv) [B, Hkv, T, D] f32, each summed over the query group.  A
    CUDA tensor launches K8's dkv kernel (or raises); a CPU tensor takes
    the plain version."""
    window, scale = _opts(q, window, softcap, scale)
    if q.device.type == "cpu":
        return ref.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal,
                                           window, softcap, scale)
    _check(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    status = _fn("flash_attention_dkv_launch", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, causal, window, softcap, scale))
    build.check(status, "flash_attention_dkv_launch")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """-> (dq, dk, dv) f32, with ``delta = rowsum(do * o)`` taken outside
    the kernels as in the JAX package."""
    do = do.float().contiguous()
    delta = (do * o.float()).sum(dim=-1, keepdim=True)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, **kw))


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
