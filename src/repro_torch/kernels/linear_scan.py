"""RWKV6 (Finch) WKV scan, the recurrent serving hot path:

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    o_t = (S_{t-1} + diag(u) · k_t v_tᵀ)ᵀ r_t

:func:`rwkv6_scan` launches the hand-written CUDA kernel
``csrc/linear_scan.cu`` (K9) for tensors on the card, with the [Dk, Dv]
state held in registers for the whole sequence, and takes its plain
version :func:`repro_torch.kernels.ref.rwkv6_ref` for tensors on the CPU.
The kernel reads its operands through their strides (the model's head
views are not contiguous) and writes o in [B, T, H, Dv], returned as a
[B, H, T, Dv] view.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

MAX_DK = 128


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` with a contiguous last axis (other strides kept)."""
    x = x.to(dtype)
    return x if x.stride(-1) == 1 else x.contiguous()


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, w [B, H, T, Dk], v [B, H, T, Dv], u [H, Dk] -> o [B, H, T, Dv]
    f32.  A CUDA tensor launches K9 (or raises); a CPU tensor takes the
    plain version.  r, k and v are read in bf16 when all three are bf16,
    else in f32; w and u in f32.  The kernel has no backward: under
    autograd on the card it raises."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3] \
            or tuple(u.shape) != (h, dk):
        raise ValueError(f"rwkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)} do not fit")
    if r.device.type == "cpu":
        return ref.rwkv6_ref(r, k, v, w, u)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, w, u)):
        raise NotImplementedError(
            "rwkv6 on the card has a forward kernel only: training rwkv6 "
            "there waits for a WKV backward (ROADMAP queue 1, item 5)")
    if dk > MAX_DK:
        raise ValueError(f"the WKV kernel takes Dk <= {MAX_DK}, got {dk}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("rwkv6 operands must be on one device")
    o = torch.empty((b, t, h, dv), dtype=torch.float32, device=r.device)
    if o.numel() == 0:
        return o.permute(0, 2, 1, 3)
    kind = torch.bfloat16 if all(x.dtype == torch.bfloat16
                                 for x in (r, k, v)) else torch.float32
    r, k, v = (_operand(x, kind) for x in (r, k, v))
    w = _operand(w, torch.float32)
    u = u.to(torch.float32).contiguous()
    ov = o.permute(0, 2, 1, 3)                      # [B, H, T, Dv] view
    strides = [s for x in (r, k, v, w, ov) for s in x.stride()[:3]]
    fn = build.library("linear_scan").rwkv6_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), o.data_ptr(),
                (ctypes.c_longlong * len(strides))(*strides),
                0 if kind == torch.bfloat16 else 1, b, h, t, dk, dv,
                torch.cuda.current_stream(r.device).cuda_stream)
    build.check(status, "rwkv6_scan_launch")
    rwkv6_scan.launches += 1
    return ov


rwkv6_scan.launches = 0
