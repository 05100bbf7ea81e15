"""Paged attention: page-table gather, inline dequant and online softmax in
hand-written CUDA (``csrc/paged_attention.cu``), for one decode query per
sequence (K2) or a chunk of C queries at their own positions (K3).

:func:`paged_attention` and :func:`paged_attention_chunk` launch their
kernel for tensors on the card and take the plain version
(``kernels.ref.paged_attention_ref`` / ``paged_attention_chunk_ref``,
the same arithmetic with whole-tensor ops) for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kvstore.pool import PagedKV

NEG_INF = ref.NEG_INF
_Q_KINDS = {torch.bfloat16: 0, torch.float32: 1}
_PAGE_KINDS = {torch.bfloat16: 0, torch.int8: 1}
MAX_ROWS = 32                  # query rows (warps) of one block: G * qt


def query_tile(chunk: int, group: int) -> int:
    """Queries per block: the largest divisor of ``chunk`` whose
    ``group * qt`` query rows fit one block's warps."""
    return max(d for d in range(1, chunk + 1)
               if chunk % d == 0 and d * group <= MAX_ROWS)


def _launch(q: torch.Tensor, pool: PagedKV, table: torch.Tensor,
            q_pos: torch.Tensor, window: int, scale: float,
            cap: Optional[float]) -> torch.Tensor:
    """q [B, H, C, Dh], q_pos [B, C] -> [B, H, C, Dh] f32 through the
    chunk kernel's C launcher (decode is its C = 1 case)."""
    b, h, c, dh = q.shape
    _, hkv, ps, pdh = pool.k_pages.shape
    npp = table.shape[1]
    dev = q.device
    if q.dtype not in _Q_KINDS or pool.k_pages.dtype not in _PAGE_KINDS:
        raise TypeError(f"paged attention takes bf16/f32 q and bf16/int8 "
                        f"pages, got {q.dtype}, {pool.k_pages.dtype}")
    if pdh != dh or h % hkv or h // hkv > MAX_ROWS or \
            dh not in (32, 64, 128, 256):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)} pages "
                         f"{tuple(pool.k_pages.shape)}")
    qt = query_tile(c, h // hkv)
    if (2 * ps * dh + (h // hkv) * qt * ps) * 4 > 48 * 1024:
        raise ValueError(f"page of {ps} x {dh} exceeds the kernel's shared "
                         "memory")
    if table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("table and positions must be int32")
    if table.shape[0] != b or q_pos.shape != (b, c):
        raise ValueError("table / positions do not match q")
    tensors = [q, table, q_pos, *(t for t in pool if t is not None)]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous "
                             "and on one device")
    # split the page range until the card has ~2 blocks per SM (for C = 1
    # the same split as the decode kernel's, so the two agree bit for bit)
    blocks = b * hkv * (c // qt)
    nsplit = max(1, min(-(-2 * build.sm_count(dev) // blocks), npp))
    per_split = -(-npp // nsplit)
    nsplit = -(-npp // per_split)
    out = torch.empty((b, h, c, dh), dtype=torch.float32, device=dev)
    part = torch.empty((b * h * c * nsplit * (dh + 2) if nsplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    fn = build.library("paged_attention").paged_attention_chunk_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 9 + [ctypes.c_int] * 11 + \
            [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ptr]
        fn.restype = ctypes.c_int
    quant = pool.quantized
    status = fn(q.data_ptr(), pool.k_pages.data_ptr(),
                pool.v_pages.data_ptr(),
                pool.k_scale.data_ptr() if quant else None,
                pool.v_scale.data_ptr() if quant else None,
                table.data_ptr(), q_pos.data_ptr(), part.data_ptr(),
                out.data_ptr(), _Q_KINDS[q.dtype],
                _PAGE_KINDS[pool.k_pages.dtype], b, h, hkv, dh, c, qt, ps,
                npp, int(window), float(scale),
                float(cap) if cap is not None else 0.0,
                int(cap is not None), nsplit, per_split,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "paged_attention_chunk_launch")
    return out


def paged_attention(q: torch.Tensor, pool: PagedKV, table: torch.Tensor,
                    cur_pos: torch.Tensor, window: int, *,
                    scale: Optional[float] = None,
                    cap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Dh] against the paged pool -> [B, H, Dh] f32.  A CUDA
    tensor launches the kernel at C = 1 (or raises); a CPU tensor takes the
    plain version."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    window = int(window)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool.k_pages, pool.v_pages,
                                       pool.k_scale, pool.v_scale, table,
                                       cur_pos, window, scale, cap)
    out = _launch(q.contiguous()[:, :, None], pool, table,
                  cur_pos.reshape(-1, 1), window, scale, cap)
    paged_attention.launches += 1
    return out[:, :, 0]


def paged_attention_chunk(q: torch.Tensor, pool: PagedKV,
                          table: torch.Tensor, q_pos: torch.Tensor,
                          window: int, *, scale: Optional[float] = None,
                          cap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, C, Dh] at absolute positions ``q_pos`` [B, C] against the
    paged pool -> [B, H, C, Dh] f32; each query is masked at its own
    position.  A CUDA tensor launches the chunk kernel (or raises); a CPU
    tensor takes the plain version."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    window = int(window)
    if q.device.type == "cpu":
        return ref.paged_attention_chunk_ref(q, pool.k_pages, pool.v_pages,
                                             pool.k_scale, pool.v_scale,
                                             table, q_pos, window, scale,
                                             cap)
    out = _launch(q.contiguous(), pool, table, q_pos.contiguous(), window,
                  scale, cap)
    paged_attention_chunk.launches += 1
    return out


paged_attention.launches = 0
paged_attention_chunk.launches = 0
