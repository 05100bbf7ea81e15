"""Paged attention: page-table gather, inline dequant and online softmax in
hand-written CUDA (``csrc/paged_attention.cu``), for one decode query per
sequence (K2) or a chunk of C queries at their own positions (K3).

:func:`paged_attention` and :func:`paged_attention_chunk` launch their
kernel for tensors on the card and take the plain version
(``kernels.ref.paged_attention_ref`` / ``paged_attention_chunk_ref``,
the same arithmetic with whole-tensor ops) for tensors on the CPU.  One
kernel serves both (decode is its C = 1 case), and every query follows
its own :func:`split_plan`, so a query's bits never depend on the batch
or the chunk it is in.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kvstore.pool import PagedKV

NEG_INF = ref.NEG_INF
_Q_KINDS = {torch.bfloat16: 0, torch.float32: 1}
_PAGE_KINDS = {torch.bfloat16: 0, torch.int8: 1}
MAX_ROWS = 32                  # query rows of one block: G * qt
#: head dims the kernel takes: whole m16n8k16 depth steps, up to 256
HEAD_DIMS = tuple(range(16, 257, 16))
#: keys of one range of the untuned split plan (the CUDA source's
#: ``RANGE`` template parameter)
RANGE_KEYS = 256
#: the ranges the kernel is built for (a library each), today's first
RANGES = (RANGE_KEYS,) + tuple(r for r in build.PAGED_RANGES
                               if r != RANGE_KEYS)


def query_tile(chunk: int, group: int) -> int:
    """Queries per block: the largest divisor of ``chunk`` whose
    ``group * qt`` query rows fit one block."""
    return max(d for d in range(1, chunk + 1)
               if chunk % d == 0 and d * group <= MAX_ROWS)


def split_plan(n_pages: int, page_size: int) -> Tuple[Tuple[int, int], ...]:
    """The key ranges ``[k0, k1)`` the kernel cuts a row into, a row being
    one query that visits pages 0 .. ``n_pages`` - 1 (its live pages: up
    to the page holding its position, clamped to the table, at least page
    0): RANGE_KEYS keys each from key 0, the last one ending with the row.
    A block takes one range of a query tile (a row of one range is written
    at once; a longer row's ranges are merged in this order).  The plan is
    the row's alone: no batch, chunk, table width or SM count enters it,
    so a query gets the same bits decoded alone, among other rows or in a
    chunk.  This is the untuned plan; a geometry the tuner has a winner
    for cuts its rows by :func:`ranges_of` at the winner's range."""
    return ranges_of(n_pages, page_size, RANGE_KEYS)


def ranges_of(n_pages: int, page_size: int,
              range_keys: int) -> Tuple[Tuple[int, int], ...]:
    """:func:`split_plan` at ``range_keys`` keys a range."""
    n_keys = n_pages * page_size
    return tuple((k0, min(k0 + range_keys, n_keys))
                 for k0 in range(0, n_keys, range_keys))


def launch_plan(h: int, hkv: int, dh: int, c: int, page_size: int,
                quantized: bool, sms: int,
                split_hkv: Optional[int] = None) -> Tuple[int, int]:
    """(range_keys, qt) a launch runs: the tuned range of the attention
    geometry (one key for K2 and K3, with no batch, chunk or table width,
    so a query's split is its own) and K3's tuned query tile at this
    chunk width, else RANGE_KEYS and :func:`query_tile`.  ``split_hkv``:
    on a band of kv heads, the whole's kv-head count, whose choice the
    band takes (so its queries get the whole launch's bits)."""
    from repro_torch.kernels import tune
    group = h // hkv
    whole = split_hkv or hkv
    rng = tune.lookup(tune.paged_key(whole, group, dh, page_size, quantized,
                                     sms))
    rng = RANGE_KEYS if rng is None else rng.tile("range", RANGE_KEYS)
    qt = query_tile(c, group)
    if c > 1:
        got = tune.lookup(tune.paged_chunk_key(whole, group, dh, page_size,
                                               c, quantized, sms))
        qt = qt if got is None else got.tile("qt", qt)
    return rng, qt


def _check(q: torch.Tensor, pool: PagedKV, table: torch.Tensor,
           q_pos: torch.Tensor) -> None:
    """What the CUDA kernel takes; raises on anything else.  q [B, H, C,
    Dh], q_pos [B, C]."""
    if q.dim() != 4 or pool.k_pages.dim() != 4:
        raise ValueError(f"paged attention takes q [B, H, C, Dh] and pages "
                         f"[n_pages, Hkv, ps, Dh], got {tuple(q.shape)}, "
                         f"{tuple(pool.k_pages.shape)}")
    b, h, c, dh = q.shape
    n_pages, hkv, ps, pdh = pool.k_pages.shape
    if q.dtype not in _Q_KINDS or pool.k_pages.dtype not in _PAGE_KINDS \
            or pool.v_pages.dtype != pool.k_pages.dtype:
        raise TypeError(f"paged attention takes bf16/f32 q and bf16/int8 "
                        f"pages, got {q.dtype}, {pool.k_pages.dtype}, "
                        f"{pool.v_pages.dtype}")
    if pool.v_pages.shape != pool.k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if pdh != dh or dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} (pages {pdh}): the kernel takes a "
                         "multiple of 16 up to 256")
    if h % hkv or h // hkv > MAX_ROWS:
        raise ValueError(f"{h} query heads over {hkv} kv heads: the group "
                         f"must divide and be at most {MAX_ROWS}")
    if table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("table and positions must be int32")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1 or \
            tuple(q_pos.shape) != (b, c):
        raise ValueError("table / positions do not match q")
    if pool.quantized and any(
            s is None or s.dtype != torch.float32 or
            tuple(s.shape) != (n_pages, hkv)
            for s in (pool.k_scale, pool.v_scale)):
        raise TypeError("int8 pages need f32 scales [n_pages, Hkv]")
    tensors = [q, table, q_pos, *(t for t in pool if t is not None)]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous "
                             "and on one device")
    if any(t.data_ptr() % 16 for t in (q, pool.k_pages, pool.v_pages)):
        raise ValueError("paged attention copies q and pages in 16-byte "
                         "pieces: they must be 16-byte aligned")


def _launch(q: torch.Tensor, pool: PagedKV, table: torch.Tensor,
            q_pos: torch.Tensor, window: int, scale: float,
            cap: Optional[float],
            split_hkv: Optional[int] = None) -> torch.Tensor:
    """q [B, H, C, Dh], q_pos [B, C] -> [B, H, C, Dh] f32 through the
    kernel's C launcher (decode is its C = 1 case)."""
    _check(q, pool, table, q_pos)
    b, h, c, dh = q.shape
    _, hkv, ps, _ = pool.k_pages.shape
    npp = table.shape[1]
    dev = q.device
    rng, qt = launch_plan(h, hkv, dh, c, ps, pool.quantized,
                          build.sm_count(dev), split_hkv)
    fn = build.library(build.paged_library(rng)) \
        .paged_attention_chunk_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 10 + [ctypes.c_int] * 13 + \
            [ctypes.c_float, ctypes.c_float, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    # the grid covers the most ranges a row of this table can have; blocks
    # past a tile's own last range exit at once
    nrange = len(ranges_of(npp, ps, rng))
    tiles = b * hkv * (c // qt)
    out = torch.empty((b, h, c, dh), dtype=torch.float32, device=dev)
    part = torch.empty((b * h * c * nrange * (dh + 2) if nrange > 1 else 1,),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cnt = build.counters(dev, stream, tiles)
    quant = pool.quantized
    status = fn(q.data_ptr(), pool.k_pages.data_ptr(),
                pool.v_pages.data_ptr(),
                pool.k_scale.data_ptr() if quant else None,
                pool.v_scale.data_ptr() if quant else None,
                table.data_ptr(), q_pos.data_ptr(), part.data_ptr(),
                cnt.data_ptr(), out.data_ptr(), _Q_KINDS[q.dtype],
                _PAGE_KINDS[pool.k_pages.dtype], b, h, hkv, dh, c, qt, ps,
                npp, rng, nrange, int(window), float(scale),
                float(cap) if cap is not None else 0.0,
                int(cap is not None), stream)
    build.check(status, "paged_attention_chunk_launch")
    return out


def paged_attention(q: torch.Tensor, pool: PagedKV, table: torch.Tensor,
                    cur_pos: torch.Tensor, window: int, *,
                    scale: Optional[float] = None,
                    cap: Optional[float] = None,
                    split_hkv: Optional[int] = None) -> torch.Tensor:
    """q [B, H, Dh] against the paged pool -> [B, H, Dh] f32.  A CUDA
    tensor launches the kernel at C = 1 (or raises); a CPU tensor takes the
    plain version.  ``split_hkv``: see :func:`launch_plan`."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    window = int(window)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool.k_pages, pool.v_pages,
                                       pool.k_scale, pool.v_scale, table,
                                       cur_pos, window, scale, cap)
    out = _launch(q.contiguous()[:, :, None], pool, table,
                  cur_pos.reshape(-1, 1), window, scale, cap, split_hkv)
    paged_attention.launches += 1
    return out[:, :, 0]


def paged_attention_chunk(q: torch.Tensor, pool: PagedKV,
                          table: torch.Tensor, q_pos: torch.Tensor,
                          window: int, *, scale: Optional[float] = None,
                          cap: Optional[float] = None,
                          split_hkv: Optional[int] = None) -> torch.Tensor:
    """q [B, H, C, Dh] at absolute positions ``q_pos`` [B, C] against the
    paged pool -> [B, H, C, Dh] f32; each query is masked at its own
    position.  A CUDA tensor launches the chunk kernel (or raises); a CPU
    tensor takes the plain version.  ``split_hkv``: see
    :func:`launch_plan`."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    window = int(window)
    if q.device.type == "cpu":
        return ref.paged_attention_chunk_ref(q, pool.k_pages, pool.v_pages,
                                             pool.k_scale, pool.v_scale,
                                             table, q_pos, window, scale,
                                             cap)
    out = _launch(q.contiguous(), pool, table, q_pos.contiguous(), window,
                  scale, cap, split_hkv)
    paged_attention_chunk.launches += 1
    return out


paged_attention.launches = 0
paged_attention_chunk.launches = 0
