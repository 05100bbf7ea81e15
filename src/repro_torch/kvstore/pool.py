"""Paged KV page pool.

A shared set of fixed-size pages replaces the dense per-slot cache::

    k_pages / v_pages : [n_pages, Hkv, page_size, Dh]   bf16 (or int8)
    k_scale / v_scale : [n_pages, Hkv]                  f32 (int8 mode only)

plus one per-sequence page table ``[B, n_pages_per_seq] int32`` shared by
every layer.  Token ``t`` of sequence ``b`` lives at
``(page_table[b, t // page_size], t % page_size)``, so the table index is
the absolute position.  Page 0 is the write sink: unallocated entries
(-1) read and write it.

The JAX package's ``update`` returns a new pool; here the decode state
owns its pools and :func:`update` writes them in place (the counterpart
of the donated decode state in the JAX session), returning the same pool.
:func:`copy_pages` moves pages between two pools of one geometry (the
disaggregated roles' page migration), in place too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

#: table entry meaning "no page allocated here"
NO_PAGE = -1
#: page id reserved as the write sink for unallocated/inactive slots
GARBAGE_PAGE = 0


class PagedKV(NamedTuple):
    """One layer's share of the page pool (stacked: [L] in front)."""
    k_pages: torch.Tensor                   # [n_pages, Hkv, ps, Dh]
    v_pages: torch.Tensor                   # [n_pages, Hkv, ps, Dh]
    k_scale: Optional[torch.Tensor] = None  # [n_pages, Hkv] f32 (int8 mode)
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return int(self.k_pages.shape[-2])

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[-4])

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> "PagedKV":
        """View of layer ``i`` of a stacked pool (writes go through)."""
        return PagedKV(*(None if a is None else a[i] for a in self))


def init_pool(n_pages: int, n_kv: int, page_size: int, d_head: int,
              kv_dtype: str = "int8", n_layers: Optional[int] = None,
              device=None) -> PagedKV:
    """A fresh pool (``n_layers`` stacks [L] in front).  ``kv_dtype``:
    "int8" (quantized) or "bf16" (exact)."""
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (n_pages, n_kv, page_size, d_head)
    if kv_dtype == "int8":
        return PagedKV(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(lead + (n_pages, n_kv), dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(lead + (n_pages, n_kv), dtype=torch.float32,
                                device=device))
    if kv_dtype == "bf16":
        return PagedKV(
            k_pages=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            v_pages=torch.zeros(shape, dtype=torch.bfloat16, device=device))
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                     "choose 'int8' or 'bf16'")


def init_table(batch: int, max_len: int, page_size: int,
               device=None) -> torch.Tensor:
    """Empty per-sequence page table [B, n_pages_per_seq]."""
    npp = -(-max_len // page_size)
    return torch.full((batch, npp), NO_PAGE, dtype=torch.int32,
                      device=device)


def _quantize(new: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``new`` [..., Dh] against scales ``s`` [...]: round
    half to even, clip to +-127, 0 where the scale is 0."""
    codes = torch.where(s[..., None] > 0,
                        new / torch.clamp(s[..., None], min=1e-30), 0.0)
    return torch.clamp(torch.round(codes), -127, 127).to(torch.int8)


def _segment_max(scale: torch.Tensor, safe: torch.Tensor,
                 amax: torch.Tensor) -> torch.Tensor:
    """``scale`` [n_pages, Hkv] grown to the largest ``amax`` [B, C, Hkv]
    landing on each page (duplicate page ids are well defined: max is
    order-free)."""
    hkv = scale.shape[1]
    return scale.scatter_reduce(0, safe.reshape(-1, 1).expand(-1, hkv),
                                amax.reshape(-1, hkv), reduce="amax")


def update_chunk(pool: PagedKV, table: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, positions: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> PagedKV:
    """Write a whole chunk's k/v ([B, Hkv, C, Dh]) at absolute positions
    ``positions`` [B, C] through the page table, in place, with one
    scatter per chunk.

    ``valid`` [B, C] bool sends padding tokens to the garbage page, as in
    :func:`update`.  bf16 pages get exactly the values a token-by-token
    scan would write.  int8 pages keep the two-speed semantics at chunk
    granularity: each page's scale grows to the largest amax among the
    chunk tokens landing on it (segment max); only a genuine growth pays
    the requantize, which first rescales each written page's codes by a
    page-level ratio (so duplicate page ids write identical pages), then
    lands the chunk's codes quantised against the final scale.  The
    growth check is read on the host, as the JAX package's ``lax.cond``
    takes it."""
    ps = pool.page_size
    npp = table.shape[1]
    pos = positions.long()
    pi = torch.clamp(pos // ps, 0, npp - 1)               # [B, C]
    slot = pos % ps
    page = torch.gather(table.long(), 1, pi)              # [B, C]
    if valid is not None:
        page = torch.where(valid, page, NO_PAGE)
    safe = torch.clamp(page, min=GARBAGE_PAGE)
    # token-major [B, C, Hkv, Dh], the shape of the scatter index
    kf = k_new.float().transpose(1, 2)
    vf = v_new.float().transpose(1, 2)
    if not pool.quantized:
        dt = pool.k_pages.dtype
        pool.k_pages[safe, :, slot] = kf.to(dt)
        pool.v_pages[safe, :, slot] = vf.to(dt)
        return pool
    k_amax = kf.abs().amax(dim=-1) / 127.0                # [B, C, Hkv]
    v_amax = vf.abs().amax(dim=-1) / 127.0
    if valid is not None:
        k_amax = torch.where(valid[..., None], k_amax, 0.0)
        v_amax = torch.where(valid[..., None], v_amax, 0.0)
    old_ks = pool.k_scale[safe]                           # [B, C, Hkv]
    old_vs = pool.v_scale[safe]
    grow = bool(((k_amax > old_ks) | (v_amax > old_vs)).any())
    if not grow:
        pool.k_pages[safe, :, slot] = _quantize(kf, old_ks)
        pool.v_pages[safe, :, slot] = _quantize(vf, old_vs)
        return pool
    for pages, scale, old_s, amax, xf in (
            (pool.k_pages, pool.k_scale, old_ks, k_amax, kf),
            (pool.v_pages, pool.v_scale, old_vs, v_amax, vf)):
        new_full = _segment_max(scale, safe, amax)
        new_s = new_full[safe]                            # [B, C, Hkv]
        ratio = torch.where(new_s > 0,
                            old_s / torch.clamp(new_s, min=1e-30), 0.0)
        pg = torch.round(pages[safe].float() * ratio[..., None, None])
        pages[safe] = pg.to(torch.int8)
        pages[safe, :, slot] = _quantize(xf, new_s)
        scale.copy_(new_full)
    return pool


def update(pool: PagedKV, table: torch.Tensor, k_new: torch.Tensor,
           v_new: torch.Tensor, cur_pos: torch.Tensor,
           valid: Optional[torch.Tensor] = None) -> PagedKV:
    """Write one token's k/v ([B, Hkv, Dh]) at absolute position
    ``cur_pos`` [B] through the page table, in place: the chunk write at
    C = 1.  ``valid`` [B] bool (optional) redirects invalid rows to the
    garbage page, and their amax never grows a scale.  On every real page
    (one writer each) this is the JAX package's per-token ``update``,
    two-speed int8 included."""
    return update_chunk(pool, table, k_new[:, :, None], v_new[:, :, None],
                        cur_pos[:, None],
                        None if valid is None else valid[:, None])


def attention_mask(table: torch.Tensor, cur_pos: torch.Tensor,
                   window: int, page_size: int) -> torch.Tensor:
    """[B, npp*ps] bool: positions a query at cur_pos may attend to.
    Table index is absolute position; window < 0 means full causal."""
    b, npp = table.shape
    pos = torch.arange(npp * page_size, device=table.device)[None, :]
    alloc = torch.repeat_interleave(table >= 0, page_size, dim=1)
    cur = cur_pos.long()[:, None]
    ok = alloc & (pos <= cur)
    if window < 0:
        return ok
    return ok & (pos > cur - window)


def chunk_attention_mask(table: torch.Tensor, q_pos: torch.Tensor,
                         window: int, page_size: int) -> torch.Tensor:
    """[B, C, npp*ps] bool: positions each of C chunk queries (at absolute
    positions ``q_pos`` [B, C]) may attend to.  The chunk's keys are
    written before it attends, so plain causality over table-index
    positions covers the in-chunk keys too."""
    b, npp = table.shape
    pos = torch.arange(npp * page_size, device=table.device)[None, None, :]
    alloc = torch.repeat_interleave(table >= 0, page_size, dim=1)[:, None, :]
    cur = q_pos.long()[:, :, None]
    ok = alloc & (pos <= cur)
    if window < 0:
        return ok
    return ok & (pos > cur - window)


# ---------------------------------------------------------- cross-pool copy
def _page_axis(leaf: torch.Tensor) -> int:
    """Page axis of a pool leaf: 0 for a single layer's [n_pages, ...]
    tensors, 1 for the stacked [L, n_pages, ...] serving layout."""
    return leaf.dim() - 4 if leaf.dim() >= 4 else leaf.dim() - 2


def copy_pages(src: PagedKV, dst: PagedKV, src_ids, dst_ids
               ) -> Tuple[PagedKV, int]:
    """Copy pages ``src_ids`` of ``src`` into pages ``dst_ids`` of ``dst``
    (another pool of the same geometry) and return ``(dst, bytes)``.

    The payload moves verbatim: bf16 pages bit for bit, int8 pages their
    codes *and* per-page scales with no requantization.  Single-layer
    pools and the stacked [L, n_pages, ...] serving layout alike.  Unlike
    the JAX package's functional update, ``dst``'s tensors are written in
    place (``index_select`` from the source, ``index_copy_`` into the
    destination, on the pools' device: nothing passes through the host)
    and the same pool object is returned; both pools live on one device.
    ``bytes`` counts the source rows read, as the JAX package's
    ``copy_pages`` does."""
    if src.page_size != dst.page_size or \
            src.k_pages.shape[-2:] != dst.k_pages.shape[-2:] or \
            src.quantized != dst.quantized:
        raise ValueError(
            f"pool geometry mismatch: src {tuple(src.k_pages.shape)} "
            f"({src.k_pages.dtype}) vs dst {tuple(dst.k_pages.shape)} "
            f"({dst.k_pages.dtype})")
    if len(src_ids) != len(dst_ids):
        raise ValueError(f"{len(src_ids)} source pages for "
                         f"{len(dst_ids)} destinations")
    if not len(src_ids):
        return dst, 0
    dev = dst.k_pages.device
    si = torch.tensor(src_ids, dtype=torch.long, device=dev)
    di = torch.tensor(dst_ids, dtype=torch.long, device=dev)
    moved = 0
    for s, d in zip(src, dst):
        if s is None:
            continue
        ax = _page_axis(s)
        block = s.index_select(ax, si)
        moved += block.numel() * block.element_size()
        d.index_copy_(ax, di, block)
    return dst, moved
