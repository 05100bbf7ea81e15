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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
    """int8 codes of ``new`` [B, Hkv, Dh] against scales ``s`` [B, Hkv]:
    round half to even, clip to +-127, 0 where the scale is 0."""
    codes = torch.where(s[..., None] > 0,
                        new / torch.clamp(s[..., None], min=1e-30), 0.0)
    return torch.clamp(torch.round(codes), -127, 127).to(torch.int8)


def _write_page_rescale(pages, scale, new, new_s, safe_page, slot):
    """Slow path: grow the per-page scale, requantize the page's existing
    codes against it, and write the new token's codes at ``slot``.  Only
    the garbage page can see two writers."""
    b = new.shape[0]
    ps = pages.shape[2]
    old_s = scale[safe_page]                              # [B, Hkv]
    # ratio <= 1; a fresh page has old_s == 0, so stale codes are wiped
    ratio = torch.where(new_s > 0, old_s / torch.clamp(new_s, min=1e-30),
                        0.0)
    pg = pages[safe_page].float()                         # [B, Hkv, ps, Dh]
    pg = torch.round(pg * ratio[..., None, None])
    hot = (torch.arange(ps, device=pages.device)[None, :]
           == slot[:, None])                              # [B, ps]
    pg = torch.where(hot[:, None, :, None],
                     _quantize(new, new_s).float()[:, :, None, :], pg)
    pages[safe_page] = pg.to(torch.int8)
    scale[safe_page] = new_s


def update(pool: PagedKV, table: torch.Tensor, k_new: torch.Tensor,
           v_new: torch.Tensor, cur_pos: torch.Tensor) -> PagedKV:
    """Write one token's k/v ([B, Hkv, Dh]) at absolute position
    ``cur_pos`` [B] through the page table, in place.

    int8 mode is two-speed: when every page's scale already covers the new
    token, the write is a plain scatter of fresh codes; only a genuine
    scale growth pays the gather-requantize-scatter round trip.  The
    choice is read on the host, as the JAX package's ``lax.cond`` takes
    it."""
    ps = pool.page_size
    npp = table.shape[1]
    pi = torch.clamp(cur_pos.long() // ps, 0, npp - 1)
    slot = cur_pos.long() % ps
    page = table[torch.arange(table.shape[0], device=table.device), pi]
    safe = torch.clamp(page.long(), min=GARBAGE_PAGE)     # -1 -> sink page
    if not pool.quantized:
        dt = pool.k_pages.dtype
        pool.k_pages[safe, :, slot] = k_new.to(dt)
        pool.v_pages[safe, :, slot] = v_new.to(dt)
        return pool
    kf, vf = k_new.float(), v_new.float()
    k_amax = kf.abs().amax(dim=-1) / 127.0                # [B, Hkv]
    v_amax = vf.abs().amax(dim=-1) / 127.0
    old_ks = pool.k_scale[safe]
    old_vs = pool.v_scale[safe]
    new_ks = torch.maximum(old_ks, k_amax)
    new_vs = torch.maximum(old_vs, v_amax)
    grow = bool(((k_amax > old_ks) | (v_amax > old_vs)).any())
    if not grow:
        pool.k_pages[safe, :, slot] = _quantize(kf, old_ks)
        pool.v_pages[safe, :, slot] = _quantize(vf, old_vs)
        return pool
    _write_page_rescale(pool.k_pages, pool.k_scale, kf, new_ks, safe, slot)
    _write_page_rescale(pool.v_pages, pool.v_scale, vf, new_vs, safe, slot)
    return pool


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
