"""KV caches: full (one slot per position up to the session's max length)
and ring (``window`` slots, for stacks whose every layer is windowed).

A sliding-window layer never needs more than ``window`` entries, so its
ring cache is O(window), not O(sequence).  Stored entries carry their
absolute positions and masks are computed from positions, so RoPE applied
at write time stays consistent (scores depend only on position deltas).

Updates write the cache in place (as the paged pool's do), by one of the
JAX package's two strategies: ``scatter`` (the default) writes the token
into its slot, ``select`` rewrites the whole cache through a one-hot
``torch.where``; both give the same cache bit for bit.  The default comes
from ``REPRO_KV_UPDATE`` (`api.env`), resolved once at import.  A stacked
cache ([L, B, ...]) is indexed a layer at a time with
:meth:`KVCache.layer`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.api import env

#: update strategy when ``update`` is given none (``REPRO_KV_UPDATE``)
KV_UPDATE_DEFAULT = env.KV_UPDATE


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, Hkv, S_slots, Dh] bf16 (stacked: [L, ...])
    v: torch.Tensor        # [B, Hkv, S_slots, Dh]
    pos: torch.Tensor      # [B, S_slots] int32 absolute position, -1 = empty

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views."""
        return KVCache(self.k[i], self.v[i], self.pos[i])


def init_cache(batch: int, n_kv: int, slots: int, d_head: int,
               n_layers=None, device=None) -> KVCache:
    """An empty bf16 cache (``n_layers`` stacks [L] in front)."""
    lead = () if n_layers is None else (n_layers,)
    return KVCache(
        k=torch.zeros(lead + (batch, n_kv, slots, d_head),
                      dtype=torch.bfloat16, device=device),
        v=torch.zeros(lead + (batch, n_kv, slots, d_head),
                      dtype=torch.bfloat16, device=device),
        pos=torch.full(lead + (batch, slots), -1, dtype=torch.int32,
                       device=device))


def update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           cur_pos: torch.Tensor, ring: bool = False,
           strategy: Optional[str] = None) -> KVCache:
    """Insert one token's k / v ([B, Hkv, 1, Dh]) at absolute positions
    ``cur_pos`` [B], in place.  A full cache drops a write past its last
    slot, as the JAX package's scatter does (an idle session slot keeps
    counting positions): under ``scatter`` its slot index is clamped and it
    writes back the value already there, so no host sync decides which
    rows write; under ``select`` no slot is hot.  ``strategy``: "select",
    or anything else for scatter, as in the JAX package (None:
    ``KV_UPDATE_DEFAULT``)."""
    strategy = KV_UPDATE_DEFAULT if strategy is None else strategy
    slots = cache.k.shape[2]
    cur = cur_pos.long()
    if strategy == "select":
        slot = cur % slots if ring else cur
        hot = torch.arange(slots, device=cur.device)[None] == slot[:, None]
        for dst, new in ((cache.k, k_new), (cache.v, v_new)):
            dst.copy_(torch.where(hot[:, None, :, None], new.to(dst.dtype),
                                  dst))
        cache.pos.copy_(torch.where(hot, cur_pos.to(torch.int32)[:, None],
                                    cache.pos))
        return cache
    slot = cur % slots if ring else torch.clamp(cur, max=slots - 1)
    bidx = torch.arange(cache.k.shape[0], device=cache.k.device)
    keep = None if ring else cur >= slots
    for dst, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new[:, :, 0].to(dst.dtype)                  # [B, Hkv, Dh]
        if keep is not None:
            new = torch.where(keep[:, None, None], dst[bidx, :, slot], new)
        dst[bidx, :, slot] = new
    new_pos = cur_pos.to(torch.int32)
    if keep is not None:
        new_pos = torch.where(keep, cache.pos[bidx, slot], new_pos)
    cache.pos[bidx, slot] = new_pos
    return cache


def prefill(cache: KVCache, k_seq: torch.Tensor, v_seq: torch.Tensor,
            lengths: torch.Tensor) -> KVCache:
    """Bulk-load a [B, Hkv, T, Dh] prefix (T <= slots; non-ring only), in
    place; positions past a row's length read as empty."""
    t = k_seq.shape[2]
    cache.k[:, :, :t] = k_seq.to(cache.k.dtype)
    cache.v[:, :, :t] = v_seq.to(cache.v.dtype)
    ar = torch.arange(t, dtype=torch.int32, device=cache.pos.device)[None]
    cache.pos[:, :t] = torch.where(ar < lengths[:, None], ar,
                                   torch.full_like(ar, -1))
    return cache


def attention_mask(cache: KVCache, cur_pos: torch.Tensor,
                   window: int) -> torch.Tensor:
    """[B, S_slots] bool: which slots a query at ``cur_pos`` may attend to.
    ``window`` < 0 means unbounded (full causal)."""
    p = cache.pos
    ok = (p >= 0) & (p <= cur_pos[:, None])
    if window < 0:
        return ok
    return ok & (p > cur_pos[:, None] - window)
