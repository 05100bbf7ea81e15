"""Shared-prefix page cache: prefill a common prompt prefix once.

Serving traffic is dominated by near-identical prompt heads (system
prompts, few-shot preambles).  Because the page-table index is the
absolute position and RoPE is applied at write time, a KV page written
for prompt positions [j*ps, (j+1)*ps) is a pure function of the prompt
tokens up to and including that page — so full prompt pages are
content-addressed by a chain hash over their token prefix and shared
across sequences: a new request whose prompt starts with a cached prefix
attaches the existing page ids into its page table (one `ref()` per
page, per `PageAllocator` refcounts) and starts prefilling after them.

Rules that keep sharing sound:

* only full pages of prompt tokens are ever cached — generated tokens
  depend on sampling, partial pages would be written into;
* a request reuses at most the pages strictly before its last prompt
  token (`usable_prefix_pages`): the final prompt token must be fed
  again to produce first-token logits, and its write must not land in a
  shared page;
* the cache holds its own reference on every cached page, so cached
  pages survive request completion; under pool pressure the Session
  releases cache pins LRU-first before preempting a live request.

The hashes are byte-identical to the JAX package's, so one prompt names
the same pages in both.
"""
from __future__ import annotations

import collections
import hashlib
from typing import List, Optional, Sequence


def page_hashes(prompt: Sequence[int], page_size: int) -> List[bytes]:
    """Chain hash per full prompt page: hashes[j] identifies prompt tokens
    [0, (j+1)*page_size) — page content depends on the whole prefix
    (attention is causal), so the chain, not the page's own tokens, is the
    identity."""
    out: List[bytes] = []
    h = hashlib.sha1(str(page_size).encode())
    for j in range(len(prompt) // page_size):
        for t in prompt[j * page_size:(j + 1) * page_size]:
            h.update(int(t).to_bytes(8, "little", signed=True))
        out.append(h.digest())
    return out


def usable_prefix_pages(prompt_len: int, page_size: int) -> int:
    """Pages a request may attach from the cache: full pages strictly
    before the last prompt token (which must be fed again — its logits
    seed generation — and must not write into a shared page)."""
    return max(0, (prompt_len - 1) // page_size)


class PrefixCache:
    """hash -> page id, LRU-ordered.  One refcount per cached page is held
    by the cache itself (the pin); attachments add their own through the
    allocator."""

    def __init__(self):
        self._entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserted = 0
        self.released = 0
        # observability seam: a ``(name, **args)`` emitter attached by the
        # owning Session; None = no events
        self.obs = None

    # ------------------------------------------------------------ queries
    @property
    def pages(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"pages": self.pages, "hits": self.hits,
                "misses": self.misses, "inserted": self.inserted,
                "released": self.released}

    def peek(self, h: bytes) -> Optional[int]:
        """Like lookup but with no LRU touch and no stats: admission
        planning."""
        return self._entries.get(h)

    def releasable(self, allocator, exclude=()) -> int:
        """Pages the cache could free right now if pressed: entries whose
        only owner left is the cache pin.  ``exclude`` masks pages the
        caller means to attach (they would gain an owner, not free up)."""
        ex = set(exclude)
        return sum(1 for pid in self._entries.values()
                   if allocator.refcount(pid) == 1 and pid not in ex)

    # --------------------------------------------------------------- ops
    def lookup(self, h: bytes) -> Optional[int]:
        """Page id for a prefix hash (LRU-touched), or None.  The caller
        must `allocator.ref()` the page before using it."""
        pid = self._entries.get(h)
        if pid is None:
            self.misses += 1
            return None
        self._entries.move_to_end(h)
        self.hits += 1
        if self.obs is not None:
            self.obs("prefix.hit", page=pid)
        return pid

    def insert(self, h: bytes, pid: int, allocator) -> bool:
        """Pin a freshly prefilled full prompt page.  First writer wins — a
        concurrent identical prefill keeps its own (identical) copy
        unshared rather than pinning a second id under the same hash."""
        if h in self._entries:
            return False
        allocator.ref(pid)
        self._entries[h] = pid
        self.inserted += 1
        if self.obs is not None:
            self.obs("prefix.pin", page=pid, pinned=len(self._entries))
        return True

    def release(self, allocator, n: int = 1) -> int:
        """Drop up to ``n`` LRU pins (pool pressure, or ``clear``).  Pages
        still referenced by live sequences stay resident until those free
        them; the cache entry is gone either way, so no stale lookups."""
        dropped = 0
        while self._entries and dropped < n:
            _, pid = self._entries.popitem(last=False)
            allocator.free([pid])
            dropped += 1
        self.released += dropped
        if self.obs is not None and dropped:
            self.obs("prefix.release", n=dropped,
                     pinned=len(self._entries))
        return dropped

    def clear(self, allocator) -> int:
        return self.release(allocator, len(self._entries))
