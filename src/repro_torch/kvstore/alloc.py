"""Host-side page allocator — ties pool pages to the serving lifecycle.

Pure bookkeeping: the Session allocates a page when a sequence's position
crosses a page boundary, frees the sequence's pages when its request
completes, is preempted or its slot is reset, and (where every layer is
windowed) frees pages that slid wholly behind the window.  Page 0 is
never handed out — it is the write sink for inactive slots (see
pool.GARBAGE_PAGE).

Pages are refcounted so the shared-prefix cache (sched.prefix) can hand
one physical page to several sequences at once: ``alloc()`` returns a
page at refcount 1, ``ref()`` adds an owner, and ``free()`` drops one —
the page returns to the free list only when its last owner lets go.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.kvstore.pool import GARBAGE_PAGE


class OutOfPages(RuntimeError):
    """The pool is exhausted — raise rather than corrupt a live page."""


class PageAllocator:
    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the garbage sink)")
        self.n_pages = n_pages
        # LIFO free list, ascending hand-out order
        self._free: List[int] = list(range(n_pages - 1, GARBAGE_PAGE, -1))
        self._used: set = set()
        self._ref: Dict[int, int] = {}
        self.peak = 0
        self.total_allocs = 0
        # pages held back from admission: the fault-injection seam of the
        # resilience layer (a page-spike plan sets it each tick; else 0)
        self.holdback = 0
        # observability seam: a ``(name, **args)`` emitter attached by the
        # owning Session when tracing is on; None = no events
        self.obs: Optional[Callable] = None

    # ------------------------------------------------------------- queries
    @property
    def in_use(self) -> int:
        """Distinct pages with at least one owner (sharing counts once)."""
        return len(self._used)

    @property
    def available(self) -> int:
        return max(0, len(self._free) - self.holdback)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    # --------------------------------------------------------------- ops
    def _exhausted(self, want: str = "") -> OutOfPages:
        held = f", {self.holdback} held back" if self.holdback else ""
        return OutOfPages(
            f"page pool exhausted ({self.n_pages} pages, {self.in_use} in "
            f"use{held}{want}) — grow kv_pool_pages or finish requests "
            "faster")

    def alloc(self) -> int:
        if self.available <= 0:
            raise self._exhausted()
        pid = self._free.pop()
        self._used.add(pid)
        self._ref[pid] = 1
        self.total_allocs += 1
        self.peak = max(self.peak, self.in_use)
        if self.obs is not None:
            self.obs("alloc.pages", n=1, in_use=self.in_use)
        return pid

    def alloc_many(self, n: int) -> List[int]:
        """Allocate ``n`` pages atomically: all of them (refcount 1 each)
        or none (`OutOfPages`)."""
        if n < 0:
            raise ValueError(f"alloc_many wants n >= 0, got {n}")
        if self.available < n:
            raise self._exhausted(f", {n} requested")
        return [self.alloc() for _ in range(n)]

    def ref(self, pid: int) -> int:
        """Add an owner to a live page (prefix sharing); returns the new
        refcount.  Refusing to resurrect a freed page keeps double-free
        bugs loud instead of silently aliasing."""
        if pid not in self._used:
            raise ValueError(f"ref() on page {pid} which is not allocated")
        self._ref[pid] += 1
        return self._ref[pid]

    def free(self, pages: Iterable[int]) -> None:
        """Drop one owner per listed page; a page with owners left stays
        resident.  Unallocated ids are skipped (a slot reset may follow a
        request-completion free)."""
        freed = 0
        for pid in pages:
            if pid == GARBAGE_PAGE or pid < 0 or pid not in self._used:
                continue
            self._ref[pid] -= 1
            if self._ref[pid] > 0:
                continue                  # another owner (shared prefix)
            del self._ref[pid]
            self._used.remove(pid)
            self._free.append(pid)
            freed += 1
        if self.obs is not None and freed:
            self.obs("alloc.free", n=freed, in_use=self.in_use)


def reclaimable_prefix(cur_pos: int, window: int, page_size: int) -> int:
    """How many leading table entries of a sequence at ``cur_pos`` lie
    wholly behind a ``window``-wide SWA mask (the mask keeps pos > cur_pos
    - window, so a page is dead once its last slot <= cur_pos - window).
    Safe to free: later steps only move cur_pos forward."""
    if window <= 0:
        return 0
    dead_below = cur_pos - window + 1     # positions below are masked out
    return max(0, dead_below // page_size)
