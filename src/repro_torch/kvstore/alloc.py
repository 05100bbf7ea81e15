"""Host-side page allocator — ties pool pages to the serving lifecycle.

Pure bookkeeping: the Session allocates a page when a sequence's position
crosses a page boundary and frees the sequence's pages when its request
completes, is preempted or its slot is reset.  Page 0 is never handed out
— it is the write sink for inactive slots (see pool.GARBAGE_PAGE).  The
reference's refcounts serve its prefix cache, which lands with a later
slice of the port.
"""
from __future__ import annotations

from typing import Iterable, List

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
        self.peak = 0
        self.total_allocs = 0

    @property
    def in_use(self) -> int:
        return len(self._used)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(
                f"page pool exhausted ({self.n_pages} pages, "
                f"{self.in_use} in use) — grow kv_pool_pages or "
                "finish requests faster")
        pid = self._free.pop()
        self._used.add(pid)
        self.total_allocs += 1
        self.peak = max(self.peak, self.in_use)
        return pid

    def free(self, pages: Iterable[int]) -> None:
        """Return pages to the pool; unallocated ids are skipped (a slot
        reset may follow a request-completion free)."""
        for pid in pages:
            if pid in self._used:
                self._used.remove(pid)
                self._free.append(pid)


def reclaimable_prefix(cur_pos: int, window: int, page_size: int) -> int:
    """How many leading table entries of a sequence at ``cur_pos`` lie
    wholly behind a ``window``-wide SWA mask (the mask keeps pos > cur_pos
    - window, so a page is dead once its last slot <= cur_pos - window).
    Safe to free: later steps only move cur_pos forward."""
    if window <= 0:
        return 0
    dead_below = cur_pos - window + 1     # positions below are masked out
    return max(0, dead_below // page_size)
