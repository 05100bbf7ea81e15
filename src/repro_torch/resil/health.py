"""Health auditing: allocator/slot invariant checks and a watchdog.

The audits are exact, not heuristic — every page in a session's pool
must be accounted for by slot page-table references, prefix-cache pins,
or externally held refs (in-flight disagg handoffs). Any discrepancy is
a leak or a double-free in the making, so the watchdog surfaces it as a
:class:`HealthError` rather than a counter that nobody reads.

The watchdog also powers wedged-role recovery in the disagg
orchestrator: the orchestrator tracks consecutive faulted steps per
role and, past ``wedge_ticks``, drains the role's slots back through the
retry path (see ``disagg.session``); this module only owns the audit
cadence and the invariant checks themselves.  The session side it reads
is host bookkeeping only (the allocator, the host mirror of the page
table, the prefix cache's pins): an audit never reads the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class HealthError(RuntimeError):
    """An allocator/slot invariant was violated (a real bug, not a fault)."""


def audit_allocator(alloc) -> List[str]:
    """Structural invariants of a PageAllocator: free list is duplicate-
    free and disjoint from the used set, and every page is exactly one
    of free/used (page 0 excluded — it is the garbage sink)."""
    issues: List[str] = []
    free = list(alloc._free)
    if len(set(free)) != len(free):
        issues.append("allocator free list contains duplicates")
    inter = set(free) & alloc._used
    if inter:
        issues.append(f"pages both free and used: {sorted(inter)}")
    if len(free) + len(alloc._used) != alloc.n_pages - 1:
        issues.append(
            f"page accounting off: {len(free)} free + "
            f"{len(alloc._used)} used != {alloc.n_pages - 1} usable")
    for pid in alloc._used:
        if alloc.refcount(pid) < 1:
            issues.append(f"used page {pid} has refcount < 1")
    return issues


def audit_session(sess, extra_refs: Optional[Dict[int, int]] = None
                  ) -> List[str]:
    """Exact refcount accounting for a paged Session: every allocated
    page's refcount must equal its slot-table references plus its prefix
    pin (if cached) plus any externally held refs (``extra_refs``, e.g.
    pages owned by in-flight handoffs on the prefill side)."""
    if getattr(sess, "alloc", None) is None:
        return []
    issues = audit_allocator(sess.alloc)
    expected: Dict[int, int] = dict(extra_refs or {})
    for i in range(sess.slots):
        for pid in sess.host_table[i]:
            pid = int(pid)
            if pid < 0:
                continue
            if pid not in sess.alloc._used:
                issues.append(
                    f"slot {i} references unallocated page {pid}")
                continue
            expected[pid] = expected.get(pid, 0) + 1
    if sess.prefix is not None:
        for pid in sess.prefix._entries.values():
            expected[pid] = expected.get(pid, 0) + 1
    for pid in sess.alloc._used:
        want = expected.get(pid, 0)
        have = sess.alloc.refcount(pid)
        if want != have:
            issues.append(
                f"page {pid} refcount {have}, expected {want} "
                "(slot refs + prefix pin + external)")
    for pid in expected:
        if pid not in sess.alloc._used:
            issues.append(f"referenced page {pid} is not allocated")
    # slot liveness: an entry-less slot must own no pages
    for i in range(sess.slots):
        if sess.slot_entry[i] is None and (sess.host_table[i] >= 0).any():
            issues.append(f"empty slot {i} still holds pages")
    return issues


class Watchdog:
    """Periodic invariant auditor. ``due(tick)`` gates the cadence;
    ``audit`` raises HealthError on the first violation found."""

    def __init__(self, every: int):
        if every < 1:
            raise ValueError("watchdog cadence must be >= 1 tick")
        self.every = every
        self.audits = 0
        # observability seam: a ``(name, **args)`` emitter (obs.Tracer
        # .hook); every audit emits health.audit with its issue count.
        self.obs = None

    def due(self, tick: int) -> bool:
        return tick > 0 and tick % self.every == 0

    def audit(self, sess, extra_refs: Optional[Dict[int, int]] = None
              ) -> None:
        self.audits += 1
        issues = audit_session(sess, extra_refs=extra_refs)
        if self.obs is not None:
            self.obs("health.audit",
                     target=getattr(sess, "role", "engine"),
                     issues=len(issues))
        if issues:
            raise HealthError(
                "watchdog audit failed: " + "; ".join(issues[:5]))
