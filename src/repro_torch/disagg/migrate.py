"""KV page migration channel between the disaggregated roles.

A handoff is the unit of work that crosses the prefill -> decode
boundary: the scheduler entry (request, generated-so-far tokens and
lifecycle record) plus the prompt's page-table row and position.  The
page ids in ``pages`` are *prefill-pool* ids whose ownership has already
left the prefill slot: they stay refcounted in the prefill allocator
until the migration lands, when the orchestrator frees them (a shared
prefix page just drops one owner).

``migrate_kv`` copies the live pages into freshly allocated decode-pool
pages through `kvstore.copy_pages`: bf16 payloads bit for bit, int8
payloads their codes *and* per-page scales with no requantization, so a
migrated prompt decodes as it would have where it was written.  Holes in
the row (NO_PAGE, from SWA reclamation) stay holes: a table index equals
the absolute position // page_size on both sides, so the decode role
resumes exactly where prefill stopped.  Both pools live on one device;
the copy never leaves it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch import kvstore as kvs


@dataclasses.dataclass
class Handoff:
    """One finished prompt in flight from the prefill role to the decode
    role.  ``pages`` is the full prefill page-table row (NO_PAGE holes
    included: index alignment carries the position mapping); ``pos`` is
    the position the decode role resumes at (the prompt length); ``tick``
    is the orchestrator tick the handoff was made on."""
    entry: object                  # sched.SchedEntry (its record rides along)
    pages: List[int]
    pos: int
    tick: int = 0
    # resilience layer: a fault-dropped or delayed handoff stays queued
    # but is invisible to decode admission until ``ready_tick``; ``drops``
    # counts delivery attempts lost to injected drops
    ready_tick: int = 0
    drops: int = 0

    def live(self) -> List[Tuple[int, int]]:
        """(table_index, prefill_page_id) of every resident page."""
        return [(j, p) for j, p in enumerate(self.pages) if p >= 0]


def migrate_kv(src_state: dict, dst_state: dict, src_ids: List[int],
               dst_ids: List[int]) -> Tuple[dict, int]:
    """Copy pages ``src_ids`` of the prefill state's pool into pages
    ``dst_ids`` of the decode state's pool; returns the decode state and
    the payload byte count.  The decode pool is written in place, so the
    state returned is ``dst_state`` itself.  The pools must share
    geometry (page size, head / dim layout, quantization): both roles are
    built from one ArchConfig, so they do."""
    _, moved = kvs.copy_pages(src_state["layers"]["kv"],
                              dst_state["layers"]["kv"], src_ids, dst_ids)
    return dst_state, moved
