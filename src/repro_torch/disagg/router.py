"""Role-aware request router for disaggregated serving.

`DisaggRouter` IS the prefill role's scheduler (a `sched.Scheduler`
subclass: every admission policy, the page-pool admission predicate and
the sjf aging bound work unchanged) plus the handoff queue that feeds the
decode role.  Its one extension is *back-pressure*: while more finished
prompts wait in the handoff queue than ``max_backlog``, the router
refuses to admit new prompts into prefill slots instead of letting the
decode role preempt running decoders.  Prefill work already in flight
keeps running; only *new* admissions stall, so decode pressure becomes
TTFT delay for queued requests rather than recompute for admitted ones.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Optional

from repro_torch.disagg.migrate import Handoff
from repro_torch.sched.scheduler import SchedConfig, SchedEntry, Scheduler


class DisaggRouter(Scheduler):
    def __init__(self, cfg: Optional[SchedConfig] = None,
                 max_backlog: int = 4):
        super().__init__(cfg)
        if max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1, got {max_backlog}")
        self.max_backlog = max_backlog
        self.handoff: Deque[Handoff] = collections.deque()
        self.stats.update({"handoffs": 0, "backpressure_blocks": 0})

    # ------------------------------------------------------- handoff side
    def push_handoff(self, h: Handoff) -> None:
        """Prefill finished a prompt: queue it for decode admission (FIFO,
        so the decode side's admission order stays deterministic)."""
        self.handoff.append(h)
        self.stats["handoffs"] += 1

    @property
    def backlog(self) -> int:
        return len(self.handoff)

    # ------------------------------------------------------ prefill side
    def next_entry(self, fits: Callable[[SchedEntry], bool],
                   step: Optional[int] = None) -> Optional[SchedEntry]:
        """Scheduler.next_entry, but no admission while the handoff backlog
        is at its bound: prefilling prompts the decode role cannot absorb
        would only grow the pile of state waiting to migrate."""
        if len(self.handoff) >= self.max_backlog:
            if self.queue:
                self.stats["backpressure_blocks"] += 1
                if self.obs is not None:
                    self.obs("sched.block", rid=self.queue[0].req.rid,
                             queued=len(self.queue), backpressure=True,
                             backlog=len(self.handoff))
            return None
        return super().next_entry(fits, step=step)
