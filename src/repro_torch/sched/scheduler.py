"""Continuous-batching scheduling policy: admission order, page-pool
admission control and the preemption victim.

The Scheduler owns the waiting side of serving — requests submitted but
holding no batch slot — while `api.Session` owns slots and device state.

* **policy** — who goes next.  ``fifo`` is strict head-of-line (a
  request that does not fit blocks the ones behind it: deterministic,
  starvation-free); ``sjf`` (shortest-prompt-first) picks the smallest
  admissible prompt, which turns slots over faster under heterogeneous
  traffic.  Starvation of long prompts is bounded by aging: a request
  waiting more than ``sjf_age_limit`` steps is promoted to head-of-line
  (oldest first) and, like a fifo head, blocks everything behind it
  until it fits.
* **admission control** — a request is admitted only when its
  worst-case page need (``ceil(min(prompt + max_new, max_len) /
  page_size)`` less the pages it will reuse from the prefix cache) fits
  the allocator's free list right now.  Concurrent requests may still
  outgrow the pool together; that is what preemption is for.
* **preemption** — under page pressure the youngest admitted request
  (highest admission sequence number) is evicted back to the queue
  front: its pages are freed, its generated tokens ride along in the
  entry, and on re-admission the Session re-prefills prompt + generated
  (recompute resume: with greedy sampling the resumed stream equals an
  uninterrupted run).  The last runner is never preempted, so the
  system always makes progress; a pool too small for one request still
  raises `OutOfPages`.

``chunk`` is the prefill width: prompt tokens a slot feeds per model call
(1 = token by token through the decode step).  Host-side bookkeeping
only, the same decisions as the JAX package's scheduler.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional

POLICIES = ("fifo", "sjf")


@dataclasses.dataclass
class SchedConfig:
    """Serving scheduler knobs (see the module docstring)."""
    policy: str = "fifo"          # "fifo" | "sjf"
    chunk: int = 1                # prefill tokens per model call (1 = off)
    prefix_cache: bool = False    # shared-prefix page reuse (paged only)
    sjf_age_limit: Optional[int] = 256  # steps before an sjf entry is
    #                             # promoted head-of-line (None = starve)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"choose one of {POLICIES}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.sjf_age_limit is not None and self.sjf_age_limit < 1:
            raise ValueError(
                f"sjf_age_limit must be >= 1 (or None), "
                f"got {self.sjf_age_limit}")

    @classmethod
    def coerce(cls, val) -> "SchedConfig":
        if val is None:
            return cls()
        if isinstance(val, cls):
            return val
        if isinstance(val, str):
            return cls(policy=val)
        if isinstance(val, dict):
            return cls(**val)
        raise TypeError(f"cannot make a SchedConfig from {val!r}")


@dataclasses.dataclass
class SchedEntry:
    """One queued (or preempted-back-to-queue) request and its serving
    lifecycle state.  ``out`` carries generated tokens across a
    preemption; ``seq`` is the admission age (-1 until first admitted,
    then monotone: youngest = max)."""
    req: object                   # api.spec.Request
    submit_step: int = 0
    submit_time: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    seq: int = -1
    preemptions: int = 0
    prefix_pages: int = 0         # pages attached from the prefix cache
    record: Optional[dict] = None  # lifecycle record (the Session's)
    hashes: Optional[list] = None  # prompt page hashes, computed once
    deadline_tick: Optional[int] = None  # tick it must finish by (None:
    #                             # no deadline; the resilience layer's)
    retries: int = 0              # re-admissions after faults / recovery


class Scheduler:
    def __init__(self, cfg: Optional[SchedConfig] = None):
        self.cfg = SchedConfig.coerce(cfg)
        self.queue: Deque[SchedEntry] = collections.deque()
        self._seq = 0
        self.stats = {"preemptions": 0, "admission_blocks": 0}
        # observability seam: a ``(name, **args)`` emitter attached by the
        # owning Session; None = no events
        self.obs = None

    # ------------------------------------------------------------ queue
    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req, step: int = 0, now: float = 0.0) -> SchedEntry:
        e = SchedEntry(req=req, submit_step=step, submit_time=now)
        self.queue.append(e)
        return e

    def requeue(self, entry: SchedEntry) -> None:
        """A preempted entry resumes at the queue front: it was admitted
        once, so anything behind it ranks lower under both policies."""
        entry.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.appendleft(entry)

    # -------------------------------------------------------- admission
    def _aged(self, step: Optional[int]) -> List[int]:
        """Queue indices whose wait exceeds the sjf aging bound, oldest
        first (submit_step, then queue position)."""
        k = self.cfg.sjf_age_limit
        if k is None or step is None:
            return []
        aged = [i for i in range(len(self.queue))
                if step - self.queue[i].submit_step > k]
        return sorted(aged, key=lambda i: (self.queue[i].submit_step, i))

    def next_entry(self, fits: Callable[[SchedEntry], bool],
                   step: Optional[int] = None) -> Optional[SchedEntry]:
        """Pop the next admissible entry per policy, or None.  ``fits`` is
        the Session's page-need predicate; ``step`` its model-call clock,
        read only for the sjf aging bound."""
        if not self.queue:
            return None
        aged: List[int] = []
        if self.cfg.policy == "sjf":
            aged = self._aged(step)
            if aged:
                # an over-age entry behaves like a fifo head: it goes next
                # and, if it does not fit, blocks
                order = aged[:1]
            else:
                order = sorted(range(len(self.queue)),
                               key=lambda i: (len(self.queue[i].req.prompt)
                                              + len(self.queue[i].out),
                                              i))
        else:                      # fifo: strict head-of-line
            order = [0]
        for i in order:
            e = self.queue[i]
            if fits(e):
                del self.queue[i]
                # (re-)admission stamps a fresh age
                e.seq = self._seq
                self._seq += 1
                return e
            self.stats["admission_blocks"] += 1
            if self.obs is not None:
                self.obs("sched.block", rid=e.req.rid,
                         queued=len(self.queue))
            if self.cfg.policy == "fifo" or aged:
                return None        # head-of-line blocks
        return None

    # ----------------------------------------------------- queue surgery
    def pop_expired(self, tick: int) -> List[SchedEntry]:
        """Remove and return queued entries whose deadline has passed
        (``tick > deadline_tick``); the survivors keep their order."""
        expired = [e for e in self.queue
                   if e.deadline_tick is not None and tick > e.deadline_tick]
        if expired:
            gone = set(id(e) for e in expired)
            self.queue = collections.deque(
                e for e in self.queue if id(e) not in gone)
        return expired

    def shed_youngest(self) -> Optional[SchedEntry]:
        """Remove and return the most recently submitted queued entry that
        has never been admitted (preempted entries hold work already
        done), or None if every queued entry has run before."""
        for i in range(len(self.queue) - 1, -1, -1):
            e = self.queue[i]
            if e.seq == -1 and not e.out:
                del self.queue[i]
                return e
        return None

    # ------------------------------------------------------- preemption
    @staticmethod
    def choose_victim(active: List[Optional[SchedEntry]]) -> Optional[int]:
        """Slot index of the youngest admitted entry, or None if <= 1
        active (never preempt the last runner)."""
        live = [(e.seq, i) for i, e in enumerate(active) if e is not None]
        if len(live) <= 1:
            return None
        return max(live)[1]


def page_need(prompt_len: int, max_new: int, max_len: int,
              page_size: int) -> int:
    """Worst-case pages a request holds at once: every position it can
    ever write, clipped at the table width (positions beyond max_len are
    clamped)."""
    total = min(prompt_len + max_new, max_len)
    return -(-total // page_size)
