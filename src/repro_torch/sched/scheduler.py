"""Continuous-batching scheduling policy: FIFO admission, page-pool
admission control and the preemption victim.

* **policy** — strict head-of-line FIFO: a request that does not fit
  blocks the ones behind it (deterministic, starvation-free).
* **admission control** — a request is admitted only when its worst-case
  page need, ``ceil(min(prompt + max_new, max_len) / page_size)``, fits
  the allocator's free list right now.
* **preemption** — under page pressure the youngest admitted request is
  evicted back to the queue front; its generated tokens ride along and
  are re-prefilled on re-admission (recompute resume).  The last runner
  is never preempted.

Host-side bookkeeping only.  The JAX package's sjf policy, prefix cache
and chunked prefill land with later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional

POLICIES = ("fifo",)


@dataclasses.dataclass
class SchedConfig:
    """Serving scheduler knobs of this slice: FIFO, one token per call."""
    policy: str = "fifo"
    chunk: int = 1

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"this slice runs {POLICIES}")
        if self.chunk != 1:
            raise NotImplementedError(
                "chunked prefill (chunk > 1) lands with the port's next "
                "slice, with its kernel")

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
    """One queued (or preempted-back-to-queue) request.  ``out`` carries
    generated tokens across a preemption; ``seq`` is the admission age
    (-1 until first admitted, then monotone: youngest = max)."""
    req: object                   # api.spec.Request
    out: List[int] = dataclasses.field(default_factory=list)
    seq: int = -1


class Scheduler:
    def __init__(self, cfg: Optional[SchedConfig] = None):
        self.cfg = SchedConfig.coerce(cfg)
        self.queue: Deque[SchedEntry] = collections.deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req) -> SchedEntry:
        e = SchedEntry(req=req)
        self.queue.append(e)
        return e

    def requeue(self, entry: SchedEntry) -> None:
        """A preempted entry resumes at the queue front."""
        self.queue.appendleft(entry)

    def next_entry(self, fits: Callable[[SchedEntry], bool]
                   ) -> Optional[SchedEntry]:
        """Pop the head entry if it is admissible, else None (head-of-line
        blocks)."""
        if not self.queue:
            return None
        e = self.queue[0]
        if not fits(e):
            return None
        self.queue.popleft()
        # (re-)admission stamps a fresh age
        e.seq = self._seq
        self._seq += 1
        return e

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
    """Worst-case pages a request holds simultaneously (positions beyond
    max_len are clamped)."""
    total = min(prompt_len + max_new, max_len)
    return -(-total // page_size)
