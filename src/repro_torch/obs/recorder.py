"""Bounded flight recorder: the last-N trace events, dumped on failure.

A serve that dies with ``OutOfPages`` (or, once the resilience layer
is ported, ``HealthError`` / a ``RequestFailed``) would leave nothing
but the exception text; the flight recorder keeps a ring of the most
recent events (every event the tracer emits passes through it) and
writes them to disk with the failure context, so the ticks *leading up
to* the failure are post-mortem-debuggable.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Optional


class FlightRecorder:
    """Ring buffer of recent trace events with automatic crash dumps.

    ``capacity`` bounds memory; ``out_dir`` is where :meth:`dump`
    writes ``flight_<seq>_<reason>.json`` files (created lazily).
    """

    def __init__(self, capacity: int = 256, out_dir: str = "."):
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self.ring = collections.deque(maxlen=self.capacity)
        self.total = 0          # events ever seen (ring keeps the tail)
        self.dumps = []         # paths written so far
        self._seq = 0

    def record(self, ev: dict) -> None:
        self.ring.append(ev)
        self.total += 1

    def dump(self, reason: str, context: Optional[dict] = None) -> str:
        """Write the current ring + failure context; returns the path.

        Never overwrites: two recorders sharing an ``out_dir`` (e.g. the
        prefill and decode roles of a disaggregated serve dying on the
        same tick) each keep their own ``_seq``, so the sequence number
        alone cannot dedupe — advance past any path already on disk.
        """
        os.makedirs(self.out_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        while True:
            path = os.path.join(self.out_dir,
                                f"flight_{self._seq:03d}_{safe}.json")
            self._seq += 1
            if not os.path.exists(path):
                break
        payload = {
            "reason": reason,
            "context": context or {},
            "capacity": self.capacity,
            "events_total": self.total,
            "events": list(self.ring),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        self.dumps.append(path)
        return path
