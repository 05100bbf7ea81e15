"""Deterministic tick-clock structured event tracer for the serving stack.

One :class:`Tracer` collects *spans* (work that occupies ticks — decode
steps, chunked-prefill steps) and *instant events* (admissions,
preemptions, handoffs, page allocations, fault injections) from every
seam the stack already has.  Two properties make it useful as a test
artifact and not just a debugging aid:

* **tick clock, not wall clock** — every event is stamped with the
  scheduler tick it happened on (plus role / slot / rid coordinates).
  For a fixed seed the serving stack's decisions are deterministic, so
  the exported event stream is *byte-identical across replays* and two
  same-seed runs can be diffed (wall-time phase timers live separately,
  see :class:`WallTimers`, and never enter the event stream).
* **zero cost when disabled** — sessions hold :data:`NULL` (a no-op
  tracer with ``enabled = False``) unless the caller passes a live one;
  hot-path seams (allocator, prefix cache, scheduler) are wired only
  when a live tracer is attached, so the off path adds nothing.

The Chrome/Perfetto ``trace_event`` exporter maps roles to processes
and slots to threads: load the exported JSON in https://ui.perfetto.dev
and a serve run renders as a per-role, per-slot timeline (one tick =
:data:`TICK_US` microseconds on the rendered axis).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, List, Optional

#: microseconds one scheduler tick occupies on the exported timeline
#: (purely presentational: ticks are the real clock)
TICK_US = 1000

#: stable process ids for the known roles; unknown roles are assigned
#: deterministically (sorted by name) after these
ROLE_PIDS = {"engine": 1, "prefill": 1, "decode": 2}

class NullTracer:
    """The disabled tracer: every emit is a no-op, ``enabled`` is False
    so seams that need to build expensive args can skip entirely."""

    enabled = False
    recorder = None

    def instant(self, name, **kw):
        pass

    def span(self, name, **kw):
        pass

    def crash(self, reason, **context):
        pass


#: the shared disabled tracer — sessions default to this
NULL = NullTracer()


class Tracer:
    """Collects structured events on the scheduler tick clock.

    ``capture=False`` keeps no full event list (useful when only the
    flight-recorder ring matters); a ``recorder`` (obs.FlightRecorder)
    receives every event regardless and is dumped by :meth:`crash`.
    """

    enabled = True

    def __init__(self, capture: bool = True, recorder=None):
        self.capture = capture
        self.recorder = recorder
        self.events: List[dict] = []
        self.wall = WallTimers()

    # ------------------------------------------------------------ emit
    def _emit(self, ev: dict) -> None:
        if self.capture:
            self.events.append(ev)
        if self.recorder is not None:
            self.recorder.record(ev)

    def instant(self, name: str, *, tick: int, role: str = "engine",
                slot: Optional[int] = None, **args) -> None:
        """A point event at ``tick`` (admission, handoff, fault, ...)."""
        self._emit({"name": name, "ph": "i", "tick": int(tick),
                    "role": role, "slot": slot, "args": args})

    def span(self, name: str, *, tick: int, dur: int = 1,
             role: str = "engine", slot: Optional[int] = None,
             **args) -> None:
        """Work occupying ``dur`` ticks starting at ``tick`` (a decode
        or prefill step)."""
        self._emit({"name": name, "ph": "X", "tick": int(tick),
                    "dur": int(dur), "role": role, "slot": slot,
                    "args": args})

    def crash(self, reason: str, **context) -> Optional[str]:
        """Flush the flight recorder to disk (HealthError / OutOfPages /
        RequestFailed post-mortems).  Returns the dump path, if any."""
        if self.recorder is None:
            return None
        return self.recorder.dump(reason=reason, context=context)

    def hook(self, role: str, clock: Callable[[], int]) -> Callable:
        """A ``(name, **args) -> None`` emitter bound to a role and a
        tick-clock callable — the shape the allocator / prefix-cache /
        scheduler seams accept so they stay import-light."""
        return lambda name, **a: self.instant(name, tick=clock(),
                                              role=role, **a)

    # ---------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON: roles become processes,
        slots become threads (tid 0 = role-level events)."""
        pids: Dict[str, int] = dict(ROLE_PIDS)
        for ev in self.events:
            if ev["role"] not in pids:
                pids[ev["role"]] = 0   # placeholder, assigned below
        nxt = max(pids.values(), default=0) + 1
        for role in sorted(r for r, p in pids.items() if p == 0):
            pids[role] = nxt
            nxt += 1
        out: List[dict] = []
        seen_threads = set()
        for role in sorted({ev["role"] for ev in self.events},
                           key=lambda r: (pids[r], r)):
            out.append({"name": "process_name", "ph": "M", "pid": pids[role],
                        "tid": 0, "args": {"name": role}})
        for ev in self.events:
            pid = pids[ev["role"]]
            tid = 0 if ev["slot"] is None else int(ev["slot"]) + 1
            if tid and (pid, tid) not in seen_threads:
                seen_threads.add((pid, tid))
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid,
                            "args": {"name": f"slot {tid - 1}"}})
            rec = {"name": ev["name"], "ph": ev["ph"], "pid": pid,
                   "tid": tid, "ts": ev["tick"] * TICK_US,
                   "args": dict(ev["args"], tick=ev["tick"])}
            if ev["ph"] == "X":
                rec["dur"] = ev["dur"] * TICK_US
            elif ev["ph"] == "i":
                rec["s"] = "t"
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Perfetto-loadable trace; deterministic serialization
        (sorted keys) so same-seed replays are byte-identical."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


class WallTimers:
    """Wall-clock phase accumulators (decode / prefill / migrate ...).

    Deliberately separate from the event stream: wall time is host noise
    and would break replay-identical traces, but the per-phase split
    says where a serve's wall time went."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> dict:
        total = sum(self.seconds.values())
        return {name: {"seconds": round(self.seconds[name], 4),
                       "calls": self.calls[name],
                       "share": round(self.seconds[name] / total, 4)
                       if total > 0 else None}
                for name in sorted(self.seconds)}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Optional ``torch.profiler`` capture (CPU and, where a card is
    visible, CUDA activities) around the serve, exported as a Chrome
    trace (``trace.json``) into ``log_dir``: a no-op when ``log_dir`` is
    falsy, so callers can thread the flag through unconditionally
    (serve.py ``--profile-dir``)."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
