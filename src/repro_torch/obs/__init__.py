"""`repro_torch.obs` — observability for the port's serving stack.

* **trace** — deterministic tick-clock event stream (spans and instants)
  from every seam of the session, exported as Chrome/Perfetto
  ``trace_event`` JSON; byte-identical across same-seed replays, on the
  card and on the CPU alike.
* **registry** — typed counter/gauge/histogram aggregation that
  `sched.metrics.summarize()` is built on, plus :func:`provenance`
  run-context headers (torch, CUDA, the card and its power limit).
* **recorder** — bounded flight-recorder ring of recent events, dumped
  to disk on ``OutOfPages``.
* **analyze** — trace analytics: fold the event stream (live or an
  exported file) into a :class:`TraceReport` — per-request critical
  path, queueing split, role utilisation, page-pool pressure — and
  score it against a declarative :class:`SLOSpec`.

Plus :func:`timeit` (the best-of-N wall timer, synchronising the card)
and :func:`profile_trace` (an optional ``torch.profiler`` capture).
"""
from repro_torch.obs.analyze import SLOSpec, TraceReport, analyze, load_trace
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      percentile, provenance)
from repro_torch.obs.timing import timeit
from repro_torch.obs.trace import (NULL, NullTracer, Tracer, WallTimers,
                                   profile_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "percentile",
    "provenance", "FlightRecorder", "timeit", "NULL", "NullTracer",
    "Tracer", "WallTimers", "profile_trace",
    "SLOSpec", "TraceReport", "analyze", "load_trace",
]
