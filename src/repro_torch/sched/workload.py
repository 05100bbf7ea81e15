"""Heterogeneous serving workloads — reproducible request mixes.

A `WorkloadSpec` draws (prompt_len, max_new, arrival) from seeded
distributions, so `launch.serve --workload ...` and the tests replay
identical request schedules.  The draws follow the JAX package's
generator call for call on ``np.random.default_rng(seed)``, so one spec
gives both packages the same arrivals, lengths and token values.

Arrivals are in decode steps, not wall seconds: the serving loop is
step-quantised, so step offsets make schedules the same on hosts of any
speed.

Trace replay: any serve traced with ``--trace`` (repro_torch.obs) is
itself a workload — :meth:`WorkloadSpec.from_trace` rebuilds the exact
``(arrival_tick, prompt_len, max_new)`` stream from the trace's
``req.submit`` events into an explicit ``schedule``, which
:func:`generate` replays verbatim (token values are drawn again from
the seed; admission, paging and batching depend only on lengths and
arrival ticks).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.api.spec import Request

#: named presets for the CLI and the tests
PRESETS = ("uniform", "heterogeneous", "shared-prefix", "burst")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    n_requests: int = 8
    prompt_len: Tuple[int, int] = (4, 16)     # inclusive uniform range
    max_new: Tuple[int, int] = (4, 16)        # inclusive uniform range
    arrival: str = "batch"                    # "batch" | "poisson" | "burst"
    arrival_rate: float = 0.5                 # requests per step (poisson)
    burst_every: int = 16                     # steps between bursts
    burst_size: int = 4
    shared_prefix_len: int = 0                # common head on every prompt
    vocab: int = 256
    temperature: float = 0.0
    seed: int = 0
    #: explicit (arrival_step, prompt_len, max_new) schedule, replayed
    #: verbatim by generate() over the arrival process and the ranges
    schedule: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @classmethod
    def preset(cls, name: str, **overrides) -> "WorkloadSpec":
        base = {
            "uniform": dict(prompt_len=(8, 8), max_new=(8, 8)),
            "heterogeneous": dict(prompt_len=(2, 24), max_new=(2, 24),
                                  arrival="poisson"),
            "shared-prefix": dict(prompt_len=(18, 28), max_new=(4, 8),
                                  shared_prefix_len=16),
            "burst": dict(prompt_len=(4, 16), max_new=(4, 16),
                          arrival="burst"),
        }
        if name not in base:
            raise ValueError(f"unknown workload preset {name!r}; "
                             f"choose one of {PRESETS}")
        kw = dict(base[name])
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_trace(cls, trace, *, vocab: int = 256,
                   temperature: float = 0.0, seed: int = 0,
                   include_warmup: bool = False) -> "WorkloadSpec":
        """The request stream a traced serve saw.  ``trace``: a live
        ``Tracer``, an exported Chrome trace path, a parsed Chrome doc or
        a raw event list.  Each ``req.submit`` event gives one
        ``(arrival_tick, prompt_len, max_new)`` entry, in submission
        order with the original ticks.  Warm-up requests (rid < 0) are
        dropped unless ``include_warmup``."""
        from repro_torch.obs.analyze import coerce_events
        subs = [(ev["tick"], ev["args"]["prompt_len"],
                 ev["args"]["max_new"], ev["args"].get("rid"))
                for ev in coerce_events(trace)
                if ev["name"] == "req.submit"]
        if not include_warmup:
            subs = [s for s in subs if s[3] is None or s[3] >= 0]
        if not subs:
            raise ValueError("trace has no req.submit events to replay")
        schedule = tuple((int(t), int(p), int(m)) for t, p, m, _ in subs)
        return cls(n_requests=len(schedule),
                   prompt_len=(min(p for _, p, _ in schedule),
                               max(p for _, p, _ in schedule)),
                   max_new=(min(m for _, _, m in schedule),
                            max(m for _, _, m in schedule)),
                   arrival="trace", vocab=vocab,
                   temperature=temperature, seed=seed,
                   schedule=schedule)


def generate(spec: WorkloadSpec) -> List[Tuple[int, Request]]:
    """-> [(arrival_step, Request)], sorted by arrival step, rids 0..n-1
    in arrival order.  An explicit ``spec.schedule`` is replayed verbatim:
    the same ticks, the same lengths, seeded token values."""
    rng = np.random.default_rng(spec.seed)
    if spec.schedule is not None:
        out = []
        for rid, (step, plen, mnew) in enumerate(spec.schedule):
            prompt = [int(x) for x in rng.integers(1, spec.vocab,
                                                   int(plen))]
            out.append((int(step),
                        Request(prompt=prompt, max_new=int(mnew),
                                temperature=spec.temperature, rid=rid)))
        return out
    lo_p, hi_p = spec.prompt_len
    lo_n, hi_n = spec.max_new
    shared = [int(x) for x in rng.integers(1, spec.vocab,
                                           spec.shared_prefix_len)] \
        if spec.shared_prefix_len else []
    arrivals: List[int] = []
    if spec.arrival == "poisson":
        t = 0.0
        for _ in range(spec.n_requests):
            t += rng.exponential(1.0 / max(spec.arrival_rate, 1e-9))
            arrivals.append(int(t))
    elif spec.arrival == "burst":
        for i in range(spec.n_requests):
            arrivals.append((i // spec.burst_size) * spec.burst_every)
    else:                                     # "batch": all at step 0
        arrivals = [0] * spec.n_requests
    out = []
    for rid, step in enumerate(sorted(arrivals)):
        plen = int(rng.integers(lo_p, hi_p + 1))
        plen = max(plen, spec.shared_prefix_len + 1)  # >= 1 unshared token
        tail = [int(x) for x in rng.integers(1, spec.vocab,
                                             plen - len(shared))]
        req = Request(prompt=shared + tail,
                      max_new=int(rng.integers(lo_n, hi_n + 1)),
                      temperature=spec.temperature, rid=rid)
        out.append((step, req))
    return out


def timed_requests(spec_or_name, **overrides) -> List[Tuple[int, Request]]:
    """A WorkloadSpec, a preset name or None (the defaults), with
    overrides, generated."""
    if spec_or_name is None:
        spec = WorkloadSpec(**overrides)
    elif isinstance(spec_or_name, WorkloadSpec):
        spec = dataclasses.replace(spec_or_name, **overrides) \
            if overrides else spec_or_name
    else:
        spec = WorkloadSpec.preset(spec_or_name, **overrides)
    return generate(spec)
