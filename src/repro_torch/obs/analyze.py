"""Trace analytics: turn the tick-clock event stream into attribution.

The serving stack emits a deterministic trace (``obs.trace``); this
module consumes it.  :func:`analyze` takes a live
:class:`~repro_torch.obs.Tracer`
(or an exported Chrome/Perfetto JSON path, or a raw event list) and
folds it into a :class:`TraceReport`:

* **per-request critical path** — every tick between ``req.submit`` and
  the terminal event is attributed to exactly one phase (``queue`` /
  ``prefill`` / ``handoff`` / ``decode``) by replaying the request's
  lifecycle events as a state machine, so the segments *sum to the
  submit->finish span by construction*.  Fault/retry/degrade activity
  shows up as detour counters (preemptions, re-admissions, handoff
  drops, fallbacks), never as unattributed time.
* **queueing split** — queue-wait ticks (time not occupying a slot)
  separated from service ticks, each as mean/p50/p99.
* **per-role / per-seam attribution** — step counts, busy-step
  utilization, and event counts per seam name for every role.
* **page-pool pressure timeline** — the allocator's ``in_use`` level
  per role over ticks (change-compressed), plus peak/alloc/free/
  holdback totals.
* **SLO evaluation** — a declarative :class:`SLOSpec` (scheduling-clock
  TTFT p99, TPOT p99, goodput floor) scored against the report, with
  the violating requests *named*.

The analysis is a pure function of the trace: no wall clock, no
environment, no provenance timestamps enter the report, so two
same-seed serves produce **byte-identical** ``TraceReport`` JSON —
the same property the trace export itself has.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.obs.registry import Histogram, percentile
from repro_torch.obs.trace import TICK_US

#: report schema version (bump on any key change — reports are diffed
#: byte for byte); the JAX package's, whose report this one equals
SCHEMA = "repro.obs.analyze/v1"

#: critical-path phases a request can occupy, in lifecycle order
PHASES = ("queue", "prefill", "handoff", "decode")

#: lifecycle event -> the phase the request is in AFTER seeing it
_PHASE_AFTER = {
    "req.submit": "queue",
    "sched.admit": "prefill",       # re-admission after preempt too
    "req.first_token": "decode",
    "handoff.enqueue": "handoff",   # waiting for the decode role
    "handoff.deliver": "decode",
    "handoff.fallback": "queue",    # back to the decode role's queue
    "sched.preempt": "queue",
}
#: terminal lifecycle events -> request outcome
_TERMINAL = {"req.finish": "completed", "resil.fail": "failed"}


# ----------------------------------------------------------- trace input
def events_from_chrome(doc: dict) -> List[dict]:
    """Invert ``Tracer.to_chrome()``: Chrome ``trace_event`` rows back to
    the tracer's internal event dicts (name/ph/tick/role/slot/args), in
    file order.  Roles come from the ``process_name`` metadata rows;
    ticks from the ``args.tick`` echo every exported event carries."""
    roles: Dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            roles[ev.get("pid")] = ev.get("args", {}).get("name")
    out: List[dict] = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        args = dict(ev.get("args", {}))
        tick = args.pop("tick", ev.get("ts", 0) // TICK_US)
        tid = ev.get("tid", 0)
        rec = {"name": ev.get("name"), "ph": ph, "tick": int(tick),
               "role": roles.get(ev.get("pid"), str(ev.get("pid"))),
               "slot": (int(tid) - 1) if tid else None, "args": args}
        if ph == "X":
            rec["dur"] = int(ev.get("dur", TICK_US)) // TICK_US
        out.append(rec)
    return out


def load_trace(path: str) -> List[dict]:
    """Load an exported Chrome trace file back into event-dict form."""
    with open(path) as f:
        return events_from_chrome(json.load(f))


def coerce_events(trace) -> List[dict]:
    """Accept a live Tracer, an exported-trace path, a Chrome JSON doc,
    or a raw event list — return the event list."""
    if hasattr(trace, "events"):                 # live Tracer
        return list(trace.events)
    if isinstance(trace, str):
        return load_trace(trace)
    if isinstance(trace, dict):
        return events_from_chrome(trace)
    return list(trace)


# ------------------------------------------------------------------- SLO
@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative serving SLO, all in deterministic scheduler-tick /
    fraction units (wall clock never gates):

    * ``ttft_p99`` — p99 of scheduling-clock TTFT (submit -> first
      token, ticks) must be <= this;
    * ``tpot_p99`` — p99 of per-request ticks-per-output-token (after
      the first token) must be <= this;
    * ``goodput`` — completed/submitted fraction must be >= this.

    Unset fields don't gate.  ``evaluate`` names every violating rid.
    """

    ttft_p99: Optional[float] = None
    tpot_p99: Optional[float] = None
    goodput: Optional[float] = None

    @classmethod
    def parse(cls, spec: str) -> "SLOSpec":
        """``"ttft_p99=40,tpot_p99=4,goodput=0.95"`` (``ttft``/``tpot``
        accepted as aliases)."""
        alias = {"ttft": "ttft_p99", "ttft_p99": "ttft_p99",
                 "tpot": "tpot_p99", "tpot_p99": "tpot_p99",
                 "goodput": "goodput"}
        kw: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip().lower()
            if not sep or key not in alias:
                raise ValueError(
                    f"bad SLO term {part!r}; want "
                    "ttft_p99=N,tpot_p99=N,goodput=F")
            kw[alias[key]] = float(val)
        if not kw:
            raise ValueError(f"empty SLO spec {spec!r}")
        return cls(**kw)

    def describe(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    def evaluate(self, requests: Dict[str, dict]) -> dict:
        """Score per-request report records (``TraceReport.requests``
        values) against the declared bounds.  Returns ``{"spec", "pass",
        "metrics": {name: {bound, value, pass, violators}}}``."""
        metrics: Dict[str, dict] = {}
        if self.ttft_p99 is not None:
            vals = {rid: r["ttft_sched"] for rid, r in requests.items()
                    if r.get("ttft_sched") is not None}
            p99 = percentile(list(vals.values()), 99)
            metrics["ttft_p99"] = {
                "bound": self.ttft_p99,
                "value": p99,
                "pass": p99 is not None and p99 <= self.ttft_p99,
                "violators": sorted(
                    (int(rid) for rid, v in vals.items()
                     if v > self.ttft_p99), key=int),
            }
        if self.tpot_p99 is not None:
            vals = {rid: r["tpot_ticks"] for rid, r in requests.items()
                    if r.get("tpot_ticks") is not None}
            p99 = percentile(list(vals.values()), 99)
            metrics["tpot_p99"] = {
                "bound": self.tpot_p99,
                "value": p99,
                "pass": p99 is not None and p99 <= self.tpot_p99,
                "violators": sorted(
                    (int(rid) for rid, v in vals.items()
                     if v > self.tpot_p99), key=int),
            }
        if self.goodput is not None:
            done = [rid for rid, r in requests.items()
                    if r["outcome"] == "completed"]
            frac = round(len(done) / len(requests), 4) if requests \
                else None
            metrics["goodput"] = {
                "bound": self.goodput,
                "value": frac,
                "pass": frac is not None and frac >= self.goodput,
                "violators": sorted(
                    (int(rid) for rid, r in requests.items()
                     if r["outcome"] != "completed")),
            }
        return {"spec": self.describe(),
                "pass": all(m["pass"] for m in metrics.values()),
                "metrics": metrics}


# ------------------------------------------------------------ the report
@dataclasses.dataclass
class TraceReport:
    """Structured, JSON-ready trace analysis.  Every field is a pure
    function of the trace events (plus the optional SLOSpec) — no wall
    clock, no provenance — so ``to_json()`` is byte-identical across
    same-seed replays."""

    schema: str
    ticks: dict                  # {"begin", "end", "span"}
    requests: Dict[str, dict]    # str(rid) -> lifecycle record
    critical_path: dict          # phase -> {"ticks", "share"}
    queueing: dict               # queue_wait/service/ttft_sched/tpot dists
    roles: dict                  # role -> steps/busy/utilization
    seams: dict                  # role -> {event name: count}
    pages: dict                  # role -> pressure timeline + totals
    detours: dict                # fault/degrade/audit/shed totals
    slo: Optional[dict]          # SLOSpec.evaluate() output, if given

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """Canonical serialization (sorted keys, trailing newline) —
        the byte form diffed across same-seed replays."""
        return json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def segments_consistent(self) -> bool:
        """The acceptance invariant: each request's critical-path
        segments sum exactly to its submit->end tick span."""
        return all(sum(r["segments"].values()) == r["span"]
                   for r in self.requests.values())


def _dist(values: Sequence[float]) -> Optional[dict]:
    h = Histogram("_dist")
    h.observe_many(values)
    return h.summary()


def _request_paths(events: Sequence[dict], end_tick: int) -> Dict[str, dict]:
    """Replay each rid's lifecycle events as a phase state machine.
    Every tick between submit and the terminal event lands in exactly
    one phase bucket; unfinished requests accumulate to the trace end."""
    reqs: Dict[int, dict] = {}
    for ev in events:
        rid = ev["args"].get("rid")
        if rid is None:
            continue
        name, t = ev["name"], ev["tick"]
        if name == "req.submit":
            reqs[rid] = {
                "submit_tick": t, "finish_tick": None,
                "first_token_tick": None,
                "prompt_len": ev["args"].get("prompt_len"),
                "max_new": ev["args"].get("max_new"),
                "outcome": "unfinished", "tokens": 0,
                "segments": {p: 0 for p in PHASES},
                "detours": {},
                "_phase": "queue", "_t": t,
            }
            continue
        st = reqs.get(rid)
        if st is None or st["finish_tick"] is not None:
            continue
        det = st["detours"]
        if name == "sched.block":
            det["blocked"] = det.get("blocked", 0) + 1
            continue
        if name == "sched.shed":
            det["shed"] = det.get("shed", 0) + 1
            continue
        if name == "handoff.oversized":
            det["oversized"] = det.get("oversized", 0) + 1
            continue
        if name == "handoff.migrate":
            continue                         # deliver did the transition
        if name in _TERMINAL:
            st["segments"][st["_phase"]] += t - st["_t"]
            st["_t"] = t
            st["finish_tick"] = t
            st["outcome"] = _TERMINAL[name]
            if name == "req.finish":
                st["tokens"] = ev["args"].get("tokens", 0)
            else:
                st["failed_reason"] = ev["args"].get("reason")
                st["retries"] = ev["args"].get("retries", 0)
            continue
        nxt = _PHASE_AFTER.get(name)
        if nxt is None:
            continue
        st["segments"][st["_phase"]] += t - st["_t"]
        st["_phase"], st["_t"] = nxt, t
        if name == "req.first_token":
            st["first_token_tick"] = t
        elif name == "sched.preempt":
            det["preemptions"] = det.get("preemptions", 0) + 1
        elif name == "sched.admit" and ev["args"].get("resumed"):
            det["readmissions"] = det.get("readmissions", 0) + 1
        elif name == "handoff.fallback":
            det["handoff_fallbacks"] = det.get("handoff_fallbacks", 0) + 1
        elif name == "handoff.enqueue" and ev["args"].get("drops"):
            det["handoff_drops"] = (det.get("handoff_drops", 0)
                                    + ev["args"]["drops"])
    out: Dict[str, dict] = {}
    for rid, st in reqs.items():
        if st["finish_tick"] is None:        # still in flight at trace end
            st["segments"][st["_phase"]] += end_tick - st["_t"]
        end = st["finish_tick"] if st["finish_tick"] is not None \
            else end_tick
        st["span"] = end - st["submit_tick"]
        st["ttft_sched"] = (st["first_token_tick"] - st["submit_tick"]
                            if st["first_token_tick"] is not None else None)
        st["tpot_ticks"] = None
        if (st["outcome"] == "completed" and st["tokens"] > 1
                and st["first_token_tick"] is not None):
            st["tpot_ticks"] = round(
                (st["finish_tick"] - st["first_token_tick"])
                / (st["tokens"] - 1), 4)
        del st["_phase"], st["_t"]
        out[str(rid)] = st
    return out


def _roles(events: Sequence[dict], span: int) -> dict:
    out: dict = {}
    for ev in events:
        if not ev["name"].startswith("step."):
            continue
        r = out.setdefault(ev["role"], {
            "steps": 0, "busy_steps": 0, "decode_steps": 0,
            "prefill_steps": 0, "prefill_tokens": 0})
        r["steps"] += 1
        if ev["args"].get("active"):
            r["busy_steps"] += 1
        if ev["name"] == "step.decode":
            r["decode_steps"] += 1
        else:
            r["prefill_steps"] += 1
            r["prefill_tokens"] += ev["args"].get("tokens", 0)
    for r in out.values():
        r["utilization"] = round(r["busy_steps"] / span, 4) \
            if span > 0 else None
    return out


def _seams(events: Sequence[dict]) -> dict:
    out: Dict[str, Dict[str, int]] = {}
    for ev in events:
        role = out.setdefault(ev["role"], {})
        role[ev["name"]] = role.get(ev["name"], 0) + 1
    return out


def _pages(events: Sequence[dict]) -> dict:
    """Per-role page-pool pressure: the allocator's post-op ``in_use``
    level over ticks (one point per tick where the level changed),
    plus alloc/free/holdback totals and the peak level."""
    out: dict = {}
    for ev in events:
        name = ev["name"]
        if not name.startswith("alloc."):
            continue
        p = out.setdefault(ev["role"], {
            "timeline": [], "peak": 0, "allocs": 0, "frees": 0,
            "holdbacks": 0})
        if name == "alloc.holdback":
            p["holdbacks"] += 1
            continue
        in_use = ev["args"].get("in_use", 0)
        if name == "alloc.pages":
            p["allocs"] += ev["args"].get("n", 0)
        else:
            p["frees"] += ev["args"].get("n", 0)
        p["peak"] = max(p["peak"], in_use)
        tl = p["timeline"]
        if tl and tl[-1][0] == ev["tick"]:
            tl[-1][1] = in_use                  # last level on this tick
        else:
            tl.append([ev["tick"], in_use])
    for p in out.values():
        # change-compress: drop points that repeat the previous level
        tl, kept = p["timeline"], []
        for pt in tl:
            if not kept or kept[-1][1] != pt[1]:
                kept.append(pt)
        p["timeline"] = kept
    return out


def _detours(events: Sequence[dict]) -> dict:
    faults: Dict[str, int] = {}
    degrades = audits = sheds = fails = 0
    for ev in events:
        name = ev["name"]
        if name == "fault.injected":
            cls = ev["args"].get("fault", "?")
            faults[cls] = faults.get(cls, 0) + 1
        elif name == "resil.degrade":
            degrades += 1
        elif name == "health.audit":
            audits += 1
        elif name == "sched.shed":
            sheds += 1
        elif name == "resil.fail":
            fails += 1
    return {"faults": faults, "degrades": degrades, "audits": audits,
            "shed": sheds, "failed": fails}


def analyze(trace, slo: Optional[Union[SLOSpec, str]] = None) -> TraceReport:
    """Fold a trace (live Tracer / exported path / Chrome doc / event
    list) into a :class:`TraceReport`; optionally score an SLO."""
    if isinstance(slo, str):
        slo = SLOSpec.parse(slo)
    events = coerce_events(trace)
    begin = min((ev["tick"] for ev in events), default=0)
    end = max((ev["tick"] + ev.get("dur", 0) for ev in events), default=0)
    span = end - begin
    requests = _request_paths(events, end)
    totals = {p: sum(r["segments"][p] for r in requests.values())
              for p in PHASES}
    denom = sum(totals.values())
    critical_path = {
        p: {"ticks": totals[p],
            "share": round(totals[p] / denom, 4) if denom else None}
        for p in PHASES}
    queue_waits = [r["segments"]["queue"] for r in requests.values()]
    services = [r["span"] - r["segments"]["queue"]
                for r in requests.values()]
    queueing = {
        "queue_wait": _dist(queue_waits),
        "service": _dist(services),
        "ttft_sched": _dist([r["ttft_sched"] for r in requests.values()
                             if r["ttft_sched"] is not None]),
        "tpot_ticks": _dist([r["tpot_ticks"] for r in requests.values()
                             if r["tpot_ticks"] is not None]),
    }
    return TraceReport(
        schema=SCHEMA,
        ticks={"begin": begin, "end": end, "span": span},
        requests=requests,
        critical_path=critical_path,
        queueing=queueing,
        roles=_roles(events, span),
        seams=_seams(events),
        pages=_pages(events),
        detours=_detours(events),
        slo=slo.evaluate(requests) if slo is not None else None,
    )
