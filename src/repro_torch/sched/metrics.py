"""Serving metrics: TTFT / TPOT / latency percentiles / goodput.

The Session records one lifecycle dict per request (submit, admit, first
token and finish, in wall seconds and in model-call steps); `summarize`
folds them into the JSON-ready serving record the launcher's ``--json``
writes.  The keys, and how each is computed, are the JAX package's.

The wall-clock fields (``ttft_s``, ``tpot_s``, ``tok_per_s``) are honest
only because the Session stamps each time after the step's logits reach
the host (a copy that waits for the card).  Step-denominated numbers
(``first_token_calls``, ``ttft_sched``, preemptions, prefix pages) are
deterministic for a given workload and carry the exact checks.

Rate fields guard their denominators: a zero-span or zero-step run
reports ``None`` for tok/s and goodput instead of raising or making up a
rate.

Disaggregated serving adds two record families: per-request *handoff*
fields (``handoff_latency_s``, ``handoff_ticks``, ``migrated_pages``,
``migrated_bytes``, stamped by the decode role when it admits a migrated
prompt) fold into a ``"handoff"`` sub-record, and a ``roles=`` dict of
per-role step counters becomes ``"roles"`` with each role's utilisation
(busy ticks over ticks).  ``resil=`` (a session's ``resil_summary()``)
passes through as ``"resil"``, and failed records are counted by reason.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.obs.registry import Histogram, Registry
from repro_torch.obs.registry import percentile as percentile  # re-export


#: the stable top-level key set of `summarize()` (the JAX package's) —
#: the schema ``--json`` dumps and downstream tooling rely on.
#: ``outcomes`` appears too when a record carries a state, and the rest of
#: ``SUMMARY_KEYS_CONDITIONAL`` when their record family is present.
SUMMARY_KEYS = (
    "requests", "completed", "tokens", "seconds", "steps", "tok_per_s",
    "goodput_req_per_s", "ttft_s", "ttft_sched", "queue_wait_sched",
    "tpot_s", "first_token_calls", "preemptions", "prefix_pages_reused",
)
SUMMARY_KEYS_CONDITIONAL = ("outcomes", "resil", "handoff", "roles")


def _dist(values: Sequence[float], scale: float = 1.0) -> Optional[dict]:
    """mean/p50/p99 of a value list via a throwaway Histogram — the
    canonical distribution record; None on empty input."""
    h = Histogram("_dist")
    h.observe_many(values)
    return h.summary(scale=scale)


def _rate(num: float, denom: float, digits: int = 2) -> Optional[float]:
    """num/denom, or None when the denominator is degenerate (zero-span
    runs must not crash or report infinite rates)."""
    if denom is None or denom <= 0:
        return None
    return round(num / denom, digits)


def _handoff(records: Sequence[Dict]) -> Optional[dict]:
    """Fold the disaggregated handoff fields (absent on co-located
    runs)."""
    hs = [r for r in records if r.get("handoff_latency_s") is not None]
    if not hs:
        return None
    n = len(hs)
    return {
        "count": n,
        "latency_s": _dist([r["handoff_latency_s"] for r in hs]),
        "latency_ticks": _dist([r["handoff_ticks"] for r in hs
                                if r.get("handoff_ticks") is not None]),
        "migrated_pages": sum(r.get("migrated_pages", 0) for r in hs),
        "migrated_bytes": sum(r.get("migrated_bytes", 0) for r in hs),
        "bytes_per_request": _rate(
            sum(r.get("migrated_bytes", 0) for r in hs), n, 1),
    }


def _outcomes(records: Sequence[Dict]) -> Optional[dict]:
    """Terminal-state census (absent when no record carries a state);
    ``failed_by_reason`` attributes every structured failure (deadline,
    shed, retries_exhausted, oversized)."""
    reg = Registry()
    for r in records:
        s = r.get("state")
        if not s:
            continue
        reg.counter(s).inc()
        if s == "failed" and r.get("failed_reason"):
            reg.counter(f"failed/{r['failed_reason']}").inc()
    counts = {k: c.value for k, c in reg.counters.items()}
    states = {k: v for k, v in counts.items() if not k.startswith("failed/")}
    if not states:
        return None
    out: Dict[str, int] = dict(states)
    reasons = {k.split("/", 1)[1]: v for k, v in counts.items()
               if k.startswith("failed/")}
    if reasons:
        out["failed_by_reason"] = reasons
    return out


def summarize(records: Sequence[Dict], span_seconds: float,
              steps: int, roles: Optional[Dict[str, Dict]] = None,
              resil: Optional[Dict] = None) -> dict:
    """Fold per-request lifecycle records into the serving summary.

    records: dicts with prompt_len, max_new, n_generated, submit_time,
    first_token_time, finish_time, submit_step, admit_step,
    first_token_step, preemptions, prefix_pages (absent fields skipped).

    roles: per-role counters of a disaggregated run, ``{"prefill":
    {"steps": n, "busy_ticks": b}, "decode": {...}, "_ticks": total}``,
    folded into ``"roles"`` with each role's utilisation.  resil: the
    resilience counters (``resil_summary()``), passed through as
    ``"resil"``.
    """
    reg = Registry()
    requests = reg.counter("requests")
    completed = reg.counter("completed")
    tokens = reg.counter("tokens")
    preempts = reg.counter("preemptions")
    prefix_pages = reg.counter("prefix_pages_reused")
    ttft = reg.histogram("ttft_s")
    tpot = reg.histogram("tpot_s")
    first_calls = reg.histogram("first_token_calls")
    ttft_tick = reg.histogram("ttft_ticks")
    ttft_step = reg.histogram("ttft_steps")
    queue_wait = reg.histogram("queue_wait_sched")
    for r in records:
        requests.inc()
        preempts.inc(r.get("preemptions", 0))
        prefix_pages.inc(r.get("prefix_pages", 0))
        if r.get("first_token_time") is not None:
            ttft.observe(r["first_token_time"] - r["submit_time"])
        if r.get("first_token_step") is not None:
            if r.get("admit_step") is not None:
                first_calls.observe(r["first_token_step"]
                                    - r["admit_step"])
            if r.get("submit_step") is not None:
                ttft_step.observe(r["first_token_step"]
                                  - r["submit_step"])
        if r.get("first_token_tick") is not None \
                and r.get("submit_tick") is not None:
            ttft_tick.observe(r["first_token_tick"] - r["submit_tick"])
        # queueing delay split from service time, in the scheduling
        # clock: the wait between submit and first slot admission is
        # pure queueing (admission back-pressure), deterministic for a
        # given workload — obs.analyze derives the full split (incl.
        # preemption re-queueing) from the trace; this is the cheap
        # always-on record-level view
        if r.get("admit_step") is not None \
                and r.get("submit_step") is not None:
            queue_wait.observe(r["admit_step"] - r["submit_step"])
        if r.get("finish_time") is None:
            continue
        completed.inc()
        tokens.inc(r["n_generated"])
        if r["n_generated"] > 1 and r.get("first_token_time") is not None:
            tpot.observe((r["finish_time"] - r["first_token_time"])
                         / (r["n_generated"] - 1))
    # scheduling-clock TTFT, comparable across engine shapes: a
    # disaggregated run stamps submit and first token in orchestrator
    # ticks; a co-located run falls back to its model-call step clock
    ttft_sched = ttft_tick if ttft_tick.values else ttft_step
    out = {
        "requests": requests.value,
        "completed": completed.value,
        "tokens": tokens.value,
        "seconds": round(span_seconds, 4),
        "steps": steps,
        "tok_per_s": _rate(tokens.value, span_seconds),
        "goodput_req_per_s": _rate(completed.value, span_seconds, 3),
        "ttft_s": ttft.summary(),
        "ttft_sched": ttft_sched.summary(),
        "queue_wait_sched": queue_wait.summary(),
        "tpot_s": tpot.summary(),
        "first_token_calls": first_calls.summary(),
        "preemptions": preempts.value,
        "prefix_pages_reused": prefix_pages.value,
    }
    outcomes = _outcomes(records)
    if outcomes is not None:
        out["outcomes"] = outcomes
    if resil is not None:
        out["resil"] = dict(resil)
    hand = _handoff(records)
    if hand is not None:
        out["handoff"] = hand
    if roles:
        ticks = roles.get("_ticks")
        out["roles"] = {
            name: {"steps": rec.get("steps"),
                   "utilization": _rate(rec.get("busy_ticks", 0),
                                        ticks, 3)}
            for name, rec in roles.items() if name != "_ticks"}
    return out
