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
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.obs.registry import Histogram, Registry
from repro_torch.obs.registry import percentile as percentile  # re-export


#: the stable top-level key set of `summarize()` (the JAX package's) —
#: the schema ``--json`` dumps and downstream tooling rely on.
#: ``outcomes`` appears too when a record carries a state.
SUMMARY_KEYS = (
    "requests", "completed", "tokens", "seconds", "steps", "tok_per_s",
    "goodput_req_per_s", "ttft_s", "ttft_sched", "queue_wait_sched",
    "tpot_s", "first_token_calls", "preemptions", "prefix_pages_reused",
)


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


def _outcomes(records: Sequence[Dict]) -> Optional[dict]:
    """Terminal-state census (absent when no record carries a state)."""
    reg = Registry()
    for r in records:
        if r.get("state"):
            reg.counter(r["state"]).inc()
    return {k: c.value for k, c in reg.counters.items()} or None


def summarize(records: Sequence[Dict], span_seconds: float,
              steps: int) -> dict:
    """Fold per-request lifecycle records into the serving summary.

    records: dicts with prompt_len, max_new, n_generated, submit_time,
    first_token_time, finish_time, submit_step, admit_step,
    first_token_step, preemptions, prefix_pages (absent fields skipped).
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
    out = {
        "requests": requests.value,
        "completed": completed.value,
        "tokens": tokens.value,
        "seconds": round(span_seconds, 4),
        "steps": steps,
        "tok_per_s": _rate(tokens.value, span_seconds),
        "goodput_req_per_s": _rate(completed.value, span_seconds, 3),
        "ttft_s": ttft.summary(),
        "ttft_sched": ttft_step.summary(),  # model-call steps
        "queue_wait_sched": queue_wait.summary(),
        "tpot_s": tpot.summary(),
        "first_token_calls": first_calls.summary(),
        "preemptions": preempts.value,
        "prefix_pages_reused": prefix_pages.value,
    }
    outcomes = _outcomes(records)
    if outcomes is not None:
        out["outcomes"] = outcomes
    return out
