"""Port parity for the resilience layer (`repro_torch.resil` and its
session seams) against the JAX package's `repro.resil`: the seeded fault
plan's decisions bit for bit, `ResilConfig`'s coercion and validation, the
watchdog's audits, deadlines, shedding, handoff-timeout fallback,
wedged-role drain and recover, the degradation ladder, structured failures
and unserved records, the chaos presets with replay, ``resil=None``
unchanged, and a churn sweep held to the port's serial oracle.  Served on
the CPU (every kernel's plain version) at a reduced llama3-8b."""
import dataclasses
import hashlib
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from port_test_env import module_compile_cache  # noqa: F401
from repro import obs as jobs
from repro import resil as jrsl
from repro.api.session import Request as JRequest
from repro.api.session import Session as JSession
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.disagg import DisaggConfig as JDisaggConfig
from repro.disagg import DisaggSession as JDisaggSession
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro.sched import summarize as jsummarize
from repro_torch import bridge
from repro_torch import kvstore as tkvs
from repro_torch import obs as tobs
from repro_torch import resil as rsl
from repro_torch import sched as schd
from repro_torch.api import Engine, Request
from repro_torch.api.session import Session
from repro_torch.configs import get, reduced
from repro_torch.disagg import DisaggConfig, DisaggSession

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
PS = 4          # page size: small, so short prompts still span pages
ML = 48         # max_len
PRESETS = ("drop-handoff", "role-stall", "page-spike", "straggler")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's steps are many small CPU products: one intra-op
    thread serves them as fast alone, and under a parallel test run keeps
    every process's spinning OpenMP threads from contending for the
    cores (six such processes take 20 s instead of 456 s).  The count is
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def restore_reference_tuner():
    """The reference's engines and sessions record their kernel choices in
    its global tuner cache, and its jitted steps keep the choices they
    were traced with: restore the cache and drop the traces after the
    module, so that a later module's reference runs in the same process
    (same reduced llama3-8b, pages and slots) pick what they pick alone."""
    saved = dict(jtune._CACHE)
    yield
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)
    jax.clear_caches()


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return bridge.from_reference(jax.tree.map(np.asarray, jparams))


def burst_arrivals(n=6, seed=0):
    return schd.generate(schd.WorkloadSpec.preset(
        "burst", n_requests=n, vocab=CFG.vocab, seed=seed))


def replay(arrivals):
    return [(t, dataclasses.replace(r)) for t, r in arrivals]


def mk_disagg(params, resil, **kw):
    d = dict(prefill_slots=2, decode_slots=3)
    d.update(kw)
    return DisaggSession(CFG, params, disagg=DisaggConfig(**d),
                         device="cpu", max_len=ML, page_size=PS,
                         scheduler={"chunk": 4}, resil=resil)


def session(params, **kw):
    kw.setdefault("batch_slots", 2)
    return Session(CFG, params, max_len=ML, page_size=PS, device="cpu",
                   **kw)


@pytest.fixture(scope="module")
def clean_tokens(params):
    """Fault-free disaggregated tokens of the module's burst workload."""
    d = mk_disagg(params, None)
    return {r.rid: r.tokens
            for r in d.run_workload(replay(burst_arrivals()))}


def leaked(d: DisaggSession) -> int:
    return d.pre.alloc.in_use + d.dec.alloc.in_use


def alloc_invariant(alloc):
    assert len(set(alloc._free)) == len(alloc._free)
    assert not set(alloc._free) & alloc._used
    assert len(alloc._free) + alloc.in_use == alloc.n_pages - 1


# ------------------------------------------------------------ FaultPlan
def _decisions(plan):
    """Every decision of ``plan`` over role x tick 0-40 x rid 0-7 x
    attempt 0-2 (the step check's raised coordinates included), then its
    counters."""
    out = []
    for role in ("prefill", "decode", "engine"):
        for tick in range(41):
            out.append(("step", role, tick, plan.step_fault(role, tick)))
            try:
                plan.check_step(role, tick)
            except Exception as f:         # both packages' InjectedFault
                out.append(("raised", type(f).__name__, f.fault_class,
                            f.role, f.tick, str(f)))
            out.append(("hold", role, tick,
                        plan.page_holdback(37, tick, role=role)))
    for rid in range(8):
        out.append(("delay", rid, plan.handoff_delay(rid)))
        for attempt in range(3):
            out.append(("drop", rid, attempt,
                        plan.drop_handoff(rid, attempt)))
    out.append(("meta", plan.describe(), plan.redeliver_after,
                dict(plan.params), dict(plan.stats)))
    return out


@pytest.mark.parametrize("preset", ("none",) + PRESETS)
def test_fault_plan_decisions_equal_reference(preset):
    """Seeds 0-3: the port's plan decides everything the reference's
    does, bit for bit, and counts the same faults."""
    assert rsl.PRESETS == jrsl.PRESETS
    for seed in range(4):
        got = _decisions(rsl.FaultPlan.make(preset, seed=seed))
        assert got == _decisions(jrsl.FaultPlan.make(preset, seed=seed))
        # a fresh plan queried in reverse order decides the same
        again = rsl.FaultPlan.parse(f"{preset}:{seed}")
        assert [again.drop_handoff(r, a) for r in reversed(range(8))
                for a in reversed(range(3))] == \
            [d[3] for d in reversed(got) if d[0] == "drop"]


@pytest.mark.parametrize("spec", ["drop-handoff:3", "straggler",
                                  "gremlins:1", "straggler:x"])
def test_fault_plan_parse_like_reference(spec):
    def outcome(pkg):
        try:
            p = pkg.FaultPlan.parse(spec)
        except ValueError as e:
            return ("ValueError", str(e))
        return (p.preset, p.seed, p.params)
    assert outcome(rsl) == outcome(jrsl)


RESIL_CASES = [
    None, True, "role-stall:2", {"deadline_ticks": 5},
    {"fault_plan": {"preset": "page-spike", "seed": 1,
                    "params": {"frac": 0.9}}},
    {"fault_plan": "drop-handoff:3", "max_retries": 0,
     "handoff_timeout": 4, "watchdog_every": 2, "shed_watermark": 0.5,
     "degrade_kv": True},
    {"deadline_ticks": 0}, {"max_retries": -1}, {"wedge_ticks": 0},
    {"shed_watermark": 0.0}, {"handoff_timeout": 0},
    {"fault_plan": "gremlins"}, {"bogus": 1}, 3.5]


def _config_view(pkg, val):
    try:
        cfg = pkg.ResilConfig.coerce(val)
    except (TypeError, ValueError) as e:
        return (type(e).__name__, str(e))
    view = dataclasses.asdict(dataclasses.replace(cfg, fault_plan=None))
    plan = cfg.fault_plan
    view["fault_plan"] = None if plan is None else \
        (plan.describe(), plan.params)
    assert pkg.ResilConfig.coerce(cfg) is cfg
    return view


@pytest.mark.parametrize("val", RESIL_CASES, ids=range(len(RESIL_CASES)))
def test_resil_config_accepts_and_refuses_like_reference(val):
    """Coercion from a config, dict, ``True`` or ``"preset:seed"``, and
    validation: the same fields, or the same error and message."""
    if val is None:               # coerce(None) refuses; sessions skip it
        with pytest.raises(TypeError):
            rsl.ResilConfig.coerce(val)
        return
    assert _config_view(rsl, val) == _config_view(jrsl, val)


def test_resil_config_refuses_redeliver_after():
    """The reference's ``ResilConfig.redeliver_after`` is read nowhere (the
    cadence is the fault plan's parameter): the port refuses a value it
    would ignore, and the plan's parameter sets the cadence."""
    assert jrsl.ResilConfig(redeliver_after=5).redeliver_after == 5
    with pytest.raises(ValueError, match="fault plan's parameter"):
        rsl.ResilConfig.coerce({"redeliver_after": 5})
    cfg = rsl.ResilConfig.coerce({"fault_plan": {
        "preset": "drop-handoff", "seed": 1, "redeliver_after": 5}})
    assert cfg.fault_plan.redeliver_after == 5


# --------------------------------------------------------------- health
def test_watchdog_audit_passes_and_catches_leak(params):
    sess = session(params)
    sess.submit(Request(prompt=[2, 3, 4, 5, 6], max_new=3, rid=0))
    sess.run()
    assert rsl.audit_allocator(sess.alloc) == []
    assert rsl.audit_session(sess) == []   # drained: clean
    pid = sess.alloc.alloc()               # a manufactured leak
    issues = rsl.audit_session(sess)
    assert issues and "refcount" in issues[0]
    with pytest.raises(rsl.HealthError, match="watchdog audit failed"):
        rsl.Watchdog(1).audit(sess)
    sess.alloc.free([pid])
    assert rsl.audit_session(sess) == []


def test_watchdog_audits_during_run(params, clean_tokens):
    d = mk_disagg(params, {"watchdog_every": 2})
    toks = {r.rid: r.tokens for r in d.run_workload(replay(burst_arrivals()))}
    assert toks == clean_tokens            # auditing changes nothing
    assert d.resil.stats["watchdog_audits"] > 0
    assert leaked(d) == 0


# ------------------------------------------------- deadlines / shedding
def test_deadline_expiry_structured_failures(params):
    d = mk_disagg(params, {"deadline_ticks": 5})
    res = d.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    assert len(res) + len(d.failed) == 6
    assert d.failed and all(f.reason == "deadline" for f in d.failed)
    assert all(isinstance(f, rsl.RequestFailed) for f in d.failed)
    assert d.resil.stats["deadline_miss"] == len(d.failed)
    assert leaked(d) == 0
    fr = [r for r in d.records if r["state"] == "failed"]
    assert {r["failed_reason"] for r in fr} == {"deadline"}
    m = schd.summarize(d.records, 1.0, 1, roles=d.role_stats(),
                       resil=d.resil_summary())
    assert m["outcomes"]["failed_by_reason"]["deadline"] == len(d.failed)
    assert m["resil"]["deadline_miss"] == len(d.failed)
    assert set(m) - set(schd.metrics.SUMMARY_KEYS) <= \
        set(schd.metrics.SUMMARY_KEYS_CONDITIONAL)
    # the reference's summarize folds the same records the same way
    assert m == jsummarize(d.records, 1.0, 1, roles=d.role_stats(),
                           resil=d.resil_summary())


def test_per_request_deadline_overrides_config(params):
    sess = session(params, batch_slots=1, resil={"deadline_ticks": 500})
    sess.submit(Request(prompt=[2] * 8, max_new=8, rid=0,
                        deadline_ticks=1))
    sess.submit(Request(prompt=[3] * 4, max_new=2, rid=1))
    res = sess.run(on_incomplete="warn")
    assert [f.rid for f in sess.failed] == [0]
    assert sess.failed[0].reason == "deadline"
    assert [r.rid for r in res] == [1]
    assert sess.alloc.in_use == 0
    assert [r["deadline_tick"] for r in sess.records] == [1, 500]


def test_shed_load_youngest_never_admitted(params, clean_tokens):
    d = mk_disagg(params, {"shed_watermark": 0.25})
    res = d.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    assert d.resil.stats["shed"] > 0
    assert all(f.reason == "shed" and not f.tokens for f in d.failed)
    # only never-admitted work is shed
    shed = {f.rid for f in d.failed}
    assert all(r["admit_step"] is None for r in d.records
               if r["rid"] in shed)
    # survivors are token-identical: shedding refuses, never corrupts
    assert all(clean_tokens[r.rid] == r.tokens for r in res)
    assert leaked(d) == 0


def test_colocated_shedding_traces_each_shed(params):
    """The co-located session sheds too, youngest first, and traces it."""
    sess = session(params, resil={"shed_watermark": 0.1},
                   obs=tobs.Tracer())
    res = sess.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    shed = [(e["tick"], e["args"]["rid"]) for e in sess.tracer.events
            if e["name"] == "sched.shed"]
    assert shed and [rid for _, rid in shed] == \
        [f.rid for f in sess.failed]
    assert shed == sorted(shed, key=lambda e: (e[0], -e[1]))
    assert len(res) + len(shed) == 6 and sess.alloc.in_use == 0


# ------------------------------------------------------------- chaos
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("preset", PRESETS)
def test_chaos_preset_parity_and_replay(params, clean_tokens, preset, seed):
    """Per (preset, seed): every request completes with the fault-free
    run's tokens, nothing fails, zero pages leak on either pool, the
    audits are clean, and a same-seed replay gives identical records
    (every tick and step field) and summary."""
    runs = []
    for _ in range(2):
        d = mk_disagg(params, {"fault_plan": f"{preset}:{seed}",
                               "max_retries": 2, "watchdog_every": 4})
        res = d.run_workload(replay(burst_arrivals()),
                             on_incomplete="warn")
        assert not d.failed
        assert all(isinstance(f, rsl.RequestFailed) for f in d.failed)
        assert rsl.audit_session(d.pre) == [] == rsl.audit_session(d.dec)
        recs = [{k: v for k, v in r.items() if not k.endswith("_time")
                 and k != "handoff_latency_s"} for r in d.records]
        runs.append(({r.rid: r.tokens for r in res}, leaked(d), recs,
                     d.resil_summary(), d.role_stats()))
    assert runs[0][0] == clean_tokens, f"{preset}:{seed} diverged"
    assert runs[0][1] == 0
    assert runs[0] == runs[1], f"{preset}:{seed} replay diverged"


@pytest.mark.parametrize("preset", ["drop-handoff:1", "page-spike:0"])
def test_chaos_summary_equals_reference(jparams, params, preset):
    """The same fault plan through the reference's DisaggSession: the
    resilience counters, the injected-fault counts, and every record's
    scheduling-clock fields are the reference's."""
    resil = {"fault_plan": preset, "max_retries": 2, "watchdog_every": 4}
    jd = JDisaggSession(JCFG, jparams,
                        disagg=JDisaggConfig(prefill_slots=2,
                                             decode_slots=3),
                        max_len=ML, page_size=PS, scheduler={"chunk": 4},
                        resil=resil)
    jd.run_workload([(t, JRequest(prompt=list(r.prompt), max_new=r.max_new,
                                  rid=r.rid))
                     for t, r in burst_arrivals()], on_incomplete="warn")
    d = mk_disagg(params, resil)
    d.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    assert d.resil_summary() == jd.resil_summary()
    ticks = ("rid", "state", "submit_tick", "first_token_tick",
             "prefill_done_tick", "handoff_ticks", "migrated_pages",
             "submit_step", "admit_step", "first_token_step", "retries")
    assert [{k: r.get(k) for k in ticks} for r in d.records] == \
        [{k: r.get(k) for k in ticks} for r in jd.records]


# ---------------------------------------------- recovery / degradation
def test_handoff_timeout_falls_back_to_decode_role(params, clean_tokens):
    d = mk_disagg(params, {"fault_plan": "drop-handoff:0",
                           "handoff_timeout": 2, "max_retries": 2},)
    res = d.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    assert d.resil.stats["handoff_fallbacks"] > 0
    assert {r.rid: r.tokens for r in res} == clean_tokens
    assert any(r.get("degraded") == "colocated-prefill"
               for r in d.records)
    assert d.dec.stats["preemptions"] == 0   # reservation discipline held
    assert leaked(d) == 0


def test_wedged_role_drain_and_recover(params, clean_tokens):
    """A prefill role stalled far past wedge_ticks is drained: its slots
    requeue through the retry path and complete with the fault-free
    tokens or fail structurally once their retries run out."""
    plan = {"preset": "role-stall", "seed": 0,
            "params": {"role": "prefill", "start": 2, "span": 12,
                       "jitter": 0}}
    d = mk_disagg(params, {"fault_plan": plan, "max_retries": 3,
                           "watchdog_every": 2, "wedge_ticks": 3},)
    res = d.run_workload(replay(burst_arrivals()), on_incomplete="warn")
    r = d.resil.stats
    assert r["watchdog_recoveries"] > 0 and r["retries"] > 0
    assert r["fault_steps"] > 0
    assert all(clean_tokens[x.rid] == x.tokens for x in res)
    assert all(f.reason == "retries_exhausted" for f in d.failed)
    assert len(res) + len(d.failed) == 6
    assert leaked(d) == 0


def test_step_fault_burns_the_tick_before_any_work(params, monkeypatch):
    """An injected step fault is raised before the step builds anything:
    the model is never called on a faulted tick, and the fault is
    traced."""
    calls = []
    decode = schd.prefill_step

    def counted(*a, **kw):
        calls.append(1)
        return decode(*a, **kw)
    monkeypatch.setattr(schd, "prefill_step", counted)
    plan = {"preset": "role-stall", "seed": 0,
            "params": {"role": "engine", "start": 0, "span": 3,
                       "jitter": 0}}
    sess = session(params, scheduler={"chunk": 4},
                   resil={"fault_plan": plan}, obs=tobs.Tracer())
    sess.submit(Request(prompt=[2] * 8, max_new=2, rid=0))
    sess.run()
    faults = [e for e in sess.tracer.events if e["name"] == "fault.injected"]
    assert [e["tick"] for e in faults] == [0, 1, 2]
    assert sess.resil.stats["fault_steps"] == 3
    assert sess.stats["prefill_steps"] == len(calls) == 2


def test_degrade_ladder_demotes_next_session_kv(params):
    plan = {"preset": "page-spike", "seed": 0,
            "params": {"frac": 0.8, "span": 500, "start": 2, "jitter": 0}}
    d = mk_disagg(params, {"fault_plan": plan, "degrade_kv": True,
                           "degrade_sustain_ticks": 3})
    d.run_workload(replay(burst_arrivals()), on_incomplete="warn",
                   max_steps=400)
    assert d.resil.degrade.level == 2
    assert d.resil.next_kv_dtype("bf16") == "int8"
    assert leaked(d) == 0
    # the next-session boundary: Engine.session reads the live state
    eng = Engine(CFG, params=params, device="cpu")
    s2 = eng.session(max_len=ML, kv_cache="paged", page_size=PS,
                     resil=d.resil)
    assert s2.kv_dtype == "int8" and s2.state["layers"]["kv"].quantized
    s2.submit(Request(prompt=[2, 3, 4], max_new=2, rid=0))
    s2.run()
    assert d.resil.stats["degraded_admissions"] > 0


# -------------------------------------------- structured terminal states
def test_oversized_request_warns_and_fails_structurally(params):
    """A handoff that can never fit the decode pool names the request,
    its page need and the pool size; under ``on_incomplete="warn"`` it
    becomes a RequestFailed, not a hang; without "warn" it raises."""
    kw = dict(disagg=DisaggConfig(decode_pool_pages=4), device="cpu",
              max_len=ML, page_size=PS, scheduler={"chunk": 4})
    d = DisaggSession(CFG, params, resil=True, **kw)
    d.submit(Request(prompt=list(range(1, 21)), max_new=8, rid=7))
    with pytest.warns(RuntimeWarning, match=r"request 7 needs \d+ pages"):
        res = d.run(on_incomplete="warn")
    assert res == []
    assert [f.rid for f in d.failed] == [7]
    assert d.failed[0].reason == "oversized"
    assert leaked(d) == 0
    d2 = DisaggSession(CFG, params, **kw)
    d2.submit(Request(prompt=list(range(1, 21)), max_new=8, rid=0))
    with pytest.raises(tkvs.OutOfPages, match="decode page pool"):
        d2.run()


def test_unserved_records_at_max_steps(params):
    """Requests still queued or pending when max_steps runs out end in a
    terminal "unserved" state instead of vanishing."""
    arrivals = [(0, Request(prompt=[2] * 8, max_new=6, rid=0)),
                (1, Request(prompt=[3] * 8, max_new=6, rid=1)),
                (500, Request(prompt=[4] * 4, max_new=2, rid=2))]
    sess = session(params, batch_slots=1, scheduler={"chunk": 4},
                   resil=True)
    with pytest.warns(RuntimeWarning, match="max_steps"):
        sess.run_workload(arrivals, max_steps=3, on_incomplete="warn")
    by_rid = {r["rid"]: r for r in sess.records}
    assert len(by_rid) == 3
    assert by_rid[2]["state"] == "unserved" and by_rid[2]["n_generated"] == 0
    states = {r["state"] for r in sess.records}
    assert states <= {"completed", "unserved"} and "unserved" in states
    assert schd.summarize(sess.records, 1.0, 3)["outcomes"]["unserved"] >= 2
    d = mk_disagg(params, True)
    with pytest.warns(RuntimeWarning, match="max_steps"):
        d.run_workload([(0, Request(prompt=[2] * 8, max_new=6, rid=0)),
                        (900, Request(prompt=[3] * 4, max_new=2, rid=1))],
                       max_steps=2, on_incomplete="warn")
    st_ = {r["rid"]: r["state"] for r in d.records}
    assert st_[0] == "unserved" and st_[1] == "unserved"


# ------------------------------------------------------ resil=None path
#: the serve of `test_resil_none_is_unchanged` before the resilience layer
#: was ported: its greedy tokens, and the sha256 of its exported trace,
#: the scheduling fields and key set of its records and its stats
UNCHANGED_TOKENS = [
    [241, 241, 193, 38, 194, 215, 193, 30, 193, 241, 133, 116],
    [7, 140, 98, 220, 213, 226, 140, 25, 140, 25, 140, 25, 140],
    [84, 114, 84, 114, 93, 114, 84, 114, 93, 170],
    [231, 129, 196, 84, 247, 75, 180, 66, 163, 84, 255, 241, 180, 65],
    [7, 116, 31, 140, 239, 140, 10, 231, 140, 10, 136, 151, 226],
    [107, 165, 107, 165, 107, 180, 157, 37, 253, 129, 107, 55, 165, 87, 111]]
UNCHANGED_DIGEST = \
    "82ce43d4e5b6c77547de8e8f433a341c66f693341a9713ef7fb18ac30f9e414d"
UNCHANGED_FIELDS = ("rid", "prompt_len", "max_new", "submit_step",
                    "admit_step", "first_token_step", "n_generated",
                    "preemptions", "prefix_pages", "state", "failed_reason",
                    "retries")


def test_resil_none_is_unchanged(jparams, params):
    """``resil=None`` is the serving path from before the layer: the same
    tokens, the same trace, records and stats byte for byte (pinned
    above), the reference's trace, and no resilience field anywhere."""
    s = session(params, scheduler={"chunk": 4}, obs=tobs.Tracer(),
                resil=None)
    res = s.run_workload(burst_arrivals())
    assert [r.tokens for r in res] == UNCHANGED_TOKENS
    doc = {"trace": s.tracer.to_chrome(),
           "records": [{k: r[k] for k in UNCHANGED_FIELDS}
                       for r in s.records],
           "keys": sorted(s.records[0]), "stats": s.stats}
    assert hashlib.sha256(json.dumps(doc, sort_keys=True).encode()
                          ).hexdigest() == UNCHANGED_DIGEST
    js = JSession(JCFG, jparams, batch_slots=2, max_len=ML, page_size=PS,
                  scheduler={"chunk": 4}, obs=jobs.Tracer())
    js.run_workload([(t, JRequest(prompt=list(r.prompt), max_new=r.max_new,
                                  rid=r.rid)) for t, r in burst_arrivals()])
    assert s.tracer.to_chrome() == js.tracer.to_chrome()
    assert s.resil is None and s.resil_summary() is None and not s.failed
    assert all("deadline_tick" not in r for r in s.records)


# ------------------------------------------------- churn sweep (oracle)
def serial_baseline(params, reqs):
    """Each request alone, one token at a time: the oracle schedule."""
    out = {}
    for r in reqs:
        sess = session(params, batch_slots=1)
        sess.submit(dataclasses.replace(r, rid=0))
        out[r.rid] = sess.run()[0].tokens
    return [out[r.rid] for r in sorted(reqs, key=lambda r: r.rid)]


@settings(max_examples=4, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 9999),
       preset=st.sampled_from(["page-spike", "straggler", "role-stall"]),
       chunk=st.sampled_from([2, 4, 8]))
@example(seed=115, preset="page-spike", chunk=2)
def test_prop_churn_faults_drain_clean(params, seed, preset, chunk):
    """Any fault preset x seed x chunk over a pool below three worst-case
    needs: the serve completes with the port's serial oracle's tokens and
    drains with zero leaks and exact refcounts.  (The reference fails its
    own ``seed=115, page-spike, chunk=2`` example by a jitted near-tie;
    the port holds it exactly.)"""
    spec = schd.WorkloadSpec(n_requests=6, prompt_len=(2, 12),
                             max_new=(1, 8), arrival="poisson",
                             vocab=CFG.vocab, seed=seed)
    arrivals = schd.generate(spec)
    base = serial_baseline(params, [r for _, r in arrivals])
    need = schd.page_need(12, 8, ML, PS)
    sess = session(params, batch_slots=3, kv_pool_pages=1 + 2 * need,
                   scheduler={"chunk": chunk},
                   resil={"fault_plan": f"{preset}:{seed}",
                          "watchdog_every": 4, "max_retries": 2})
    got = sess.run_workload(arrivals)
    assert [r.tokens for r in got] == base
    assert sess.alloc.in_use == 0
    alloc_invariant(sess.alloc)
    assert rsl.audit_session(sess) == []
