"""The port's host-side traffic modules against the JAX package's on the
same inputs: the workload generator, prefix page hashes, the refcounted
allocator and prefix cache, the scheduler's policies, serving metrics,
the tick-clock tracer, trace analysis and the flight recorder.  None of
them touches a model: both packages' modules are pure Python here."""
import json

import pytest

from repro import obs as jobs
from repro import sched as jschd
from repro.api.session import Request as JRequest
from repro.kvstore import PageAllocator as JPageAllocator
from repro_torch import kvstore as tkvs
from repro_torch import obs as tobs
from repro_torch import sched as tschd
from repro_torch.api.spec import Request


def _reqs(arrivals):
    return [(step, r.prompt, r.max_new, r.temperature, r.rid)
            for step, r in arrivals]


# ------------------------------------------------------------- workloads
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("preset", jschd.workload.PRESETS)
def test_generate_matches_reference(preset, seed):
    """Every preset at three seeds: the same arrival steps, prompt tokens,
    max_new and rids, drawn from the same generator calls."""
    kw = dict(n_requests=9, vocab=300, seed=seed)
    ref = jschd.generate(jschd.WorkloadSpec.preset(preset, **kw))
    got = tschd.generate(tschd.WorkloadSpec.preset(preset, **kw))
    assert _reqs(got) == _reqs(ref)
    assert all(isinstance(t, int) for _, r in got for t in r.prompt)
    assert all(isinstance(r, Request) for _, r in got)


def test_timed_requests_and_spec_checks_match():
    ref = jschd.timed_requests("burst", n_requests=5, seed=2, temperature=0.5)
    got = tschd.timed_requests("burst", n_requests=5, seed=2, temperature=0.5)
    assert _reqs(got) == _reqs(ref)
    spec = tschd.WorkloadSpec(n_requests=3, seed=4)
    assert _reqs(tschd.timed_requests(spec, seed=5)) == _reqs(
        jschd.timed_requests(jschd.WorkloadSpec(n_requests=3, seed=4),
                             seed=5))
    assert _reqs(tschd.timed_requests(None, n_requests=2)) == _reqs(
        jschd.timed_requests(None, n_requests=2))
    with pytest.raises(ValueError, match="unknown workload preset"):
        tschd.WorkloadSpec.preset("nope")


# ------------------------------------------------------------- the trace
def _lifecycle(tr):
    """The same tick-clock event stream into either package's tracer:
    five requests with a block, a preemption and re-admission, allocator
    and prefix-cache events, spans of both kinds, a warm-up request and
    one request still in flight at the end."""
    tr.instant("req.submit", tick=0, rid=-1, prompt_len=2, max_new=1)
    for rid, (tick, plen, mnew) in enumerate(
            [(0, 5, 3), (0, 9, 2), (2, 4, 4), (3, 12, 2), (9, 3, 6)]):
        tr.instant("req.submit", tick=tick, rid=rid, prompt_len=plen,
                   max_new=mnew)
    tr.instant("sched.admit", tick=0, slot=0, rid=0, resumed=0)
    tr.instant("alloc.pages", tick=0, n=1, in_use=1)
    tr.instant("sched.block", tick=0, rid=1, queued=3)
    tr.span("step.prefill", tick=0, active=1, tokens=5, step=1)
    tr.instant("req.first_token", tick=0, slot=0, rid=0)
    tr.instant("sched.admit", tick=1, slot=1, rid=1, resumed=0)
    tr.instant("alloc.pages", tick=1, n=1, in_use=2)
    tr.instant("alloc.pages", tick=1, n=1, in_use=3)
    tr.span("step.prefill", tick=1, active=2, tokens=9, step=2)
    tr.instant("prefix.pin", tick=1, page=2, pinned=1)
    tr.instant("sched.admit", tick=2, slot=2, rid=2, resumed=0)
    tr.instant("prefix.hit", tick=2, page=2)
    tr.span("step.decode", tick=2, active=3, step=3)
    tr.instant("req.first_token", tick=2, slot=1, rid=1)
    tr.instant("sched.preempt", tick=3, slot=2, rid=2, generated=1)
    tr.instant("alloc.free", tick=3, n=1, in_use=2)
    tr.span("step.decode", tick=3, active=2, step=4)
    tr.instant("req.finish", tick=3, slot=0, rid=0, tokens=3)
    tr.instant("alloc.free", tick=3, n=1, in_use=1)
    tr.instant("sched.admit", tick=4, slot=0, rid=2, resumed=1)
    tr.instant("sched.admit", tick=4, slot=2, rid=3, resumed=0)
    tr.span("step.prefill", tick=4, active=3, tokens=16, step=5)
    tr.instant("req.first_token", tick=4, slot=2, rid=3)
    tr.instant("req.finish", tick=5, slot=1, rid=1, tokens=2)
    tr.span("step.decode", tick=5, active=2, step=6)
    tr.instant("req.first_token", tick=6, slot=0, rid=2)
    tr.instant("req.finish", tick=6, slot=2, rid=3, tokens=2)
    tr.span("step.decode", tick=6, active=2, step=7)
    tr.instant("prefix.release", tick=7, n=1, pinned=0)
    tr.instant("req.finish", tick=8, slot=0, rid=2, tokens=4)
    tr.span("step.decode", tick=9, active=1, step=8)
    return tr


def _tracers():
    return _lifecycle(jobs.Tracer()), _lifecycle(tobs.Tracer())


def test_trace_export_matches_reference(tmp_path):
    """Chrome export of the same event stream: the same document and the
    same bytes on disk; the events read back are the tracer's own."""
    jt, tt = _tracers()
    assert tt.to_chrome() == jt.to_chrome()
    a, b = tmp_path / "j.json", tmp_path / "t.json"
    jt.export(str(a))
    tt.export(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tobs.load_trace(str(b)) == jobs.load_trace(str(a))
    assert tobs.load_trace(str(b)) == [
        {**ev, "args": dict(ev["args"])} for ev in tt.events]


@pytest.mark.parametrize("slo", [None, "ttft_p99=3,tpot_p99=2,goodput=0.9",
                                 "ttft=1"])
def test_analyze_matches_reference(tmp_path, slo):
    """analyze() of the live tracer and of the exported file: the
    reference's report byte for byte, segments consistent."""
    jt, tt = _tracers()
    path = tmp_path / "t.json"
    tt.export(str(path))
    ref = jobs.analyze(jt, slo=slo).to_json()
    for src in (tt, str(path), json.loads(path.read_text())):
        rep = tobs.analyze(src, slo=slo)
        assert rep.to_json() == ref
        assert rep.segments_consistent()
    rep = tobs.analyze(tt, slo=slo)
    assert rep.requests["4"]["outcome"] == "unfinished"
    assert rep.requests["2"]["detours"] == {"preemptions": 1,
                                            "readmissions": 1}


@pytest.mark.parametrize("text", ["ttft_p99=40,tpot_p99=4,goodput=0.95",
                                  "ttft=7", " goodput = 1 ,", "bogus=1",
                                  "ttft", ""])
def test_slo_parse_matches_reference(text):
    try:
        ref = jobs.SLOSpec.parse(text).describe()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tobs.SLOSpec.parse(text)
        assert str(got.value) == str(e)
        return
    assert tobs.SLOSpec.parse(text).describe() == ref


def test_from_trace_replays_the_same_schedule(tmp_path):
    """from_trace() of a traced stream: the same schedule (warm-up rid
    dropped) and the same regenerated requests in both packages."""
    jt, tt = _tracers()
    path = tmp_path / "t.json"
    tt.export(str(path))
    ref = jschd.WorkloadSpec.from_trace(jt, vocab=100, seed=3)
    for src in (tt, str(path)):
        spec = tschd.WorkloadSpec.from_trace(src, vocab=100, seed=3)
        assert spec.schedule == ref.schedule == (
            (0, 5, 3), (0, 9, 2), (2, 4, 4), (3, 12, 2), (9, 3, 6))
        assert _reqs(tschd.generate(spec)) == _reqs(jschd.generate(ref))
    assert len(tschd.WorkloadSpec.from_trace(
        tt, include_warmup=True).schedule) == 6
    with pytest.raises(ValueError, match="no req.submit"):
        tschd.WorkloadSpec.from_trace([])


def test_null_tracer_and_wall_timers():
    assert not tobs.NULL.enabled and tobs.NULL.crash("x") is None
    tr = tobs.Tracer()
    with tr.wall.phase("decode"):
        pass
    with tr.wall.phase("decode"):
        pass
    summ = tr.wall.summary()
    assert summ["decode"]["calls"] == 2 and summ["decode"]["share"] == 1.0
    assert tr.events == []                 # wall time never enters it
    hook = tr.hook(role="prefill", clock=lambda: 5)
    hook("alloc.pages", n=1, in_use=1)
    assert tr.events[-1]["tick"] == 5 and tr.events[-1]["role"] == "prefill"


def test_flight_recorder_dump_matches_reference(tmp_path):
    jr = jobs.FlightRecorder(capacity=4, out_dir=str(tmp_path / "j"))
    tr = tobs.FlightRecorder(capacity=4, out_dir=str(tmp_path / "t"))
    _lifecycle(jobs.Tracer(capture=False, recorder=jr))
    tt = _lifecycle(tobs.Tracer(capture=False, recorder=tr))
    assert tt.events == [] and tr.total == jr.total
    a = jr.dump("OutOfPages", {"tick": 9})
    b = tt.crash("OutOfPages", tick=9)
    assert open(a).read() == open(b).read()
    assert tr.dump("OutOfPages") != b      # never overwrites


# ------------------------------------------------------------ prefix pages
@pytest.mark.parametrize("prompt,ps", [
    (list(range(1, 20)), 4), ([7] * 16, 16), ([5, 1, 2], 4),
    ([2 ** 40, -3, 0, 9, 9, 9], 2), (list(range(300, 340)), 8)])
def test_page_hashes_match_reference(prompt, ps):
    assert tschd.page_hashes(prompt, ps) == jschd.page_hashes(prompt, ps)
    for n in range(0, len(prompt) + 2):
        assert tschd.prefix.usable_prefix_pages(n, ps) == \
            jschd.prefix.usable_prefix_pages(n, ps)


def test_page_hash_chain_and_usable_pages():
    assert tschd.prefix.usable_prefix_pages(8, 4) == 1
    assert tschd.prefix.usable_prefix_pages(9, 4) == 2
    assert tschd.prefix.usable_prefix_pages(3, 4) == 0
    h1 = tschd.page_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    h2 = tschd.page_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4)
    assert h1[0] == h2[0] and h1[1] != h2[1]
    assert tschd.page_hashes([1, 2, 3], 4) == []


def _alloc_invariant(alloc):
    assert len(set(alloc._free)) == len(alloc._free)
    assert not set(alloc._free) & alloc._used
    assert len(alloc._free) + alloc.in_use == alloc.n_pages - 1


def test_prefix_refcounts_no_double_free():
    """The JAX package's refcount sequence, on the port's classes."""
    alloc = tkvs.PageAllocator(8)
    cache = tschd.PrefixCache()
    pid = alloc.alloc()
    assert cache.insert(b"h", pid, alloc)
    assert not cache.insert(b"h", pid, alloc)   # first writer wins
    assert alloc.refcount(pid) == 2
    alloc.free([pid])                           # sequence done
    assert alloc.in_use == 1                    # pin keeps it alive
    assert cache.lookup(b"h") == pid
    alloc.ref(pid)                              # second sequence attaches
    cache.release(alloc, 1)                     # pressure drops the pin
    assert cache.peek(b"h") is None
    assert alloc.in_use == 1                    # sequence still owns it
    alloc.free([pid])
    assert alloc.in_use == 0
    alloc.free([pid])                           # double free: no-op
    _alloc_invariant(alloc)
    with pytest.raises(ValueError):
        alloc.ref(pid)                          # can't resurrect


def _cache_ops(alloc, cache, events):
    """One mixed sequence of allocator and cache operations; returns the
    observable state after each step."""
    alloc.obs = cache.obs = lambda name, **a: events.append((name, a))
    out = []
    pids = alloc.alloc_many(4)
    for j, pid in enumerate(pids[:3]):
        cache.insert(bytes([j]), pid, alloc)
    out.append((alloc.in_use, alloc.available, cache.stats()))
    alloc.free(pids)
    out.append((cache.releasable(alloc), cache.releasable(alloc, [pids[0]])))
    hit = cache.lookup(bytes([1]))
    alloc.ref(hit)
    cache.lookup(b"x")
    out.append((cache.releasable(alloc), alloc.refcount(hit)))
    more = [alloc.alloc() for _ in range(3)]
    out.append((alloc.in_use, alloc.peak, alloc.total_allocs))
    cache.insert(b"y", more[0], alloc)
    cache.release(alloc, 1)
    out.append((cache.pages, cache.stats()))
    alloc.free(more + [hit])
    out.append((cache.clear(alloc), alloc.in_use, sorted(alloc._free)))
    with pytest.raises(Exception) as e:
        alloc.alloc_many(alloc.n_pages)
    out.append(type(e.value).__name__)
    return out


def test_allocator_and_cache_match_reference():
    """The same operations on both packages' allocator and cache: the same
    counts, page ids, stats and events."""
    jev, tev = [], []
    ref = _cache_ops(JPageAllocator(9), jschd.PrefixCache(), jev)
    got = _cache_ops(tkvs.PageAllocator(9), tschd.PrefixCache(), tev)
    assert got == ref and tev == jev
    a = tkvs.PageAllocator(4)
    assert a.holdback == 0 and a.available == 3
    with pytest.raises(ValueError, match=">= 0"):
        a.alloc_many(-1)
    with pytest.raises(tkvs.OutOfPages, match="requested"):
        a.alloc_many(4)
    assert a.in_use == 0                        # all or nothing


# ------------------------------------------------------------- scheduler
def _sched(pkg, **kw):
    return pkg.Scheduler(pkg.SchedConfig(**kw))


def test_sjf_policy_orders_by_prompt_length():
    s = _sched(tschd, policy="sjf")
    for rid, n in enumerate([9, 3, 6]):
        s.submit(Request(prompt=[1] * n, rid=rid))
    assert [s.next_entry(lambda e: True).req.rid for _ in range(3)] == \
        [1, 2, 0]


def test_fifo_head_of_line_blocks():
    s = _sched(tschd, policy="fifo")
    s.submit(Request(prompt=[1] * 9, rid=0))
    s.submit(Request(prompt=[1], rid=1))
    assert s.next_entry(lambda e: len(e.req.prompt) < 5) is None
    assert s.stats["admission_blocks"] == 1 and len(s) == 2


def test_sjf_aging_promotes_starved_long_prompt():
    s = _sched(tschd, policy="sjf", sjf_age_limit=5)
    s.submit(Request(prompt=[1] * 9, rid=0), step=0)
    s.submit(Request(prompt=[1] * 2, rid=1), step=1)
    assert s.next_entry(lambda e: True, step=3).req.rid == 1
    s.submit(Request(prompt=[1] * 2, rid=2), step=4)
    assert s.next_entry(lambda e: True, step=6).req.rid == 0
    assert s.next_entry(lambda e: True, step=6).req.rid == 2


def test_sjf_aged_head_blocks_like_fifo():
    s = _sched(tschd, policy="sjf", sjf_age_limit=2)
    s.submit(Request(prompt=[1] * 9, rid=0), step=0)
    s.submit(Request(prompt=[1], rid=1), step=0)
    fits = lambda e: len(e.req.prompt) < 5            # noqa: E731
    assert s.next_entry(fits, step=1).req.rid == 1
    s.submit(Request(prompt=[1], rid=2), step=1)
    events = []
    s.obs = lambda name, **a: events.append((name, a))
    assert s.next_entry(fits, step=5) is None
    assert len(s) == 2 and s.stats["admission_blocks"] == 1
    assert events == [("sched.block", {"rid": 0, "queued": 2})]


def test_sjf_age_limit_none_never_promotes():
    s = _sched(tschd, policy="sjf", sjf_age_limit=None)
    s.submit(Request(prompt=[1] * 9, rid=0), step=0)
    s.submit(Request(prompt=[1], rid=1), step=10_000)
    assert s.next_entry(lambda e: True, step=10_000).req.rid == 1
    with pytest.raises(ValueError, match="sjf_age_limit"):
        tschd.SchedConfig(policy="sjf", sjf_age_limit=0)
    with pytest.raises(ValueError, match="unknown policy"):
        tschd.SchedConfig(policy="lifo")


def _drive(pkg, req_cls, policy):
    """One scripted queue history: submits at steps, a fits predicate
    that refuses long prompts early, a requeue, victims, deadlines,
    shedding; returns every decision."""
    s = _sched(pkg, policy=policy, sjf_age_limit=4)
    out = []
    lens = [7, 2, 5, 1, 9, 3, 3, 6]
    for rid, n in enumerate(lens):
        s.submit(req_cls(prompt=[1] * n, max_new=2, rid=rid), step=rid // 2)
    live = []
    for step in range(0, 12, 2):
        fits = (lambda e: len(e.req.prompt) < 6) if step < 6 \
            else (lambda e: True)
        e = s.next_entry(fits, step=step)
        out.append(None if e is None else (e.req.rid, e.seq))
        if e is not None:
            live.append(e)
        if step == 4 and live:
            victim = pkg.Scheduler.choose_victim(live)
            out.append(victim)
            s.requeue(live.pop(victim))
    out.append(pkg.Scheduler.choose_victim(live[:1]))
    s.queue[-1].deadline_tick = 3
    out.append([e.req.rid for e in s.pop_expired(4)])
    shed = s.shed_youngest()
    out.append(None if shed is None else shed.req.rid)
    out.append(([e.req.rid for e in s.queue], dict(s.stats)))
    return out


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_scheduler_decisions_match_reference(policy):
    assert _drive(tschd, Request, policy) == _drive(jschd, JRequest, policy)


def test_page_need_and_sched_config_coerce():
    for args in [(5, 8, 48, 4), (40, 20, 48, 4), (1, 1, 16, 16)]:
        assert tschd.page_need(*args) == \
            jschd.scheduler.page_need(*args)
    assert tschd.SchedConfig.coerce("sjf").policy == "sjf"
    assert tschd.SchedConfig.coerce({"chunk": 4, "prefix_cache": True}) \
        .prefix_cache
    with pytest.raises(TypeError):
        tschd.SchedConfig.coerce(3)


# --------------------------------------------------------------- metrics
def _records():
    """Lifecycle records of every shape summarize() folds: completed (one
    and several tokens), preempted, prefix hits, unserved, still queued."""
    recs = []
    for rid in range(7):
        recs.append({
            "rid": rid, "prompt_len": 5 + rid, "max_new": 4,
            "submit_step": rid, "submit_time": 0.5 * rid,
            "admit_step": rid + 1, "admit_time": 0.5 * rid + 0.1,
            "first_token_step": rid + 3, "first_token_time": 0.5 * rid + 0.7,
            "finish_time": 0.5 * rid + 1.3 + 0.01 * rid,
            "n_generated": 1 + rid % 4, "preemptions": rid % 3,
            "prefix_pages": 2 * (rid % 2), "state": "completed",
            "failed_reason": None, "retries": 0})
    recs[5].update(finish_time=None, n_generated=0, state="queued")
    recs[6].update(admit_step=None, admit_time=None, first_token_step=None,
                   first_token_time=None, finish_time=None, n_generated=0,
                   state="unserved", submit_step=None, submit_time=None)
    return recs


@pytest.mark.parametrize("span,steps", [(3.7, 20), (0.0, 0)])
def test_summarize_matches_reference(span, steps):
    recs = _records()
    got = tschd.summarize(recs, span, steps)
    assert got == jschd.summarize(recs, span, steps)
    assert set(tschd.metrics.SUMMARY_KEYS) <= set(got)
    assert tschd.summarize([], 0.0, 0) == jschd.summarize([], 0.0, 0)
    if span:
        assert got["completed"] == 5 and got["preemptions"] == 6
        assert got["outcomes"] == {"completed": 5, "queued": 1,
                                   "unserved": 1}
    else:
        assert got["tok_per_s"] is None and got["goodput_req_per_s"] is None


def test_percentile_and_registry_match_reference():
    xs = [float(v) for v in range(1, 101)]
    for q in (0, 1, 50, 90, 99, 100):
        assert tschd.percentile(xs, q) == jschd.percentile(xs, q)
    assert tschd.percentile([], 50) is None
    assert tschd.percentile([3.0], 99) == 3.0
    regs = []
    for pkg in (tobs, jobs):
        r = pkg.Registry()
        r.counter("a").inc(3)
        r.gauge("g").set(2.5)
        r.histogram("h").observe_many([0.1, 0.3, 0.2, 9.0])
        regs.append(r.snapshot())
    assert regs[0] == regs[1]


def test_provenance_names_torch_not_jax():
    p = tobs.provenance(config="c", mode="aida", seed=1,
                        backend="torch-cpu", device="cpu", workload="w")
    assert "jax" not in p and p["torch"] and p["card"] is None
    assert p["workload"] == "w" and p["timestamp"]


def test_timeit_times_a_cpu_call():
    calls = []
    t = tobs.timeit(lambda n: calls.append(n) or [n], 3, reps=2, inner=2)
    assert t >= 0 and len(calls) == 1 + 2 * 2
