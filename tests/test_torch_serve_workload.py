"""Port parity for timed traffic: ``Session.run_workload`` of the port (on
the CPU, every kernel's plain version) against the JAX package's on the
same weights and workloads — scheduling-clock fields of every record,
stats counters, exported tick-clock traces and greedy tokens — plus the
prefix cache over shared pages, preemption, the no-silent-drop contract,
sampling, a property sweep against the port's own serial oracle and the
launcher against the reference launcher."""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro import obs as jobs
from repro.api import env as jenv
from repro.api.session import Request as JRequest
from repro.api.session import Session as JSession
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import kvstore as tkvs
from repro_torch import obs as tobs
from repro_torch import sched as tschd
from repro_torch.api import Engine, Request
from repro_torch.api.session import Session
from repro_torch.configs import get, reduced

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
PS = 4          # page size: small, so short prompts still span pages
ML = 48         # max_len
SLOTS = 3
#: near-tie bound: greedy streams may first differ only where the port's
#: top-2 logit margin is below this (a tie that rounding may flip)
TIE = 1e-2
#: logits rows against the reference's jitted step, where XLA keeps fused
#: bf16 intermediates in f32: within 6e-2 on every row and 1e-2 on average
#: (the bound of tests/test_torch_decode.py)
ROW_ATOL, ROW_MEAN = 6e-2, 1e-2
#: the one flip of the grid at a margin of 1e-2 or more, as (preset, chunk,
#: policy, rid, position): margin 0.0319, its rows 0.0404 apart at most and
#: 0.0093 on average; under 2 * ROW_ATOL, so the jitted reference's excess
#: precision can flip it
JIT_FLIPS = {("heterogeneous", 8, "fifo", 1, 10),
             ("heterogeneous", 8, "sjf", 1, 10)}
#: record fields set by the scheduling clock alone (no wall time)
SCHED_FIELDS = ("rid", "prompt_len", "max_new", "submit_step", "admit_step",
                "first_token_step", "n_generated", "preemptions",
                "prefix_pages", "state")


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.from_reference(jax.tree.map(np.asarray, jparams))


@pytest.fixture
def pallas_paged():
    """Route the reference's paged attention (decode and chunks of 4 and
    8) through its Pallas kernels, the arithmetic the port's K2 / K3 keep,
    instead of its untuned XLA gather; the tuner cache is restored
    afterwards."""
    saved = dict(jtune._CACHE)
    geo = (JCFG.n_kv, JCFG.n_heads // JCFG.n_kv, JCFG.head_dim, PS,
           -(-ML // PS), SLOTS)
    jtune.record(jtune.paged_key(*geo, False, True),
                 jtune.KernelChoice("pallas", (("pb", 2),)))
    for chunk in (4, 8):
        jtune.record(jtune.paged_chunk_key(*geo, chunk, False, True),
                     jtune.KernelChoice("pallas", (("pb", 2),
                                                   ("qt", chunk))))
    yield
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def _port_session(params, cfg=CFG, **kw):
    kw.setdefault("batch_slots", SLOTS)
    kw.setdefault("max_len", ML)
    kw.setdefault("page_size", PS)
    return Session(cfg, params, device="cpu", **kw)


def _jreqs(arrivals):
    return [(s, JRequest(prompt=list(r.prompt), max_new=r.max_new,
                         temperature=r.temperature, rid=r.rid))
            for s, r in arrivals]


def _tokens_agree(ref, out, margins):
    """Greedy streams agree, or first differ at a step whose top-2 logit
    margin is below ``TIE`` (a near-tie that rounding may flip)."""
    assert [r.rid for r in ref] == [o.rid for o in out]
    for r, o in zip(ref, out):
        assert len(r.tokens) == len(o.tokens)
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            if a != b:
                assert margins[o.rid][j] < TIE, (o.rid, j)
                break


def _capture(sess):
    """Keep every logits row ``sess`` emits a token from, by (rid,
    position)."""
    rows, emit = {}, sess._emit

    def keep(i, logits_i, now):
        key = (sess.slot_entry[i].req.rid, len(sess.slot_out[i]))
        rows[key] = np.array(logits_i, np.float32)
        emit(i, logits_i, now)
    sess._emit = keep
    return rows


def _rows_agree(ref, out, margins, jrows, trows, case=()):
    """Greedy streams agree, or first differ at a near-tie (a margin below
    ``TIE``, or one of ``JIT_FLIPS``); every logits row up to and with the
    first difference, where both sides saw the same tokens, is within
    ``ROW_ATOL`` of the reference's and within ``ROW_MEAN`` on average."""
    assert [r.rid for r in ref] == [o.rid for o in out]
    means = []
    for r, o in zip(ref, out):
        assert len(r.tokens) == len(o.tokens)
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            gap = np.abs(trows[o.rid, j] - jrows[r.rid, j])
            assert gap.max() < ROW_ATOL, (o.rid, j, gap.max())
            means.append(gap.mean())
            if a != b:
                assert (margins[o.rid][j] < TIE
                        or case + (o.rid, j) in JIT_FLIPS), \
                    (o.rid, j, margins[o.rid][j])
                break
    assert np.mean(means) < ROW_MEAN


def _sched_view(records):
    return [{k: r.get(k) for k in SCHED_FIELDS} for r in records]


def _assert_same_run(jsess, tsess, ref, got, jrows, trows, case=()):
    """Records' scheduling fields, stats counters, exported traces, logits
    rows and greedy tokens: the reference's."""
    _rows_agree(ref, got, tsess.margins, jrows, trows, case)
    assert _sched_view(tsess.records) == _sched_view(jsess.records)
    assert {k: tsess.stats[k] for k in jsess.stats} == jsess.stats
    assert tsess.tracer.to_chrome() == jsess.tracer.to_chrome()


def alloc_invariant(alloc):
    assert len(set(alloc._free)) == len(alloc._free)
    assert not set(alloc._free) & alloc._used
    assert len(alloc._free) + alloc.in_use == alloc.n_pages - 1


# ------------------------------------------------------ workload parity
@pytest.mark.parametrize("policy", ["fifo", "sjf"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("preset,prefix_cache", [
    ("heterogeneous", False), ("burst", False), ("shared-prefix", True)])
def test_run_workload_matches_reference(jparams, tparams, pallas_paged,
                                        preset, prefix_cache, chunk, policy):
    """The same timed workload through both sessions, traced: every
    record's scheduling-clock fields, the stats counters and the exported
    tick-clock trace equal; logits rows and greedy tokens agree with the
    jitted reference's (``_rows_agree``); no page leaks (the prefix
    cache's own pins aside)."""
    arrivals = tschd.generate(tschd.WorkloadSpec.preset(
        preset, n_requests=6, vocab=CFG.vocab, seed=chunk))
    sched = {"chunk": chunk, "policy": policy, "prefix_cache": prefix_cache}
    jsess = JSession(JCFG, jparams, batch_slots=SLOTS, max_len=ML,
                     page_size=PS, scheduler=sched, obs=jobs.Tracer())
    jrows = _capture(jsess)
    ref = jsess.run_workload(_jreqs(arrivals))
    tsess = _port_session(tparams, scheduler=sched, obs=tobs.Tracer())
    trows = _capture(tsess)
    got = tsess.run_workload(arrivals)
    _assert_same_run(jsess, tsess, ref, got, jrows, trows,
                     (preset, chunk, policy))
    assert tobs.analyze(tsess.tracer).to_json() == \
        jobs.analyze(jsess.tracer).to_json()
    assert all(r["state"] == "completed" for r in tsess.records)
    if prefix_cache:
        assert tsess.stats["prefix_pages_reused"] > 0
        assert tsess.alloc.in_use == tsess.prefix.pages
        tsess.prefix.clear(tsess.alloc)
    assert tsess.alloc.in_use == 0
    alloc_invariant(tsess.alloc)


def test_run_workload_tokens_match_op_by_op(jparams, tparams, pallas_paged):
    """Against the reference run op by op (``jax.disable_jit``) with its
    paged attention on the Pallas kernels, which round to bf16 where the
    port does: greedy tokens equal up to near-tie flips at a top-2 margin
    below 1e-2, and the same run.  (Op by op the reference is slow: one
    small workload.)"""
    arrivals = tschd.generate(tschd.WorkloadSpec(
        n_requests=3, prompt_len=(3, 9), max_new=(2, 6), arrival="poisson",
        vocab=CFG.vocab, seed=11))
    sched = {"chunk": 4, "policy": "sjf"}
    with jax.disable_jit():
        jsess = JSession(JCFG, jparams, batch_slots=SLOTS, max_len=ML,
                         page_size=PS, scheduler=sched, obs=jobs.Tracer())
        jrows = _capture(jsess)
        ref = jsess.run_workload(_jreqs(arrivals))
    tsess = _port_session(tparams, scheduler=sched, obs=tobs.Tracer())
    trows = _capture(tsess)
    got = tsess.run_workload(arrivals)
    _assert_same_run(jsess, tsess, ref, got, jrows, trows)


@pytest.mark.parametrize("chunk", [1, 4])
def test_shared_prefix_without_cache_matches_reference(jparams, tparams,
                                                       pallas_paged, chunk):
    """The shared-prefix workload with the cache off: the same runs, and
    the same tokens as with it on."""
    arrivals = tschd.generate(tschd.WorkloadSpec.preset(
        "shared-prefix", n_requests=5, vocab=CFG.vocab, seed=3))
    sched = {"chunk": chunk}
    jsess = JSession(JCFG, jparams, batch_slots=SLOTS, max_len=ML,
                     page_size=PS, scheduler=sched, obs=jobs.Tracer())
    jrows = _capture(jsess)
    ref = jsess.run_workload(_jreqs(arrivals))
    tsess = _port_session(tparams, scheduler=sched, obs=tobs.Tracer())
    trows = _capture(tsess)
    got = tsess.run_workload(arrivals)
    _assert_same_run(jsess, tsess, ref, got, jrows, trows)
    cached = _port_session(tparams, scheduler={**sched,
                                               "prefix_cache": True})
    _tokens_agree(got, cached.run_workload(arrivals), cached.margins)
    assert cached.stats["prefix_hits"] > 0


def _pressure(pkg_session, params, cfg, **kw):
    need = tschd.page_need(PS, 2 * PS, ML, PS)
    sess = pkg_session(cfg, params, batch_slots=3, max_len=ML, page_size=PS,
                       kv_pool_pages=1 + 3 * need - 2, **kw)
    return sess


def test_preemption_under_small_pool_matches_reference(jparams, tparams,
                                                       pallas_paged):
    """Three slots over a pool below three worst-case needs: the same
    preemptions (youngest first, never rid 0), records and trace, greedy
    tokens equal, the pool drains."""
    reqs = [(0, Request(prompt=[2 + i] * PS, max_new=2 * PS, rid=i))
            for i in range(5)]
    jsess = _pressure(JSession, jparams, JCFG, obs=jobs.Tracer())
    jrows = _capture(jsess)
    ref = jsess.run_workload(_jreqs(reqs))
    tsess = _pressure(lambda c, p, **kw: Session(c, p, device="cpu", **kw),
                      tparams, CFG, obs=tobs.Tracer())
    trows = _capture(tsess)
    got = tsess.run_workload(reqs)
    _assert_same_run(jsess, tsess, ref, got, jrows, trows)
    preempted = [r["rid"] for r in tsess.records if r["preemptions"]]
    assert preempted and 0 not in preempted
    assert tsess.alloc.in_use == 0
    alloc_invariant(tsess.alloc)


def test_prefix_pins_released_before_preemption(tparams):
    """Under pressure the cache's pins go first, LRU-first: a pool that
    holds the cache's pages plus one request's need serves a second
    prefix without preempting anyone."""
    head = list(range(1, 9))
    reqs = [(0, Request(prompt=head + [50 + i] * 3, max_new=4, rid=i))
            for i in range(2)]
    reqs.append((0, Request(prompt=list(range(100, 111)), max_new=4,
                            rid=2)))
    need = tschd.page_need(11, 4, ML, PS)
    sess = _port_session(tparams, batch_slots=1, kv_pool_pages=1 + need,
                         scheduler={"chunk": 4, "prefix_cache": True})
    sess.run_workload(reqs)
    assert sess.stats["preemptions"] == 0
    assert sess.prefix.released > 0 and sess.stats["prefix_hits"] == 1
    sess.prefix.clear(sess.alloc)
    assert sess.alloc.in_use == 0


# ------------------------------------------------------- no silent drop
def test_run_raises_on_unfinished(tparams):
    sess = _port_session(tparams, batch_slots=1)
    for i in range(3):
        sess.submit(Request(prompt=[1, 2], max_new=20, rid=i))
    with pytest.raises(RuntimeError, match="unfinished"):
        sess.run(max_steps=5)
    assert [r["state"] for r in sess.records] == ["unserved"] * 3


def test_run_warn_reports_partial(tparams):
    sess = _port_session(tparams, batch_slots=1)
    sess.submit(Request(prompt=[1, 2], max_new=2, rid=0))
    sess.submit(Request(prompt=[3, 4], max_new=50, rid=1))
    with pytest.warns(RuntimeWarning, match="unfinished"):
        res = sess.run(max_steps=6, on_incomplete="warn")
    assert [r.rid for r in res] == [0]
    with pytest.raises(ValueError, match="on_incomplete"):
        sess.run(on_incomplete="drop")


def test_run_workload_counts_future_arrivals_as_unfinished(tparams):
    arrivals = [(0, Request(prompt=[1, 2], max_new=2, rid=0)),
                (50, Request(prompt=[3], max_new=2, rid=1))]
    sess = _port_session(tparams, batch_slots=1)
    with pytest.raises(RuntimeError, match="unfinished"):
        sess.run_workload(arrivals, max_steps=4)
    assert sess.records[-1]["rid"] == 1
    assert sess.records[-1]["state"] == "unserved"
    sess = _port_session(tparams, batch_slots=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = sess.run_workload(arrivals, max_steps=4,
                                on_incomplete="ignore")
    assert [r.rid for r in res] == [0]


def test_idle_fast_forward_keeps_step_count_honest(tparams):
    arrivals = [(0, Request(prompt=[1, 2], max_new=2, rid=0)),
                (30, Request(prompt=[3], max_new=2, rid=1))]
    sess = _port_session(tparams, batch_slots=1, obs=tobs.Tracer())
    res = sess.run_workload(arrivals)
    assert len(res) == 2
    assert sess.stats["steps"] == 5   # 3 calls for rid 0 + 2 for rid 1
    assert [r["submit_step"] for r in sess.records] == [0, 3]
    ticks = [e["tick"] for e in sess.tracer.events
             if e["name"] == "req.submit"]
    assert ticks == [0, 30]


def test_oversized_request_raises_and_dumps_the_recorder(tparams, tmp_path):
    """A request larger than the pool is refused up front: OutOfPages,
    and the flight recorder's ring is written."""
    rec = tobs.FlightRecorder(capacity=8, out_dir=str(tmp_path))
    sess = _port_session(tparams, batch_slots=2, kv_pool_pages=3,
                         obs=tobs.Tracer(recorder=rec))
    sess.submit(Request(prompt=[1, 2, 3, 4, 5], max_new=8, rid=0))
    with pytest.raises(tkvs.OutOfPages):
        sess.run()
    assert len(rec.dumps) == 1
    dump = json.load(open(rec.dumps[0]))
    assert dump["reason"] == "OutOfPages"
    assert dump["events"][-1]["name"] == "sched.block"


# ---------------------------------------------------- prefix page bytes
def test_attached_page_equals_the_page_written_alone(tparams):
    """Serve request 0 alone, then request 1 alone with the cache on:
    the page request 1 attaches equals, bit for bit, the page it writes
    when served alone with the cache off."""
    arrivals = tschd.generate(tschd.WorkloadSpec.preset(
        "shared-prefix", n_requests=2, vocab=CFG.vocab, seed=0))
    r0, r1 = (r for _, r in arrivals)
    ps = 16
    cached = _port_session(tparams, page_size=ps,
                           scheduler={"chunk": 8, "prefix_cache": True})
    cached.submit(r0)
    cached.run()
    cached.submit(r1)
    rows = []
    attach = cached._attach_prefix

    def keep(i, entry):
        attach(i, entry)
        rows.append(cached.host_table[i].copy())
    cached._attach_prefix = keep
    cached.run()
    assert cached.stats["prefix_pages_reused"] == 1
    shared = int(rows[0][0])
    alone = _port_session(tparams, page_size=ps, scheduler={"chunk": 8})
    written = []
    release = alone._release_slot_pages

    def snap(i):
        if alone.host_table[i][0] >= 0:
            written.append(int(alone.host_table[i][0]))
        release(i)
    alone._release_slot_pages = snap
    alone.submit(r1)
    alone.run()
    own = written[0]
    for name in ("k_pages", "v_pages"):
        a = getattr(cached.state["layers"]["kv"], name)[:, shared]
        b = getattr(alone.state["layers"]["kv"], name)[:, own]
        assert torch.equal(a, b), name


# ------------------------------------------------------------- sampling
def test_sampling_matches_softmax_distribution(tparams):
    """20,000 seeded draws from one logits row against softmax(l / T):
    chi-squared over the bins well inside its 99.9 % bound."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=12).astype(np.float32) * 2
    T = 0.8
    sess = _port_session(tparams, seed=5)
    n = 20_000
    draws = np.array([sess._sample(logits, T) for _ in range(n)])
    p = np.exp(logits.astype(np.float64) / T)
    p /= p.sum()
    counts = np.bincount(draws, minlength=len(p))
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 31.26        # chi-squared, 11 dof, p = 0.001


def test_sampling_repeats_with_the_seed(tparams):
    """Two sessions with one seed give the same sampled tokens, all in the
    vocabulary; another seed another stream; temperature 0 is greedy;
    only sampled tokens advance the generator."""
    def serve(seed, temperature):
        sess = _port_session(tparams, seed=seed, scheduler={"chunk": 4})
        sess.submit(Request(prompt=[5, 6, 7, 8, 9], max_new=12,
                            temperature=temperature, rid=0))
        sess.submit(Request(prompt=[3, 4], max_new=6, rid=1))
        return sess.run(), sess
    a, sa = serve(7, 0.8)
    b, _ = serve(7, 0.8)
    c, _ = serve(8, 0.8)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert a[0].tokens != c[0].tokens
    assert all(0 <= t < CFG.vocab for t in a[0].tokens)
    greedy, gs = serve(7, 0.0)
    assert greedy[1].tokens == a[1].tokens        # greedy rid 1 unmoved
    eng = Engine(CFG, params=tparams, device="cpu")
    ref = eng.serve([Request(prompt=[5, 6, 7, 8, 9], max_new=12, rid=0),
                     Request(prompt=[3, 4], max_new=6, rid=1)],
                    batch_slots=SLOTS, max_len=ML, scheduler={"chunk": 4})
    assert [r.tokens for r in greedy] == [r.tokens for r in ref]
    fresh = torch.Generator().manual_seed(7).get_state()
    assert torch.equal(gs.gen.get_state(), fresh)   # greedy draws nothing
    assert not torch.equal(sa.gen.get_state(), fresh)


# ------------------------------------------------------------- rwkv6
def test_recurrent_session_takes_workloads_and_sampling():
    """rwkv6 (no pages, no prefix cache): run_workload, records and the
    trace equal the reference's scheduling fields, against the reference
    op by op (jitted, its fused recurrence parts logits rows by up to
    9e-2, beyond ``ROW_ATOL``; op by op they agree within 1e-6); sampling
    repeats."""
    jcfg, cfg = jreduced(jget("rwkv6-7b")), reduced(get("rwkv6-7b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_reference(jax.tree.map(np.asarray, jp))
    arrivals = tschd.generate(tschd.WorkloadSpec.preset(
        "burst", n_requests=4, max_new=(2, 5), prompt_len=(2, 6),
        vocab=cfg.vocab, seed=1))
    with jax.disable_jit():
        jsess = JSession(jcfg, jp, batch_slots=2, max_len=ML,
                         scheduler="sjf", obs=jobs.Tracer())
        jrows = _capture(jsess)
        ref = jsess.run_workload(_jreqs(arrivals))
    tsess = _port_session(tp, cfg, batch_slots=2, scheduler="sjf",
                          obs=tobs.Tracer())
    trows = _capture(tsess)
    got = tsess.run_workload(arrivals)
    _assert_same_run(jsess, tsess, ref, got, jrows, trows)
    assert tsess.alloc is None and tsess.prefix is None
    hot = [(s, dataclasses.replace(r, temperature=1.0)) for s, r in arrivals]
    runs = [_port_session(tp, cfg, batch_slots=2, seed=3).run_workload(hot)
            for _ in range(2)]
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]


# ------------------------------------------------- serial-oracle sweep
def serial_baseline(params, reqs):
    """Each request alone, one token at a time: the oracle schedule."""
    out = {}
    for r in reqs:
        sess = _port_session(params, batch_slots=1)
        sess.submit(dataclasses.replace(r, rid=0))
        res, = sess.run()
        out[r.rid] = (res.tokens, sess.margins[0])
    return [out[r.rid] for r in sorted(reqs, key=lambda r: r.rid)]


@settings(max_examples=6, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 9999), chunk=st.sampled_from([2, 5, 8]),
       policy=st.sampled_from(["fifo", "sjf"]),
       arrival=st.sampled_from(["batch", "poisson"]), n=st.integers(1, 5))
@example(seed=578, chunk=2, policy="fifo", arrival="batch", n=1)
@example(seed=7163, chunk=2, policy="fifo", arrival="poisson", n=3)
def test_prop_scheduler_matches_serial(tparams, seed, chunk, policy,
                                       arrival, n):
    """Any schedule x policy x chunk: the batched, scheduled serve gives
    the serial one-at-a-time baseline's tokens, and the pool drains."""
    spec = tschd.WorkloadSpec(n_requests=n, prompt_len=(1, 20),
                              max_new=(1, 10), arrival=arrival,
                              vocab=CFG.vocab, seed=seed)
    arrivals = tschd.generate(spec)
    base = serial_baseline(tparams, [r for _, r in arrivals])
    sess = _port_session(tparams,
                         scheduler={"chunk": chunk, "policy": policy})
    got = sess.run_workload(arrivals)
    assert [r.tokens for r in got] == [tokens for tokens, _ in base]
    assert sess.alloc.in_use == 0
    alloc_invariant(sess.alloc)


# -------------------------------------------------------------- launcher
LAUNCH = ["--arch", "qwen1.5-0.5b", "--compress", "aida", "--workload",
          "shared-prefix", "--prefix-cache", "--policy", "sjf", "--chunk",
          "8"]
#: summarize() fields that depend on the scheduling clock alone
SCHED_METRICS = ("requests", "completed", "tokens", "steps", "ttft_sched",
                 "queue_wait_sched", "first_token_calls", "preemptions",
                 "prefix_pages_reused", "outcomes")


def test_launcher_matches_reference_launcher(tmp_path, monkeypatch):
    """``main([... "--device", "cpu"])`` in-process against the reference
    launcher on the same arguments (its autotuner off: timing only): the
    same scheduling metrics, the same trace; all requests complete, no
    page leaks; the provenance names torch and no jax."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    t = {k: str(tmp_path / f"t_{k}.json") for k in ("json", "trace")}
    j = {k: str(tmp_path / f"j_{k}.json") for k in ("json", "trace")}
    assert tserve.main(LAUNCH + ["--device", "cpu", "--json", t["json"],
                                 "--trace", t["trace"]]) == 0
    monkeypatch.setattr(jenv, "AUTOTUNE", False)
    monkeypatch.setattr("sys.argv", ["serve"] + LAUNCH + [
        "--json", j["json"], "--trace", j["trace"]])
    jserve.main()
    got, ref = (json.load(open(d["json"])) for d in (t, j))
    assert {k: got["metrics"][k] for k in SCHED_METRICS} == \
        {k: ref["metrics"][k] for k in SCHED_METRICS}
    assert got["metrics"]["completed"] == got["metrics"]["requests"] == 8
    assert got["metrics"]["prefix_pages_reused"] > 0
    assert got["pages"]["leaked"] == 0
    assert "jax" not in got["provenance"]
    assert got["provenance"]["torch"] == torch.__version__
    assert got["provenance"]["backend"] == "torch-cpu"
    assert json.load(open(t["trace"])) == json.load(open(j["trace"]))


def test_launcher_refuses_the_cpu_without_asking(capsys):
    """No card and no --device cpu: a non-zero exit with resolve_device's
    message, nothing served."""
    from repro_torch.launch import serve as tserve
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen1.5-0.5b"])
    assert e.value.code != 0
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "requests" not in err.out
