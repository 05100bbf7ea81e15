"""Port parity for disaggregated prefill / decode serving
(`repro_torch.disagg`) against the JAX package's `repro.disagg`: the page
copy between pools (bf16 bit for bit, int8 codes and scales verbatim, the
reference's byte count and refusals), disaggregated greedy tokens against
the port's co-located serve (equal) and the reference's (up to near-tie
flips of its jitted step), one run field by field against the reference's
`DisaggSession`, back-pressure, the decode pool's reservation, int8
migration, sampling, the refusals, and the launcher's new flags.  Served
on the CPU (every kernel's plain version)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from repro import kvstore as jkvs
from repro import obs as jobs
from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import env as jenv
from repro.api.session import Request as JRequest
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.disagg import DisaggConfig as JDisaggConfig
from repro.disagg import DisaggSession as JDisaggSession
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import kvstore as kvs
from repro_torch import obs as tobs
from repro_torch import sched as schd
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.disagg import DisaggConfig, DisaggSession

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
PS = 4          # page size: small, so short prompts still span pages
ML = 48         # max_len
SPEC = dict(mode="aida", density=0.25)
#: near-tie bound for the reference's jitted step (its fused bf16
#: intermediates stay in f32): streams may first differ only where the
#: port's top-2 logit margin is below this
TIE = 1e-2


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


@pytest.fixture(scope="module")
def aida(params):
    """The port's engine, aida-compressed from the reference's raw
    weights."""
    return Engine(CFG, params=params, device="cpu").compress(
        CompressionSpec(**SPEC))


@pytest.fixture(scope="module")
def jaida(jparams):
    return JEngine(JCFG, params=jparams).compress(JSpec(**SPEC))


def mk_reqs(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=[int(t) for t in
                            rng.integers(1, CFG.vocab, 3 + 2 * i)],
                    max_new=int(rng.integers(2, 8)), rid=i)
            for i in range(n)]


def jreq(r):
    return JRequest(prompt=list(r.prompt), max_new=r.max_new, rid=r.rid)


def alloc_invariant(alloc):
    assert len(set(alloc._free)) == len(alloc._free)
    assert not set(alloc._free) & alloc._used
    assert len(alloc._free) + alloc.in_use == alloc.n_pages - 1


def drained(d: DisaggSession):
    """Both pools empty and consistent, and the decode role never
    preempted (back-pressure, not eviction)."""
    for alloc in (d.pre.alloc, d.dec.alloc):
        alloc_invariant(alloc)
        assert alloc.in_use == 0
    assert d.dec.stats["preemptions"] == 0


def disagg(params, cfg=CFG, d=None, **kw):
    return DisaggSession(cfg, params, disagg=d or DisaggConfig(),
                         device="cpu", max_len=ML, page_size=PS, **kw)


def colocated(eng_or_params, reqs, cfg=CFG, slots=4, **kw):
    if isinstance(eng_or_params, Engine):
        sess = eng_or_params.session(batch_slots=slots, max_len=ML,
                                     page_size=PS, **kw)
    else:
        sess = Engine(cfg, params=eng_or_params, device="cpu").session(
            batch_slots=slots, max_len=ML, page_size=PS, **kw)
    for r in reqs:
        sess.submit(dataclasses.replace(r))
    return [r.tokens for r in sess.run()]


def tokens_agree(ref, got, margins):
    """Greedy streams agree, or first differ where the port's top-2 logit
    margin is below ``TIE``."""
    assert len(ref) == len(got)
    for rid, (a_toks, b_toks) in enumerate(zip(ref, got)):
        assert len(a_toks) == len(b_toks)
        for j, (a, b) in enumerate(zip(a_toks, b_toks)):
            if a != b:
                assert margins[rid][j] < TIE, (rid, j, margins[rid][j])
                break


# ----------------------------------------------------------- copy_pages
def _random_pools(rng, kv_dtype, lead=()):
    shape = lead + (8, 2, PS, 4)
    if kv_dtype == "bf16":
        return jkvs.PagedKV(jnp.asarray(rng.normal(size=shape), jnp.bfloat16),
                            jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
    return jkvs.PagedKV(
        jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
        jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
        jnp.asarray(rng.random(shape[:-2]), jnp.float32),
        jnp.asarray(rng.random(shape[:-2]), jnp.float32))


def _port(pool):
    return bridge.from_reference(jax.tree.map(np.asarray, pool))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["layer", "stacked"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_copy_pages_matches_reference(kv_dtype, lead):
    """bf16 pages bit for bit, int8 codes and scales verbatim, into the
    destination pool in place; untouched pages stay as they were; the
    byte count is the reference's."""
    rng = np.random.default_rng(0)
    jsrc, jdst = _random_pools(rng, kv_dtype, lead), \
        _random_pools(rng, kv_dtype, lead)
    src, dst = _port(jsrc), _port(jdst)
    before = [t.clone() for t in dst if t is not None]
    ids = ([3, 5, 7], [1, 2, 6])
    jout, jmoved = jkvs.copy_pages(jsrc, jdst, *ids)
    out, moved = kvs.copy_pages(src, dst, *ids)
    assert out is dst and moved == jmoved > 0
    ax = len(lead)
    for name, got, ref, old in zip(out._fields, out, _port(jout), before):
        assert got.dtype == ref.dtype and torch.equal(got, ref), name
        for s, d in zip(*ids):
            assert torch.equal(got.select(ax, d),
                               getattr(src, name).select(ax, s)), name
        assert torch.equal(got.select(ax, 4), old.select(ax, 4)), name


def test_copy_pages_refuses_like_reference():
    """A page-size, head-dim or dtype mismatch and unequal id lists raise
    the reference's ValueError; no ids move nothing."""
    pools = {(ps, dh, dt): kvs.init_pool(4, 2, ps, dh, kv_dtype=dt)
             for ps, dh, dt in ((PS, 4, "bf16"), (2 * PS, 4, "bf16"),
                                (PS, 8, "bf16"), (PS, 4, "int8"))}
    jpools = {k: jkvs.init_pool(4, 2, k[0], k[1], kv_dtype=k[2])
              for k in pools}
    a = (PS, 4, "bf16")
    for b in list(pools)[1:]:
        with pytest.raises(ValueError, match="geometry mismatch"):
            kvs.copy_pages(pools[a], pools[b], [1], [1])
        with pytest.raises(ValueError, match="geometry mismatch"):
            jkvs.copy_pages(jpools[a], jpools[b], [1], [1])
    for pkg, p in ((kvs, pools[a]), (jkvs, jpools[a])):
        with pytest.raises(ValueError, match="2 source pages for 1"):
            pkg.copy_pages(p, p, [1, 2], [1])
        assert pkg.copy_pages(p, p, [], [])[1] == 0


def test_alloc_many_is_atomic():
    alloc = kvs.PageAllocator(5)      # 4 usable
    got = alloc.alloc_many(2)
    assert len(got) == 2 and alloc.in_use == 2
    with pytest.raises(kvs.OutOfPages):
        alloc.alloc_many(3)           # only 2 left: all or nothing
    assert alloc.in_use == 2 and alloc.available == 2
    alloc.free(got)
    alloc_invariant(alloc)


# -------------------------------------------------------- token parity
@pytest.mark.parametrize("chunk", [1, 4])
def test_aida_disagg_matches_colocated_and_reference(aida, jaida, chunk):
    """llama3-8b aida: disaggregated greedy tokens equal the port's
    co-located serve's under fifo and sjf, and agree with the reference's
    co-located serve up to near-tie flips of its jitted step; both pools
    drain."""
    reqs = mk_reqs()
    jsess = jaida.session(batch_slots=4, max_len=ML, page_size=PS,
                          scheduler={"chunk": chunk})
    for r in reqs:
        jsess.submit(jreq(r))
    ref = [r.tokens for r in jsess.run()]
    base = colocated(aida, reqs, scheduler={"chunk": chunk})
    for policy in ("fifo", "sjf"):
        d = aida.session(max_len=ML, page_size=PS,
                         scheduler={"policy": policy, "chunk": chunk},
                         disagg={"prefill_slots": 2, "decode_slots": 3})
        for r in reqs:
            d.submit(dataclasses.replace(r))
        got = [r.tokens for r in d.run()]
        assert got == base, policy
        tokens_agree(ref, got, d.margins)
        drained(d)
        assert d.stats["handoffs"] == len(reqs)
        assert d.stats["migrated_bytes"] == d.dec.stats["migrated_bytes"] > 0
        assert d.pre.stats["nonfinite_logit_rows"] == 0


@pytest.mark.parametrize("chunk", [1, 4])
def test_mixtral_disagg_matches_colocated_and_reference(chunk):
    jcfg = jreduced(jget("mixtral-8x7b"), **SMALL)
    cfg = reduced(get("mixtral-8x7b"), **SMALL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    p = bridge.from_reference(jax.tree.map(np.asarray, jp))
    reqs = mk_reqs(n=3, seed=1)
    jsess = JEngine(jcfg, params=jp).session(
        batch_slots=4, max_len=ML, page_size=PS, scheduler={"chunk": chunk})
    for r in reqs:
        jsess.submit(jreq(r))
    ref = [r.tokens for r in jsess.run()]
    d = disagg(p, cfg, scheduler={"chunk": chunk})
    for r in reqs:
        d.submit(r)
    got = [r.tokens for r in d.run()]
    assert got == colocated(p, reqs, cfg, scheduler={"chunk": chunk})
    tokens_agree(ref, got, d.margins)
    drained(d)


#: record fields of a disaggregated run set by the scheduling clock alone
TICK_FIELDS = ("rid", "prompt_len", "max_new", "submit_step", "admit_step",
               "first_token_step", "n_generated", "preemptions",
               "prefix_pages", "state", "submit_tick", "first_token_tick",
               "prefill_done_tick", "handoff_ticks", "migrated_pages",
               "migrated_bytes")


def test_disagg_run_matches_reference_field_by_field(jparams, params):
    """Chunk 4, fifo, the seed-2 heterogeneous workload over a tight
    decode pool: every record's tick and step fields (handoff ticks and
    migrated pages and bytes included), both roles' stats, role_stats,
    the router's counters, the summary's TTFT in ticks and the exported
    trace are the reference DisaggSession's; tokens agree up to near-tie
    flips."""
    arrivals = schd.generate(schd.WorkloadSpec.preset(
        "heterogeneous", n_requests=8, vocab=CFG.vocab, seed=2,
        prompt_len=(3, 12), max_new=(1, 6)))
    cfg = dict(prefill_slots=2, decode_slots=2, decode_pool_pages=40,
               max_backlog=2)
    jd = JDisaggSession(JCFG, jparams, disagg=JDisaggConfig(**cfg),
                        max_len=ML, page_size=PS,
                        scheduler={"policy": "fifo", "chunk": 4},
                        obs=jobs.Tracer())
    ref = jd.run_workload([(t, jreq(r)) for t, r in arrivals])
    d = disagg(params, d=DisaggConfig(**cfg),
               scheduler={"policy": "fifo", "chunk": 4}, obs=tobs.Tracer())
    got = d.run_workload(arrivals)
    assert [r.rid for r in got] == [r.rid for r in ref]
    tokens_agree([r.tokens for r in ref], [r.tokens for r in got],
                 d.margins)
    view = [[{k: r.get(k) for k in TICK_FIELDS} for r in s.records]
            for s in (d, jd)]
    assert view[0] == view[1]
    assert d.stats == jd.stats and d.role_stats() == jd.role_stats()
    assert d.router.stats == jd.router.stats
    for role in ("pre", "dec"):
        a, b = getattr(d, role).stats, getattr(jd, role).stats
        assert {k: a[k] for k in b} == b, role
    m, jm = (schd.summarize(s.records, 1.0, 1, roles=s.role_stats())
             for s in (d, jd))
    for k in ("ttft_sched", "queue_wait_sched", "first_token_calls",
              "roles", "outcomes"):
        assert m[k] == jm[k], k
    assert m["handoff"]["latency_ticks"] == jm["handoff"]["latency_ticks"]
    assert d.tracer.to_chrome() == jd.tracer.to_chrome()
    assert tobs.analyze(d.tracer).to_json() == \
        jobs.analyze(jd.tracer).to_json()
    drained(d)


# -------------------------------------------------------- back-pressure
def test_backpressure_blocks_prefill_not_decoders(params):
    """A slow decode side (1 slot, backlog bound 1) stalls prefill
    admission: queued requests wait, admitted decoders are never
    preempted, and every request completes with the co-located tokens."""
    reqs = [Request(prompt=[2 + i] * 6, max_new=8, rid=i) for i in range(6)]
    d = disagg(params, d=DisaggConfig(prefill_slots=2, decode_slots=1,
                                      max_backlog=1),
               scheduler={"chunk": 4})
    for r in reqs:
        d.submit(r)
    got = [r.tokens for r in d.run()]
    assert got == colocated(params, reqs, scheduler={"chunk": 4})
    assert d.router.stats["backpressure_blocks"] > 0
    drained(d)


def test_decode_pool_too_small_raises(params):
    d = disagg(params, d=DisaggConfig(decode_pool_pages=4))
    d.submit(Request(prompt=list(range(1, 21)), max_new=8, rid=0))
    with pytest.raises(kvs.OutOfPages, match="decode page pool"):
        d.run()


def test_max_new_one_finishes_at_prefill(params):
    reqs = [Request(prompt=[3 + i] * 5, max_new=1, rid=i) for i in range(3)]
    d = disagg(params, scheduler={"chunk": 4})
    for r in reqs:
        d.submit(r)
    got = [r.tokens for r in d.run()]
    assert got == colocated(params, reqs, scheduler={"chunk": 4})
    assert d.stats["handoffs"] == 0 and d.dec.stats["steps"] == 0
    drained(d)


def test_int8_migration_token_parity(params):
    """int8 pools: codes and scales migrate verbatim, so the disaggregated
    tokens equal the co-located int8 serve's, and a migrated page equals
    the prefill page it came from, byte for byte."""
    reqs = mk_reqs(n=4, seed=2)
    d = disagg(params, kv_dtype="int8", scheduler={"chunk": 2})
    moved = []
    admit = d.dec.admit_handoff

    def check(i, h, src_state, **kw):
        n = admit(i, h, src_state, **kw)
        src, dst = src_state["layers"]["kv"], d.dec.state["layers"]["kv"]
        for j, pid in h.live():
            for name in src._fields:
                assert torch.equal(getattr(src, name)[:, pid], getattr(
                    dst, name)[:, int(d.dec.host_table[i, j])]), name
        moved.append(n)
        return n
    d.dec.admit_handoff = check
    for r in reqs:
        d.submit(r)
    got = [r.tokens for r in d.run()]
    assert d.dec.state["layers"]["kv"].quantized and moved
    assert got == colocated(params, reqs, kv_dtype="int8",
                            scheduler={"chunk": 2})
    drained(d)


def test_sampling_repeats_with_the_seed(params):
    """temperature > 0: the prefill role's generator draws each first
    token, the decode role's the rest; the same seed repeats the run,
    another seed moves it."""
    reqs = [Request(prompt=[5, 6, 7, 8, 9], max_new=8, temperature=0.8,
                    rid=0), Request(prompt=[3, 4], max_new=6, rid=1)]

    def serve(seed):
        d = disagg(params, seed=seed, scheduler={"chunk": 4})
        for r in reqs:
            d.submit(dataclasses.replace(r))
        return [r.tokens for r in d.run()], d
    a, da = serve(7)
    b, _ = serve(7)
    c, _ = serve(8)
    assert a == b and a[0] != c[0] and a[1] == c[1]
    fresh = torch.Generator().manual_seed(7).get_state()
    for role in (da.pre, da.dec):          # each drew from its own stream
        assert not torch.equal(role.gen.get_state(), fresh)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_disagg_refuses_recurrent_families(arch):
    eng = Engine(reduced(get(arch)), device="cpu")
    with pytest.raises(ValueError, match="KV pages"):
        eng.session(max_len=ML, disagg=True)


def test_engine_disagg_validation(params):
    eng = Engine(CFG, params=params, device="cpu")
    with pytest.raises(ValueError, match="kv_cache"):
        eng.session(disagg=True, kv_cache="full")
    with pytest.raises(ValueError, match="together"):
        DisaggConfig(prefill_devices=2, decode_devices=None)
    with pytest.raises(ValueError, match="slot"):
        DisaggConfig(prefill_slots=0)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        eng.session(disagg={"prefill_devices": 1, "decode_devices": 1})
    assert eng.session(disagg=False).role == "engine"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(CFG, params=params).serve([[1, 2]], disagg=True)


# -------------------------------------------------------------- launcher
LAUNCH = ["--arch", "qwen1.5-0.5b", "--compress", "aida", "--disagg",
          "--prefill-slots", "2", "--decode-slots", "3", "--fault-plan",
          "drop-handoff:3", "--deadline-ticks", "64", "--max-retries", "1",
          "--chunk", "4"]
SCHED_METRICS = ("requests", "completed", "tokens", "steps", "ttft_sched",
                 "queue_wait_sched", "first_token_calls", "preemptions",
                 "outcomes", "resil", "roles")


def test_launcher_disagg_and_fault_flags_match_reference(tmp_path,
                                                         monkeypatch):
    """``--disagg --fault-plan --deadline-ticks --max-retries`` parsed and
    served on the CPU, against the reference launcher on the same
    arguments: the same scheduling metrics, resil and role summaries, the
    same failed list and trace; a bad preset is refused."""
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
    assert got["metrics"]["handoff"]["migrated_bytes"] == \
        ref["metrics"]["handoff"]["migrated_bytes"]
    assert got["failed"] == ref["failed"]
    assert {k: got["pages"][k] for k in ref["pages"]} == ref["pages"]
    assert got["pages"]["leaked"] == 0 and got["pages"]["cached"] == 0
    assert got["provenance"]["disagg"]
    assert got["metrics"]["resil"]["faults"]["drop-handoff"] > 0
    assert json.load(open(t["trace"])) == json.load(open(j["trace"]))
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen1.5-0.5b", "--device", "cpu",
                     "--fault-plan", "nope:1"])
    assert e.value.code != 0


def test_launcher_disagg_prefix_cache_pins_are_not_leaks(tmp_path):
    """``--disagg --prefix-cache``: the prefill role's prefix-cache pins
    outlive the requests by design, so they are counted as cached, as
    the co-located launcher counts them, and nothing leaks."""
    from repro_torch.launch import serve as tserve
    out = tmp_path / "pages.json"
    assert tserve.main(["--arch", "qwen1.5-0.5b", "--compress", "aida",
                        "--disagg", "--prefix-cache", "--workload",
                        "shared-prefix", "--requests", "3", "--max-new", "2",
                        "--chunk", "4", "--device", "cpu",
                        "--json", str(out)]) == 0
    pages = json.load(open(out))["pages"]
    assert pages["cached"] > 0 and pages["leaked"] == 0
