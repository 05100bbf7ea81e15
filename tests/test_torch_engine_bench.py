"""Port parity for the `Engine`'s benchmark surface, part 1: the ``kv``
section (`Engine.kv_benchmark` and its attention / FC split
`_attn_fc_share`), the ``serving`` section (`serving_benchmark`) and
`Engine.benchmark` itself, against the JAX package's `repro.api.Engine`
on a reduced llama3-8b whose weights are carried across.  Every
deterministic fact (token, step, page and preemption counts, compression
ratios, the cost-model backends) must equal the reference's; wall-clock
numbers are only checked for shape.  The KV accounting helpers are held
against the reference's over a grid.  Served on the CPU (every kernel's
plain version)."""
import json

import jax
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro import kvstore as jkvs
from repro.api import Engine as JEngine
from repro.api import env as jenv
from repro.api.registry import CapabilityError as JCapabilityError
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import kvstore as kvs
from repro_torch.api import CapabilityError, Engine
from repro_torch.api.engine import CAPACITY_SLO, CAPACITY_SMOKE_SWEEP
from repro_torch.configs import get, reduced

JCFG = jreduced(jget("llama3-8b"))
CFG = reduced(get("llama3-8b"))
MODES = ("dense", "int8", "codebook4", "acsr", "aida")
#: the reference's decode backends under the port's names
BACKEND = {"jax-dense": "torch-dense", "pallas": "cuda"}
#: summarize()'s fields counted in requests, tokens and steps
STEP_FIELDS = ("requests", "completed", "tokens", "steps", "ttft_sched",
               "queue_wait_sched", "first_token_calls", "preemptions",
               "prefix_pages_reused", "outcomes")


@pytest.fixture(scope="module", autouse=True)
def reference_untuned():
    """The reference's sessions run with its autotuner off (on the CPU it
    times interpret-mode variants of every kernel, which changes no step,
    tick or page count and is most of its time here); its tuner cache is
    restored and its traces dropped after the module, so a later module's
    reference runs pick what they pick alone."""
    saved = dict(jtune._CACHE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenv, "AUTOTUNE", False)
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
def jkv(jparams):
    return JEngine(JCFG, params=jparams).kv_benchmark()


@pytest.fixture(scope="module")
def jserving(jparams):
    return JEngine(JCFG, params=jparams).serving_benchmark()


@pytest.fixture(scope="module")
def jbench(jparams):
    """The reference's modes and backends (its kv / serving sections are
    the two fixtures above, run at the same defaults)."""
    return JEngine(JCFG, params=jparams).benchmark(modes=MODES,
                                                   kv_mode=None)


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


#: the sections test_torch_engine_roles_bench.py runs and holds against
#: the reference; here `benchmark` gets a marker from each instead
ROLE_SECTIONS = ("disagg_benchmark", "resil_benchmark",
                 "capacity_benchmark")


@pytest.fixture(scope="module")
def bench(params):
    """The port's benchmark on one CPU engine, its modes, kv and serving
    sections served and the three role sections stubbed; the engine's raw
    weights must come out of it untouched."""
    eng = Engine(CFG, params=params, device="cpu")
    before = [t.clone() for t in _tensors(eng.params)]
    with pytest.MonkeyPatch.context() as mp:
        for name in ROLE_SECTIONS:
            mp.setattr(Engine, name,
                       lambda self, *a, _name=name, **kw: {"stub": _name})
        out = eng.benchmark(modes=MODES)
    after = list(_tensors(eng.params))
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert eng.compression is None
    return out


# ------------------------------------------------------------ accounting
@pytest.mark.parametrize("page_size", [4, 8, 16])
@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_kv_bytes_per_token_matches_reference(kv_dtype, page_size):
    for n_kv in (1, 2, 5, 8):
        for d_head in (16, 64, 80, 128):
            got = kvs.kv_bytes_per_token(n_kv, d_head, page_size, kv_dtype)
            assert got == jkvs.kv_bytes_per_token(n_kv, d_head, page_size,
                                                  kv_dtype)


def test_dense_kv_bytes_per_token_matches_reference():
    for n_kv in (1, 2, 5, 8):
        for d_head in (16, 64, 80, 128):
            assert kvs.dense_kv_bytes_per_token(n_kv, d_head) == \
                jkvs.dense_kv_bytes_per_token(n_kv, d_head)


def test_capacity_constants_match_reference():
    from repro.api import engine as jengine
    assert CAPACITY_SLO == jengine.CAPACITY_SLO
    assert CAPACITY_SMOKE_SWEEP == jengine.CAPACITY_SMOKE_SWEEP


# ------------------------------------------------------------------- kv
def test_kv_section_matches_reference(bench, jkv):
    """KV bytes / token, the paged pool's peak and allocations and both
    caches' token counts are the reference's; the port tunes nothing on
    the CPU."""
    kv = bench["kv"]
    assert set(kv) == set(jkv)
    for k in ("mode", "page_size", "max_len", "batch_slots",
              "kv_bytes_per_token"):
        assert kv[k] == jkv[k], k
    for k in ("pages_peak", "page_allocs", "tokens"):
        assert kv["paged"][k] == jkv["paged"][k], k
    assert kv["full"]["tokens"] == jkv["full"]["tokens"]
    assert set(kv["paged"]) == set(jkv["paged"])
    assert set(kv["full"]) == set(jkv["full"])
    assert kv["paged"]["tiles"] == {}
    assert kv["paged_over_full"] > 0


def test_attn_fc_share_shape(bench, jkv):
    """The attention / FC split has the reference's keys, positive
    times, and shares in (0, 1) that follow from them."""
    share = bench["kv"]["attn_time_share"]
    assert set(share) == set(jkv["attn_time_share"])
    for k in ("attn_us_full", "attn_us_paged", "fc_us"):
        assert share[k] > 0, k
    for kind in ("full", "paged"):
        assert 0 < share[kind] < 1
        a = share[f"attn_us_{kind}"]
        assert share[kind] == pytest.approx(a / (a + share["fc_us"]),
                                            abs=1e-3)


def test_attn_fc_share_times_every_projection(params, monkeypatch):
    """The FC term times each compressed projection's layer-0 view (K1 /
    K4 / K5's entry point) once, at the batch width, scaled by the depth;
    a raw engine times its raw [L, d_in, d_out] leaves as products."""
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.optim.adamw import leaves
    calls = []

    def fake_timeit(fn, *args, **kw):
        calls.append([tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)])
        fn(*args)
        return 1e-6
    monkeypatch.setattr("repro_torch.obs.timeit", fake_timeit)
    for mode, n_fc in (("aida", 7), ("dense", 7)):
        calls.clear()
        eng = Engine(CFG, params=params, device="cpu")
        inner = eng._inner(mode, 0.25)
        share = eng._attn_fc_share(inner, 2, 64, 16)
        fc = calls[2:]
        assert len(calls) == 2 + n_fc
        assert all(c[0][0] == 2 for c in fc)          # batch rows
        assert share["fc_us"] == pytest.approx(n_fc * CFG.n_layers, 1e-6)
        assert share["attn_us_full"] == pytest.approx(CFG.n_layers)
        comp = [x for x in leaves(inner.params["layers"])
                if isinstance(x, sfc.CompressedFC)]
        assert len(comp) == (n_fc if mode != "dense" else 0)


# -------------------------------------------------------------- serving
def test_serving_section_matches_reference(bench, jserving):
    """Calls to first token (and its bound), prefix-cache hits and leaks,
    preemptions and the throughput run's request, token and step counts
    are the reference's."""
    sv = bench["serving"]
    assert set(sv) == set(jserving)
    for k in ("mode", "chunk", "page_size", "policy", "prefix",
              "preemption"):
        assert sv[k] == jserving[k], k
    pf, jpf = sv["prefill"], jserving["prefill"]
    assert pf["prompt_len"] == jpf["prompt_len"]
    assert pf["bound_calls"] == jpf["bound_calls"]
    for label in ("chunked", "one_token"):
        assert pf[label]["first_token_calls"] == \
            jpf[label]["first_token_calls"], label
        assert pf[label]["ttft_s"] > 0
    assert pf["chunked"]["first_token_calls"] <= pf["bound_calls"]
    th, jth = sv["throughput"], jserving["throughput"]
    assert set(th) == set(jth)
    for k in STEP_FIELDS:
        assert th[k] == jth[k], k
    assert sv["tiles"] == {}
    assert sv["prefix"]["pages_leaked_after_clear"] == 0
    assert sv["preemption"]["completed"] == sv["preemption"]["requests"]


# ------------------------------------------------------------ benchmark
def test_benchmark_modes_match_reference(bench, jbench):
    """Each mode serves the reference's tokens at its compression ratio
    through the backend the reference's would pick (under its port name);
    nothing is tuned on the CPU."""
    assert list(bench["modes"]) == list(jbench["modes"]) == list(MODES)
    for mode in MODES:
        got, ref = bench["modes"][mode], jbench["modes"][mode]
        assert set(got) == set(ref), mode
        assert got["tokens"] == ref["tokens"], mode
        assert got["compression_ratio"] == ref["compression_ratio"], mode
        assert got["backend"] == BACKEND[ref["backend"]], mode
        assert got["tiles"] == {}
        assert got["tok_per_s"] > 0 and got["seconds"] > 0


def test_benchmark_backends_match_reference(bench, jbench):
    assert bench["backends"] == jbench["backends"]


def test_benchmark_sections_and_provenance(bench, jbench):
    """Every section of an attention arch with chunked prefill is there
    (the role sections from their own methods), the provenance names
    torch and the device and not jax, and the whole dict is JSON."""
    assert set(bench) == {"provenance", "backends", "modes", "kv",
                          "serving", "disagg", "resil", "capacity"}
    for name in ROLE_SECTIONS:
        assert bench[name.split("_")[0]] == {"stub": name}
    prov = bench["provenance"]
    assert prov["torch"] == torch.__version__ and "jax" not in prov
    assert prov["card"] is None and prov["cuda"] == torch.version.cuda
    for k in ("config", "mode", "seed"):
        assert prov[k] == jbench["provenance"][k], k
    assert prov["backend"] == BACKEND[jbench["provenance"]["backend"]]
    json.dumps(bench)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("method", ["kv_benchmark", "serving_benchmark"])
def test_rwkv6_refusals_match_reference(method):
    with pytest.raises(JCapabilityError) as ref:
        getattr(JEngine(jreduced(jget("rwkv6-7b"))), method)()
    with pytest.raises(CapabilityError) as got:
        getattr(Engine(reduced(get("rwkv6-7b")), device="cpu"), method)()
    assert str(got.value) == str(ref.value)


def test_rwkv6_benchmark_has_modes_and_backends_only():
    out = Engine(reduced(get("rwkv6-7b")), device="cpu").benchmark(
        modes=("dense", "aida"), requests=2, max_new=3)
    assert set(out) == {"provenance", "backends", "modes"}
    assert [m["tokens"] for m in out["modes"].values()] == [6, 6]
    json.dumps(out)
