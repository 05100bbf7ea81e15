"""Port parity for the `Engine`'s benchmark surface, part 2: the sections
that drive the disaggregated roles and the scheduler's clock —
`Engine.disagg_benchmark`, `resil_benchmark` (the four fault presets,
each replayed) and `capacity_benchmark` (a sweep folded through
`obs.analyze`) — against the JAX package's `repro.api.Engine` on a
reduced llama3-8b whose weights are carried across.  The capacity
section counts only ticks and must equal the reference's whole; of the
others every step, tick, handoff, page and counter fact must.  The
refusals carry the reference's texts.  Served on the CPU (every kernel's
plain version)."""
import json

import jax
import numpy as np
import pytest

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro.api import Engine as JEngine
from repro.api import env as jenv
from repro.api.registry import CapabilityError as JCapabilityError
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro.obs.analyze import SLOSpec as JSLOSpec
from repro_torch import bridge
from repro_torch.api import CapabilityError, Engine
from repro_torch.api.engine import CAPACITY_SLO
from repro_torch.configs import get, reduced

JCFG = jreduced(jget("llama3-8b"))
CFG = reduced(get("llama3-8b"))
PRESETS = ("drop-handoff", "role-stall", "page-spike", "straggler")
#: summarize()'s fields counted in requests, tokens, steps and ticks
STEP_FIELDS = ("requests", "completed", "tokens", "steps", "ttft_sched",
               "queue_wait_sched", "first_token_calls", "preemptions",
               "prefix_pages_reused", "outcomes", "pages_leaked")


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
def jeng(jparams):
    return JEngine(JCFG, params=jparams)


@pytest.fixture(scope="module")
def eng(jparams):
    params = bridge.from_reference(jax.tree.map(np.asarray, jparams))
    return Engine(CFG, params=params, device="cpu")


@pytest.fixture(scope="module")
def capacity(eng, jeng):
    return eng.capacity_benchmark(), jeng.capacity_benchmark()


@pytest.fixture(scope="module")
def resil(eng, jeng):
    return eng.resil_benchmark(), jeng.resil_benchmark()


@pytest.fixture(scope="module")
def disagg(eng, jeng):
    return eng.disagg_benchmark(), jeng.disagg_benchmark()


# ------------------------------------------------------------- capacity
def test_capacity_section_equals_reference(capacity):
    got, ref = capacity
    assert json.loads(json.dumps(got)) == ref


def test_capacity_names_smallest_passing_config(capacity):
    """The reference test's own checks (tests/test_obs_analyze.py)."""
    section, _ = capacity
    labels = [e["label"] for e in section["sweep"]]
    assert labels == ["slots=2,pages=16,chunk=4,policy=fifo",
                      "slots=4,pages=24,chunk=4,policy=fifo"]
    assert [e["slo_pass"] for e in section["sweep"]] == [False, True]
    assert section["chosen"] == "slots=4,pages=24,chunk=4,policy=fifo"
    assert section["deterministic_replay"] is True
    assert all(e["segments_ok"] for e in section["sweep"])
    assert section["slo"] == JSLOSpec.parse(CAPACITY_SLO).describe()


def test_capacity_custom_sweep_and_slo_match_reference(eng, jeng):
    """A sweep given out of order (sorted smallest first), a pool left to
    the session's default and a looser SLO string."""
    sweep = [{"slots": 3, "chunk": 2, "policy": "sjf"},
             {"slots": 2, "kv_pool_pages": 12, "chunk": 8}]
    kw = dict(sweep=sweep, slo="ttft_p99=40,goodput=1.0", n_requests=5,
              seed=3, workload="heterogeneous")
    got = eng.capacity_benchmark(**kw)
    assert json.loads(json.dumps(got)) == jeng.capacity_benchmark(**kw)


# ---------------------------------------------------------------- resil
def test_resil_section_matches_reference(resil):
    got, ref = resil
    assert set(got) == set(ref)
    for k in ("mode", "workload", "requests", "seed"):
        assert got[k] == ref[k], k
    for k in ("completed", "pages_leaked"):
        assert got["clean"][k] == ref["clean"][k], k
    assert list(got["presets"]) == list(ref["presets"]) == list(PRESETS)


@pytest.mark.parametrize("preset", PRESETS)
def test_resil_preset_matches_reference(resil, preset):
    """Completed and failed requests, token parity with the clean run,
    leaks, the two replays' determinism and every counter are the
    reference's."""
    got, ref = (r["presets"][preset] for r in resil)
    assert set(got) == set(ref)
    for k in ("completed", "failed", "token_parity", "pages_leaked",
              "deterministic", "counters"):
        assert got[k] == ref[k], k
    assert got["token_parity"] and got["deterministic"]
    assert got["pages_leaked"] == 0
    assert got["goodput_vs_clean"] > 0


# --------------------------------------------------------------- disagg
def test_disagg_section_matches_reference(disagg):
    """Both engine shapes' step, tick, handoff, migration and leak facts
    are the reference's, with token parity on both sides."""
    got, ref = disagg
    assert set(got) == set(ref)
    for k in ("mode", "chunk", "workload", "requests", "token_parity"):
        assert got[k] == ref[k], k
    assert got["token_parity"] is True
    for label in ("colocated", "disagg"):
        assert set(got[label]) == set(ref[label]), label
        for k in STEP_FIELDS:
            assert got[label][k] == ref[label][k], (label, k)
        assert got[label]["pages_leaked"] == 0
    g, r = got["disagg"], ref["disagg"]
    assert g["roles"] == r["roles"]
    for k in ("count", "latency_ticks", "migrated_pages", "migrated_bytes",
              "bytes_per_request"):
        assert g["handoff"][k] == r["handoff"][k], k


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
@pytest.mark.parametrize("method", ["disagg_benchmark", "resil_benchmark"])
def test_role_refusals_match_reference(method, arch):
    with pytest.raises(JCapabilityError) as ref:
        getattr(JEngine(jreduced(jget(arch))), method)()
    with pytest.raises(CapabilityError) as got:
        getattr(Engine(reduced(get(arch)), device="cpu"), method)()
    assert str(got.value) == str(ref.value)
