"""The port's facade beyond serving: the backend registry and its
capability routing, the projection-leaf dispatch, `Engine.estimate` over
the AP emulator and the closed-form AIDA / EIE cycle models, and the two
decode backends' `run_fc`, against the JAX package's facade (`jax-dense`
is the port's `torch-dense`, `pallas` its `cuda`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro.api import Engine as JEngine
from repro.api import FCProblem as JFCProblem
from repro.api import get_backend as jget_backend
from repro.core import aida_sim as jsim
from repro.core import eie_sim as jeie
from repro.core import sparse_fc as jsfc
from repro_torch import bridge
from repro_torch.api import (MODES, WORKLOADS, CapabilityError,
                             CompressionSpec, Engine, FCProblem, Request,
                             backend_names, dispatch, get_backend)
from repro_torch.configs import get, reduced
from repro_torch.core import aida_sim as tsim
from repro_torch.core import eie_sim as teie
from repro_torch.models import layers
from repro_torch.models import model as M

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
CFG = reduced(get("llama3-8b"), **SMALL)
NAMES = {"jax-dense": "torch-dense", "pallas": "cuda",
         "ap-emulator": "ap-emulator", "cycle-sim": "cycle-sim"}


def _cpu(**kw):
    return Engine(device="cpu", **kw)


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("ref_name", sorted(NAMES))
def test_registry_names_and_caps_match_reference(ref_name):
    """Each backend carries its reference counterpart's capability flags
    under the port's name."""
    assert sorted(backend_names()) == sorted(NAMES.values())
    assert get_backend(NAMES[ref_name]).caps.__dict__ \
        == jget_backend(ref_name).caps.__dict__
    assert get_backend(NAMES[ref_name]).name == NAMES[ref_name]
    assert set(get_backend("cuda").caps.modes) == set(MODES)
    assert WORKLOADS == ("alexnet-fc", "ctc-lstm", "table1")


def test_registry_unknown_backend():
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("tpu-v9")


def test_capability_errors():
    with pytest.raises(CapabilityError, match="no batched decode"):
        get_backend("cycle-sim").make_decode_step(CFG)
    with pytest.raises(CapabilityError, match="no cycle accounting"):
        _cpu().estimate(backend="torch-dense", workload="alexnet-fc")
    with pytest.raises(CapabilityError, match="FCProblem"):
        # ap-emulator only takes concrete FCProblem workloads
        _cpu().estimate(backend="ap-emulator", workload="alexnet-fc")
    with pytest.raises(CapabilityError, match="cannot execute modes"):
        # a pinned dense backend refuses compressed modes rather than
        # serving them through the CUDA kernels
        Engine(CFG, backend="torch-dense", device="cpu").compress("aida")
    with pytest.raises(CapabilityError, match="FCProblem"):
        # the EIE model has no bit-level FCProblem pricing
        _cpu().estimate(backend="cycle-sim", simulator="eie",
                        workload=FCProblem(w=np.eye(4, dtype=np.int64),
                                           b=np.ones(4, np.int64)))
    with pytest.raises(CapabilityError, match="unknown workload"):
        _cpu().estimate(backend="cycle-sim", workload="resnet")
    with pytest.raises(CapabilityError, match="unknown simulator"):
        _cpu().estimate(backend="cycle-sim", workload="ctc-lstm",
                        simulator="tpu")
    with pytest.raises(CapabilityError, match="per-layer"):
        Engine(CFG, backend="torch-dense", device="cpu").compress(
            CompressionSpec(mode="dense", overrides={"wo": "int8"}))


@pytest.mark.parametrize("backend", ("cycle-sim", "ap-emulator"))
def test_session_on_a_backend_without_decode_raises(backend):
    eng = Engine(CFG, backend=backend, device="cpu")
    with pytest.raises(CapabilityError, match="no batched decode"):
        eng.session()
    with pytest.raises(CapabilityError, match="no batched decode"):
        eng.serve([Request(prompt=[1, 2], max_new=2)])


def test_backend_routing_follows_modes():
    eng = Engine(CFG, device="cpu")
    assert eng.backend.name == "torch-dense"
    eng.compress(CompressionSpec(mode="aida", density=0.3,
                                 overrides={"wo": "int8", "down": "skip"}))
    assert eng.backend.name == "cuda"
    assert eng.params["layers"]["attn"]["wo"].mode == "int8"
    assert isinstance(eng.params["layers"]["mlp"]["down"], torch.Tensor)
    # dense base mode + a compressed override still routes to cuda
    assert Engine(CFG, device="cpu").compress(CompressionSpec(
        mode="dense", overrides={"wo": "int8"})).backend.name == "cuda"
    # skip-only overrides execute nothing extra: the dense pin is fine
    eng2 = Engine(CFG, backend="torch-dense", device="cpu").compress(
        CompressionSpec(mode="dense", overrides={"down": "skip"}))
    assert eng2.backend.name == "torch-dense"
    assert isinstance(eng2.params["layers"]["mlp"]["down"], torch.Tensor)


@pytest.mark.parametrize("disagg", (False, True))
@pytest.mark.parametrize("pin", (None, "counting"))
def test_session_steps_through_the_engines_backend(monkeypatch, pin,
                                                   disagg):
    """A session's decode step is the one the engine's active backend
    makes: a pinned backend's, else the auto-routed one's (`cuda` once
    compressed), in the co-located and the disaggregated session."""
    from repro_torch.api import registry

    class Counting(type(get_backend("cuda"))):
        name = "counting"
        steps = 0

        def make_decode_step(self, cfg):
            inner = super().make_decode_step(cfg)

            def step(params, state, tokens):
                Counting.steps += 1
                return inner(params, state, tokens)
            return step

    counting = Counting()
    monkeypatch.setitem(registry._REGISTRY._backends, "counting", counting)
    made = []
    for ex in (get_backend("torch-dense"), get_backend("cuda")):
        monkeypatch.setattr(
            ex, "make_decode_step",
            lambda cfg, ex=ex: made.append(ex.name) or
            type(ex).make_decode_step(ex, cfg))
    eng = Engine(CFG, backend=pin, device="cpu").compress("aida",
                                                         density=0.3)
    reqs = [Request(prompt=[1, 2, 3], max_new=3)]
    if disagg:
        sess = eng.session(max_len=32, disagg=True)
        roles = (sess.pre, sess.dec)
    else:
        sess = eng.session(batch_slots=2, max_len=32)
        roles = (sess,)
    assert {r.backend.name for r in roles} == {pin or "cuda"}
    for r in reqs:
        sess.submit(r)
    res = sess.run()
    assert len(res[0].tokens) == 3
    if pin:
        assert Counting.steps == sum(
            r.stats["steps"] - r.stats["prefill_steps"] for r in roles) > 0
        assert made == []
    else:
        assert made == ["cuda"] * len(roles)


@pytest.mark.parametrize("backend", ("torch-dense", "cuda"))
def test_decode_backends_step_is_the_models(backend):
    """make_decode_step(cfg) is the port's decode_step bound to cfg."""
    params = M.init_params(CFG, torch.Generator().manual_seed(0))
    step = get_backend(backend).make_decode_step(CFG)
    tokens = torch.tensor([3, 7])
    outs = []
    for fn in (step, lambda p, s, t: M.decode_step(CFG, p, s, t)):
        state = M.init_decode_state(CFG, 2, 16, kv_cache="full",
                                    device="cpu")
        outs.append(fn(params, state, tokens)[1])
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------------------- dispatch
def test_dispatch_routes_registered_leaves(monkeypatch):
    """layers.dense applies a registered leaf type through its applier,
    bias and activation passed on, and casts its output to bf16."""
    from repro_torch.core import sparse_fc as tsfc
    leaf = tsfc.compress(torch.randn(8, 16), mode="int8")
    assert dispatch.applier_for(leaf) is tsfc.apply_fc
    assert dispatch.applier_for(torch.zeros(2, 2)) is None

    class Doubling:
        pass

    calls = []

    def apply(leaf, x, bias=None, activation=None):
        calls.append((bias, activation))
        return 2 * x[:, :3]

    monkeypatch.setitem(dispatch._APPLIERS, Doubling, None)
    dispatch.register_applier(Doubling, apply)
    x = torch.ones(2, 5, 4)
    y = layers.dense(x, Doubling(), activation="silu")
    assert y.shape == (2, 5, 3) and y.dtype == torch.bfloat16
    assert torch.equal(y.float(), torch.full((2, 5, 3), 2.0))
    assert calls == [(None, "silu")]


# ---------------------------------------------------------- cycle models
def _fields(a):
    return dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a


@pytest.mark.parametrize("key", ("aida", "eie"))
def test_table1_matches_reference(key):
    """aida_table1 / eie_table1 through the facade, field for field."""
    got = _cpu().estimate(backend="cycle-sim", workload="table1")[key]
    want = JEngine().estimate(backend="cycle-sim", workload="table1")[key]
    assert got.keys() == want.keys()
    for k in want:
        assert _fields(got[k]) == _fields(want[k]), k
    direct = (tsim.aida_table1() if key == "aida" else teie.eie_table1())
    ref = (jsim.aida_table1() if key == "aida" else jeie.eie_table1())
    assert {k: _fields(v) for k, v in direct.items()} \
        == {k: _fields(v) for k, v in ref.items()}


def test_table1_ratios():
    """The survey's 14.5x peak / 2.5x throughput over EIE, as the models
    give them."""
    t1 = _cpu().estimate(backend="cycle-sim", workload="table1")
    assert t1["aida"]["pp_gops"] / t1["eie"]["pp_gops"] == pytest.approx(
        15.43, abs=0.01)
    assert t1["aida"]["thrpt_inf_s"] / t1["eie"]["thrpt_inf_s"] \
        == pytest.approx(2.53, abs=0.01)


@pytest.mark.parametrize("workload", ("alexnet-fc", "ctc-lstm", None))
@pytest.mark.parametrize("simulator,microcode", [
    ("aida", "paper"), ("aida", "emulator"), ("aida", None), ("eie", None)])
def test_named_reports_match_reference(workload, simulator, microcode):
    kw = dict(backend="cycle-sim", workload=workload, simulator=simulator,
              microcode=microcode)
    got = _cpu().estimate(**kw)
    want = JEngine().estimate(**kw)
    assert _fields(got["report"]) == _fields(want["report"])
    assert got["cycles"] == want["cycles"] > 0
    assert got["inf_per_s"] == want["inf_per_s"]


def test_custom_layer_list_matches_reference():
    layers_t = [tsim.FCLayerSpec("a", 300, 500, 0.2, 0.5),
                tsim.FCLayerSpec("b", 64, 300, 0.5, 0.9, 1.1)]
    layers_j = [jsim.FCLayerSpec(*dataclasses.astuple(s)) for s in layers_t]
    for mc in ("paper", "emulator"):
        got = _cpu().estimate(backend="cycle-sim", workload=layers_t,
                              microcode=mc)
        want = JEngine().estimate(backend="cycle-sim", workload=layers_j,
                                  microcode=mc)
        assert _fields(got["report"]) == _fields(want["report"])


# -------------------------------------------- emulator == cycle-sim
def _problem(seed, coded):
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(3, 14)), int(rng.integers(3, 14))
    if not coded:
        w = rng.integers(-15, 16, size=(n, k)) * (rng.random((n, k)) < 0.5)
        b = rng.integers(-15, 16, size=k) * (rng.random(k) < 0.7)
        return dict(w=w, b=b, m=4, n=4)
    cents_w = np.concatenate([[0], rng.integers(-99, 100, 15)])
    cents_a = np.concatenate([[0], rng.integers(-99, 100, 15)])
    wc = rng.integers(0, 16, size=(n, k)) * (rng.random((n, k)) < 0.4)
    bc = rng.integers(0, 16, size=k) * (rng.random(k) < 0.6)
    return dict(w=wc, b=bc, m=4, n=4, coded=True, cents_w=cents_w,
                cents_a=cents_a)


@pytest.mark.parametrize("seed", (7, 8, 9))
@pytest.mark.parametrize("coded", (False, True))
def test_estimate_agreement(seed, coded):
    """ap-emulator (measured, here on CPU tensors) and cycle-sim (closed
    form, EMULATOR microcode) agree on cycles through the facade, and both
    equal the reference facade's numbers."""
    kw = _problem(seed, coded)
    prob, jprob = FCProblem(**kw), JFCProblem(**kw)
    assert (prob.nnz_b, prob.max_row_nnz, prob.prod_bits) \
        == (jprob.nnz_b, jprob.max_row_nnz, jprob.prod_bits)
    eng = _cpu()
    emu = eng.estimate(backend="ap-emulator", workload=prob)
    sim = eng.estimate(backend="cycle-sim", workload=prob)
    assert emu["exact"], "the emulator must match the integer oracle"
    assert torch.equal(emu["out"], emu["reference"])
    assert emu["out"].device.type == "cpu"
    assert emu["cycles"] == sim["cycles"]
    assert emu["nnz_b"] == sim["nnz_b"] == prob.nnz_b
    assert emu["max_row_nnz"] == sim["max_row_nnz"]
    jemu = JEngine().estimate(backend="ap-emulator", workload=jprob)
    jsim_ = JEngine().estimate(backend="cycle-sim", workload=jprob)
    assert emu["counters"] == jemu["counters"]
    assert emu["rounds"] == jemu["rounds"]
    np.testing.assert_array_equal(emu["out"].numpy(), jemu["out"])
    assert sim == jsim_


# ------------------------------------------------- run_fc in five modes
@pytest.mark.parametrize("mode", MODES)
def test_cuda_run_fc_matches_pallas(mode):
    """The cuda backend's run_fc (plain versions here) on the reference's
    compressed layer carried over by the bridge equals the pallas
    backend's (interpret mode) within 1e-5, as the FC parity tests hold
    apply_fc."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    jlayer = jsfc.compress(jnp.asarray(w), mode=mode, density=0.5, k=16)
    ref = np.asarray(jget_backend("pallas").run_fc(jlayer, jnp.asarray(x)))
    layer = bridge.from_reference(jlayer, "cpu")
    out = get_backend("cuda").run_fc(layer, torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(CapabilityError, match="CompressedFC"):
        get_backend("cuda").run_fc(torch.from_numpy(w), torch.from_numpy(x))
    if mode == "dense":
        dense = get_backend("torch-dense").run_fc(layer, torch.from_numpy(x))
        jdense = jget_backend("jax-dense").run_fc(jlayer, jnp.asarray(x))
        np.testing.assert_allclose(dense.numpy(), np.asarray(jdense),
                                   rtol=1e-5, atol=1e-5)
    else:
        with pytest.raises(CapabilityError, match="use 'cuda'"):
            get_backend("torch-dense").run_fc(layer, torch.from_numpy(x))


def test_torch_dense_run_fc_on_a_raw_matrix():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    x = rng.normal(size=(3, 40)).astype(np.float32)
    out = get_backend("torch-dense").run_fc(torch.from_numpy(w),
                                            torch.from_numpy(x))
    ref = jget_backend("jax-dense").run_fc(jnp.asarray(w), jnp.asarray(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
