"""Port parity for the slice as a whole: the paged bf16 decode step and
``Engine.compress(...).serve(...)`` of the port against the JAX package,
on the same params carried across by ``repro_torch.bridge``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import Request as JRequest
from repro.api.compress import compress_params as jcompress_params
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.models import model as TM

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
B, MAX_LEN, PS = 3, 32, 4
SPEC = dict(mode="aida", density=0.25)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture
def pallas_paged():
    """Route the reference's paged attention through its Pallas kernel
    (f32 operands, the arithmetic the port's K2 keeps) instead of a
    timing-dependent tuner pick, for one test; ``pin(batch, page_size)``
    records the choice and the tuner cache is restored afterwards."""
    saved = dict(jtune._CACHE)

    def pin(batch, page_size):
        key = jtune.paged_key(JCFG.n_kv, JCFG.n_heads // JCFG.n_kv,
                              JCFG.head_dim, page_size, MAX_LEN // page_size,
                              batch, False, True)
        jtune.record(key, jtune.KernelChoice("pallas", (("pb", 2),)))
    yield pin
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def test_config_copy_matches_reference():
    for name in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
                 "head_dim", "vocab_padded", "rope_theta", "tie_embeddings"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
        assert getattr(get("llama3-8b"), name) == \
            getattr(jget("llama3-8b"), name), name
    assert CFG.layer_windows() == JCFG.layer_windows()


@pytest.mark.parametrize("compressed", [False, True])
def test_decode_step_logits_match(jparams, pallas_paged, compressed):
    """Decode steps over a paged bf16 pool holding history, rows at
    different positions (row 2 idle, owning no page).

    Step 1 runs the reference op by op (``jax.disable_jit``): both sides
    then round to bf16 at the same places and differ only in f32 sum
    order, so logits agree within 1e-4 and the written pages bit for bit.
    Later steps run the reference's jitted step, where XLA keeps fused
    bf16 intermediates in f32 (excess precision) and so rounds at fewer
    places than its own op-by-op run; logits (O(1)) then agree within
    6e-2 and on average within 1e-2."""
    pallas_paged(B, PS)
    params = jparams
    if compressed:
        params, _ = jcompress_params(params, JSpec(**SPEC), verbose=None)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    jstate = JM.init_decode_state(JCFG, B, MAX_LEN, kv_cache="paged",
                                  page_size=PS, kv_dtype="bf16")
    kv = jstate["layers"]["kv"]
    hist = rng.normal(size=(2,) + kv.k_pages.shape).astype(np.float32)
    jstate["layers"]["kv"] = kv._replace(
        k_pages=jnp.asarray(hist[0]).astype(jnp.bfloat16),
        v_pages=jnp.asarray(hist[1]).astype(jnp.bfloat16))
    table = np.full((B, MAX_LEN // PS), -1, np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :4] = [5, -1, 7, 8]
    jstate["page_table"] = jnp.asarray(table)
    jstate["pos"] = jnp.asarray([3, 9, 0], jnp.int32)
    tstate = bridge.from_reference(jax.tree.map(np.asarray, jstate))

    def both(step, tok):
        js, jl = step(params, jstate, jnp.asarray(tok))
        ts, tl = TM.decode_step(CFG, tparams, tstate, torch.from_numpy(tok))
        ref, out = np.asarray(jl), tl.numpy()
        assert out.shape == ref.shape and np.isfinite(out).all()
        return js, ts, ref[:2], out[:2]

    tok = rng.integers(0, JCFG.vocab, size=B).astype(np.int32)
    with jax.disable_jit():
        jstate, tstate, ref, out = both(
            lambda p, s, t: JM.decode_step(JCFG, p, s, t), tok)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    pages = bridge.from_reference(jax.tree.map(np.asarray,
                                               jstate["layers"]["kv"]))
    assert torch.equal(pages.k_pages[:, 1:],
                       tstate["layers"]["kv"].k_pages[:, 1:])
    jit_step = jax.jit(lambda p, s, t: JM.decode_step(JCFG, p, s, t))
    for _ in range(3):
        tok = rng.integers(0, JCFG.vocab, size=B).astype(np.int32)
        jstate, tstate, ref, out = both(jit_step, tok)
        np.testing.assert_allclose(out, ref, rtol=0, atol=6e-2)
        assert np.abs(out - ref).mean() < 1e-2
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


def _tokens_agree(ref, out, margins):
    """Greedy streams agree, or first differ at a step whose top-2 logit
    margin is below 1e-2 (a near-tie that bf16 rounding may flip)."""
    for r, o in zip(ref, out):
        assert r.rid == o.rid and len(r.tokens) == len(o.tokens)
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            if a != b:
                assert margins[o.rid][j] < 1e-2, (o.rid, j)
                break


def test_serve_matches_reference_engine(jparams, pallas_paged):
    """The main path, Engine(cfg).compress(aida).serve(requests), on the
    same raw params: the port compresses them itself and serves on the
    CPU (plain kernel versions); the reference serves with its paged
    attention pinned to the Pallas kernel.  Three requests over two slots
    exercise refill."""
    pallas_paged(2, 16)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]]
    jreqs = [JRequest(prompt=p, max_new=6, rid=i)
             for i, p in enumerate(prompts)]
    ref = JEngine(JCFG, params=jparams).compress(
        JSpec(**SPEC)).serve(jreqs, batch_slots=2, max_len=MAX_LEN)
    raw = bridge.from_reference(jax.tree.map(np.asarray, jparams))
    eng = Engine(CFG, params=raw, device="cpu").compress(
        CompressionSpec(**SPEC))
    sess = eng.session(batch_slots=2, max_len=MAX_LEN)
    for i, p in enumerate(prompts):
        sess.submit(Request(prompt=p, max_new=6, rid=i))
    out = sess.run()
    assert [r.rid for r in out] == [0, 1, 2]
    _tokens_agree(ref, out, sess.margins)
    assert sess.alloc.in_use == 0
    assert sess.stats["nonfinite_logit_rows"] == 0


def test_preemption_is_token_identical():
    """A pool too small for both slots' worst case forces youngest-first
    preemption with recompute resume; greedy streams equal an
    unconstrained run and no page leaks."""
    eng = Engine(CFG, device="cpu", seed=1).compress(CompressionSpec(**SPEC))
    reqs = [Request(prompt=[2 + i] * PS, max_new=2 * PS, rid=i)
            for i in range(3)]
    free = eng.serve(reqs, batch_slots=2, max_len=MAX_LEN)
    sess = eng.session(batch_slots=2, max_len=MAX_LEN, page_size=PS,
                       kv_pool_pages=1 + 3 + 2)
    for r in reqs:
        sess.submit(Request(prompt=list(r.prompt), max_new=r.max_new,
                            rid=r.rid))
    out = sess.run()
    assert sess.stats["preemptions"] > 0
    assert [r.tokens for r in out] == [r.tokens for r in free]
    assert sess.alloc.in_use == 0


def test_pool_is_updated_in_place():
    """The decode state's pools are written in place (no copy per step)."""
    eng = Engine(CFG, device="cpu")
    sess = eng.session(batch_slots=1, max_len=MAX_LEN)
    kv = sess.state["layers"]["kv"]
    ptr = kv.k_pages.data_ptr()
    sess.submit(Request(prompt=[1, 2], max_new=2, rid=0))
    sess.run()
    assert sess.state["layers"]["kv"].k_pages.data_ptr() == ptr
    assert kv.k_pages.float().abs().sum() > 0
