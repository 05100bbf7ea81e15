"""Port parity for chunked prefill: the chunk pool write, the chunk mask,
the K3 wrapper (CPU path = its plain version), the prefill step and the
chunked serve of the port against the JAX package on the same numpy
inputs.  The JAX chunk kernel runs in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kvstore as jkvs
from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import Request as JRequest
from repro.api.compress import compress_params as jcompress_params
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro.sched import prefill as jprefill
from repro_torch import bridge
from repro_torch import kvstore as tkvs
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.models import model as TM
from repro_torch.sched import SchedConfig, prefill_step

B, HKV, G, DH, PS, NPP, C = 3, 2, 2, 16, 4, 5, 6
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
MAX_LEN = 32
SPEC = dict(mode="aida", density=0.25)


def _table():
    """Row 0 owns pages 1..5; row 1 has -1 holes; row 2 owns nothing."""
    t = np.full((B, NPP), -1, np.int32)
    t[0] = np.arange(1, NPP + 1)
    t[1] = [6, -1, 7, 8, -1]
    return t


def _chunk():
    """Row 0 writes positions 5..10 (several tokens per page); row 1 feeds
    3 tokens at 8..10, its padding runs on to 13; row 2 is idle."""
    pos = np.stack([np.arange(5, 5 + C), np.arange(8, 8 + C),
                    np.arange(C)]).astype(np.int32)
    valid = np.zeros((B, C), bool)
    valid[0] = True
    valid[1, :3] = True
    return pos, valid


def _pools(rng, kv_dtype, hist_scale):
    """The same random history in a reference pool and a port pool."""
    shape = (11, HKV, PS, DH)
    if kv_dtype == "bf16":
        jp = jkvs.PagedKV(
            jnp.asarray(rng.normal(size=shape), jnp.bfloat16),
            jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
    else:
        jp = jkvs.PagedKV(
            jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            jnp.asarray(rng.uniform(0.5, 1.0, shape[:2]) * hist_scale,
                        jnp.float32),
            jnp.asarray(rng.uniform(0.5, 1.0, shape[:2]) * hist_scale,
                        jnp.float32))
    return jp, bridge.from_reference(jax.tree.map(np.asarray, jp))


def _assert_pools(jp, tp, exact):
    """Real pages (page 0 is the shared sink, whose duplicate writes
    neither framework orders) bit-identical, or int8 codes within 1 LSB
    and scales equal."""
    ref = bridge.from_reference(jax.tree.map(np.asarray, jp))
    for name in ("k_pages", "v_pages"):
        a, b = getattr(ref, name)[1:], getattr(tp, name)[1:]
        assert a.dtype == b.dtype
        if exact:
            assert torch.equal(a, b), name
        else:
            assert (a.int() - b.int()).abs().max() <= 1, name
    if ref.k_scale is not None:
        for name in ("k_scale", "v_scale"):
            assert torch.equal(getattr(ref, name)[1:],
                               getattr(tp, name)[1:]), name


@pytest.mark.parametrize("kv_dtype,hist_scale", [
    ("bf16", 1.0), ("int8", 0.1), ("int8", 0.005)])
def test_update_chunk_matches(kv_dtype, hist_scale):
    """One chunk write with duplicate page ids and padding: bf16 pages
    bit-identical, int8 codes within 1 LSB and scales equal, on the fast
    path (history scales 0.1 cover the chunk) and the requantize path
    (0.005 do not)."""
    rng = np.random.default_rng(0)
    jp, tp = _pools(rng, kv_dtype, hist_scale)
    table = _table()
    pos, valid = _chunk()
    k = (rng.normal(size=(B, HKV, C, DH)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, HKV, C, DH)) * 0.5).astype(np.float32)
    jp = jkvs.update_chunk(jp, jnp.asarray(table), jnp.asarray(k),
                           jnp.asarray(v), jnp.asarray(pos),
                           valid=jnp.asarray(valid))
    before = None if tp.k_scale is None else tp.k_scale.clone()
    out = tkvs.update_chunk(tp, torch.from_numpy(table), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(pos),
                            valid=torch.from_numpy(valid))
    assert out.k_pages.data_ptr() == tp.k_pages.data_ptr()   # in place
    _assert_pools(jp, tp, exact=kv_dtype == "bf16")
    if before is not None:
        grew = bool((tp.k_scale[1:] > before[1:]).any())
        assert grew == (hist_scale < 0.1)
        # a padded token never grows a real page's scale: row 1's padding
        # lands on page 8, which no valid token of the chunk touches
        assert torch.equal(tp.k_scale[8], before[8])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_update_valid_redirects_padding(kv_dtype):
    """update(valid=): an invalid row writes the garbage page and grows no
    scale, as in the reference."""
    rng = np.random.default_rng(1)
    jp, tp = _pools(rng, kv_dtype, 0.005)
    table = _table()
    cur = np.array([6, 9, 0], np.int32)
    valid = np.array([True, False, False])
    k = rng.normal(size=(B, HKV, DH)).astype(np.float32)
    v = rng.normal(size=(B, HKV, DH)).astype(np.float32)
    jp = jkvs.update(jp, jnp.asarray(table), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(cur), valid=jnp.asarray(valid))
    before = tp.k_pages.clone()
    tkvs.update(tp, torch.from_numpy(table), torch.from_numpy(k),
                torch.from_numpy(v), torch.from_numpy(cur),
                valid=torch.from_numpy(valid))
    _assert_pools(jp, tp, exact=kv_dtype == "bf16")
    assert torch.equal(tp.k_pages[7], before[7])   # row 1's page untouched


@pytest.mark.parametrize("window", [-1, 3])
def test_chunk_attention_mask_matches(window):
    table = _table()
    pos, _ = _chunk()
    ref = np.asarray(jkvs.chunk_attention_mask(
        jnp.asarray(table), jnp.asarray(pos), jnp.int32(window), PS))
    out = tkvs.chunk_attention_mask(torch.from_numpy(table),
                                    torch.from_numpy(pos), window, PS)
    np.testing.assert_array_equal(out.numpy(), ref)


def _q(rng, c):
    q32 = rng.normal(size=(B, HKV * G, c, DH)).astype(np.float32)
    return np.asarray(jnp.asarray(q32).astype(jnp.bfloat16))


@pytest.mark.parametrize("kv_dtype,window,cap", [
    ("bf16", -1, None), ("bf16", 5, 2.0), ("int8", 3, None),
    ("int8", -1, 30.0)])
def test_paged_attention_chunk_matches_pallas(kv_dtype, window, cap):
    """The port's chunk attention (plain version on the CPU) against the
    Pallas chunk kernel on the same pool, table, q and positions: within
    1e-5 (both upcast to f32; only the softmax's blocking differs).  Row
    1's padded queries run past its written context into -1 entries; row
    2 owns no page."""
    rng = np.random.default_rng(2)
    jp, tp = _pools(rng, kv_dtype, 0.02)
    table = _table()
    pos, _ = _chunk()
    q = _q(rng, C)
    ref = np.asarray(jkvs.paged_attention_pallas_chunk(
        jnp.asarray(q), jp, jnp.asarray(table), jnp.asarray(pos),
        jnp.int32(window), scale=DH ** -0.5, cap=cap, interpret=True))
    out = tkvs.paged_attention_chunk(bridge.tensor(q), tp,
                                     torch.from_numpy(table),
                                     torch.from_numpy(pos), window,
                                     scale=DH ** -0.5, cap=cap).numpy()
    assert out.dtype == np.float32 and out.shape == (B, HKV * G, C, DH)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunk_of_one_matches_decode(kv_dtype):
    """The port's chunk attention at C = 1 (plain version on the CPU)
    against the reference's Pallas decode kernel on the same pool, table,
    q and positions: within 1e-6.  (The port's decode is this same chunk
    path at C = 1, as on the card, where K2 is K3's C = 1 launch.)"""
    rng = np.random.default_rng(3)
    jp, tp = _pools(rng, kv_dtype, 0.02)
    table = _table()
    cur = np.array([9, 13, 0], np.int32)
    q = _q(rng, 1)
    for window, cap in ((-1, None), (4, 30.0)):
        dec = np.asarray(jkvs.paged_attention_pallas(
            jnp.asarray(q[:, :, 0]), jp, jnp.asarray(table),
            jnp.asarray(cur), jnp.int32(window), scale=DH ** -0.5, cap=cap,
            interpret=True))
        chk = tkvs.paged_attention_chunk(
            bridge.tensor(q), tp, torch.from_numpy(table),
            torch.from_numpy(cur[:, None]), window, scale=DH ** -0.5,
            cap=cap).numpy()
        np.testing.assert_allclose(chk[:, :, 0], dec, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture
def pallas_paged():
    """Route the reference's paged attention (decode and chunk) through
    its Pallas kernels, the arithmetic the port's K2 / K3 keep, instead of
    a timing-dependent tuner pick; ``pin(batch, page_size, chunk)``
    records the choices and the tuner cache is restored afterwards."""
    saved = dict(jtune._CACHE)

    def pin(batch, page_size, chunk):
        geo = (JCFG.n_kv, JCFG.n_heads // JCFG.n_kv, JCFG.head_dim,
               page_size, MAX_LEN // page_size, batch)
        jtune.record(jtune.paged_key(*geo, False, True),
                     jtune.KernelChoice("pallas", (("pb", 2),)))
        jtune.record(jtune.paged_chunk_key(*geo, chunk, False, True),
                     jtune.KernelChoice("pallas", (("pb", 2),
                                                   ("qt", chunk))))
    yield pin
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def test_sched_config_takes_chunks():
    assert SchedConfig(chunk=8).chunk == 8
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        SchedConfig(chunk=0)


@pytest.mark.parametrize("compressed", [False, True])
def test_prefill_step_logits_match(jparams, pallas_paged, compressed):
    """One chunked step over a paged bf16 pool holding history: row 0
    feeds a full chunk, row 1 two tokens (the rest padding), row 2 is
    idle.  The reference runs op by op (``jax.disable_jit``), so both
    sides round to bf16 at the same places and differ only in f32 sum
    order: logits of the fed positions agree within 1e-4 and the written
    pages bit for bit."""
    chunk, ps = 4, 4
    pallas_paged(B, ps, chunk)
    params = jparams
    if compressed:
        params, _ = jcompress_params(params, JSpec(**SPEC), verbose=None)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    jstate = JM.init_decode_state(JCFG, B, MAX_LEN, kv_cache="paged",
                                  page_size=ps, kv_dtype="bf16")
    kv = jstate["layers"]["kv"]
    hist = rng.normal(size=(2,) + kv.k_pages.shape).astype(np.float32)
    jstate["layers"]["kv"] = kv._replace(
        k_pages=jnp.asarray(hist[0]).astype(jnp.bfloat16),
        v_pages=jnp.asarray(hist[1]).astype(jnp.bfloat16))
    table = np.full((B, MAX_LEN // ps), -1, np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :4] = [5, -1, 7, 8]
    jstate["page_table"] = jnp.asarray(table)
    jstate["pos"] = jnp.asarray([3, 9, 0], jnp.int32)
    tstate = bridge.from_reference(jax.tree.map(np.asarray, jstate))
    tokens = rng.integers(0, JCFG.vocab, size=(B, chunk)).astype(np.int32)
    n_tok = np.array([chunk, 2, 0], np.int32)
    with jax.disable_jit():
        jstate, jl = jprefill.prefill_step(JCFG, params, jstate,
                                           jnp.asarray(tokens),
                                           jnp.asarray(n_tok))
    tstate, tl = prefill_step(CFG, tparams, tstate,
                              torch.from_numpy(tokens).long(),
                              torch.from_numpy(n_tok))
    ref, out = np.asarray(jl), tl.numpy()
    assert out.shape == ref.shape == (B, chunk, CFG.vocab_padded)
    assert np.isfinite(out).all()
    fed = np.arange(chunk)[None, :] < n_tok[:, None]
    np.testing.assert_allclose(out[fed], ref[fed], rtol=0, atol=1e-4)
    pages = bridge.from_reference(jax.tree.map(np.asarray,
                                               jstate["layers"]["kv"]))
    assert torch.equal(pages.k_pages[:, 1:],
                       tstate["layers"]["kv"].k_pages[:, 1:])
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


def _tokens_agree(ref, out, margins):
    """Greedy streams agree, or first differ at a step whose top-2 logit
    margin is below 1e-2 (a near-tie that bf16 rounding may flip)."""
    assert [r.rid for r in ref] == [o.rid for o in out]
    for r, o in zip(ref, out):
        assert len(r.tokens) == len(o.tokens)
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            if a != b:
                assert margins[o.rid][j] < 1e-2, (o.rid, j)
                break


PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [7, 8], [9, 10, 11, 12, 13]]


def test_chunked_serve_matches_reference_engine(jparams, pallas_paged):
    """The slice as a whole: Engine(cfg).compress(aida).serve at chunk 8
    on the same raw params.  The port compresses them itself and serves
    on the CPU; the reference serves with its paged attention pinned to
    the Pallas kernels.  Tokens agree up to near-tie flips and both take
    the same number of steps; the port's chunk-8 tokens equal its own
    chunk-1 serve's."""
    chunk, slots = 8, 2
    pallas_paged(slots, 16, chunk)
    jeng = JEngine(JCFG, params=jparams).compress(JSpec(**SPEC))
    jsess = jeng.session(batch_slots=slots, max_len=MAX_LEN,
                         scheduler={"chunk": chunk})
    for i, p in enumerate(PROMPTS):
        jsess.submit(JRequest(prompt=p, max_new=6, rid=i))
    ref = jsess.run()
    raw = bridge.from_reference(jax.tree.map(np.asarray, jparams))
    eng = Engine(CFG, params=raw, device="cpu").compress(
        CompressionSpec(**SPEC))
    out = {}
    for c in (1, chunk):
        sess = eng.session(batch_slots=slots, max_len=MAX_LEN,
                           scheduler={"chunk": c})
        for i, p in enumerate(PROMPTS):
            sess.submit(Request(prompt=p, max_new=6, rid=i))
        out[c] = (sess.run(), sess)
    got, sess = out[chunk]
    _tokens_agree(ref, got, sess.margins)
    assert sess.stats["steps"] == jsess.stats["steps"]
    assert sess.stats["chunk"] == chunk and sess.stats["prefill_steps"] > 0
    assert [r.tokens for r in got] == [r.tokens for r in out[1][0]]
    assert sess.stats["steps"] < out[1][1].stats["steps"]
    assert sess.alloc.in_use == 0
    assert sess.stats["nonfinite_logit_rows"] == 0


def test_chunked_preemption_is_token_identical():
    """A chunk-4 serve under a pool too small for both slots' worst case
    preempts youngest-first (recompute resume re-prefills in chunks);
    greedy streams equal an unconstrained run and no page leaks."""
    eng = Engine(CFG, device="cpu", seed=1).compress(CompressionSpec(**SPEC))
    reqs = [Request(prompt=[2 + i] * (PS + 3), max_new=2 * PS, rid=i)
            for i in range(3)]
    free = eng.serve(reqs, batch_slots=2, max_len=MAX_LEN,
                     scheduler={"chunk": 4})
    sess = eng.session(batch_slots=2, max_len=MAX_LEN, page_size=PS,
                       kv_pool_pages=1 + 4 + 2, scheduler={"chunk": 4})
    for r in reqs:
        sess.submit(Request(prompt=list(r.prompt), max_new=r.max_new,
                            rid=r.rid))
    out = sess.run()
    assert sess.stats["preemptions"] > 0
    assert sess.stats["prefill_steps"] > 0
    assert [r.tokens for r in out] == [r.tokens for r in free]
    assert sess.alloc.in_use == 0


def test_decode_step_and_chunk_of_one_agree():
    """The chunked step with C = 1 and one token per slot is the decode
    step: same logits, same pages (the K3 / K2 identity at model level)."""
    eng = Engine(CFG, device="cpu", seed=2).compress(CompressionSpec(**SPEC))
    states = [TM.init_decode_state(CFG, 2, MAX_LEN, page_size=PS)
              for _ in range(2)]
    for st in states:
        st["page_table"][:, 0] = torch.tensor([1, 2], dtype=torch.int32)
    tok = torch.tensor([5, 9])
    with torch.no_grad():
        s_dec, l_dec = TM.decode_step(CFG, eng.params, states[0], tok)
        s_chk, l_chk = prefill_step(CFG, eng.params, states[1], tok[:, None],
                                    torch.ones(2, dtype=torch.int32))
    torch.testing.assert_close(l_chk[:, 0], l_dec, rtol=0, atol=1e-6)
    assert torch.equal(s_dec["layers"]["kv"].k_pages,
                       s_chk["layers"]["kv"].k_pages)
    assert torch.equal(s_dec["pos"], s_chk["pos"])
