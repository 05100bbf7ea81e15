"""Port parity for hymba (parallel attention + mamba heads in every block;
windowed layers beside global ones): the selective scan and its one-token
step (plain ops on every device, as in the JAX package), the mamba mixer,
the model's forward, decode (paged and full cache) and loss with its
gradients, the aida serve, slot resets on refill, and the prefix-cache
refusal, against the JAX package on the same params (carried by
``repro_torch.bridge``) and the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import Request as JRequest
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.optim.adamw import leaves, tree_map

ARCH = "hymba-1.5b"
JCFG, CFG = jreduced(jget(ARCH)), reduced(get(ARCH))
B, MAX_LEN, PS = 2, 64, 16
SPEC = dict(mode="aida", density=0.25)
# as tests/test_torch_train.py (both sides round to bf16 at the same
# places; a value at a rounding boundary flips on a tiny f32 difference)
LOSS_TOL, GRAD_ABS, GRAD_REL = 2e-3, 5e-3, 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.from_reference(_np(jparams))


@pytest.fixture
def pin_paged():
    """Route the reference's paged attention through its Pallas kernel
    (interpret mode: the arithmetic K2 keeps) instead of a timing-dependent
    tuner pick, as tests/test_torch_families.py does; restored after."""
    saved = dict(jtune._CACHE)

    def pin(batch, page_size, max_len, impl="pallas"):
        geo = (JCFG.n_kv, JCFG.n_heads // JCFG.n_kv, JCFG.head_dim,
               page_size, max_len // page_size, batch)
        tiles = (("pb", max_len // page_size),) if impl == "pallas" else ()
        jtune.record(jtune.paged_key(*geo, False, True),
                     jtune.KernelChoice(impl, tiles))
    yield pin
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def test_config_has_windows_and_globals():
    """Reduced hymba keeps a global layer (0) beside a windowed one (32),
    so both the ring-free full cache and the window mask are exercised."""
    assert CFG.layer_windows() == JCFG.layer_windows() == (-1, 32)
    assert CFG.family == "hymba" and CFG.has_decode and CFG.sub_quadratic


def _scan_inputs(rng, b, t, d, n):
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, d)) - 2)).astype(np.float32)
    a = -np.exp(rng.normal(size=(d, n))).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("t", [1, 7, 40])
def test_mamba_scan_matches_reference(t):
    """ops.mamba (the plain sequential scan) against the reference's
    lax.scan oracle, f32, within 1e-5; and its one-token step run T times
    gives the scan's outputs."""
    rng = np.random.default_rng(t)
    x, dt, a, bm, cm = _scan_inputs(rng, 2, t, 24, 16)
    want = np.asarray(jops.mamba(*(jnp.asarray(v) for v in
                                   (x, dt, a, bm, cm))))
    got = tops.mamba(*(_t(v) for v in (x, dt, a, bm, cm)))
    assert got.dtype == torch.float32 and got.shape == (2, t, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    h = torch.zeros((2, 24, 16))
    for i in range(t):
        h, y = tops.mamba_decode_step(h, _t(x[:, i]), _t(dt[:, i]), _t(a),
                                      _t(bm[:, i]), _t(cm[:, i]))
        np.testing.assert_allclose(y.numpy(), want[:, i], rtol=1e-5,
                                   atol=1e-5)


def test_mamba_decode_step_matches_reference():
    """The one-token SSM update against the reference's, f32, 1e-6."""
    rng = np.random.default_rng(3)
    x, dt, a, bm, cm = _scan_inputs(rng, 3, 1, 24, 16)
    h = rng.normal(size=(3, 24, 16)).astype(np.float32)
    args = (h, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    jh, jy = jops.mamba_decode_step(*(jnp.asarray(v) for v in args))
    th, ty = tops.mamba_decode_step(*(_t(v) for v in args))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


def test_mamba_scan_gradient_matches_reference():
    """Autograd through the plain scan against jax.grad of the reference's
    lax.scan, every input, f32, within 1e-5."""
    rng = np.random.default_rng(4)
    ins = _scan_inputs(rng, 2, 9, 16, 8)
    w = rng.normal(size=(2, 9, 16)).astype(np.float32)

    def jloss(*v):
        return (jops.mamba(*v) * w).sum()
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(v) for v in ins))
    live = [_t(v).requires_grad_(True) for v in ins]
    got = torch.autograd.grad((tops.mamba(*live) * _t(w)).sum(), live)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_mamba_mixer_matches_reference(jparams, tparams):
    """mamba_apply over 2 x 36 tokens and mamba_decode fed its first 4
    one at a time, layer 0's weights, against the reference's op by op.
    Both round to bf16 at the same places (in / out projections, the x_db
    product) and sum in f32 in other orders: outputs within 1e-4 (bf16
    values of magnitude below 1 agree, or sit one rounding apart, 2^-9
    at most: a boundary flip), the SSM state within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 36, CFG.d_model)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jp, tp = _layer(jparams["layers"]["mamba"]), {
        k: v[0] for k, v in tparams["layers"]["mamba"].items()}
    tx = bridge.tensor(np.asarray(xb))
    with jax.disable_jit():
        want = np.asarray(jssm.mamba_apply(jp, xb).astype(jnp.float32))
    got = tssm.mamba_apply(tp, tx)
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().numpy() - want)
    assert gap.max() <= 2 ** -9 and (gap > 0).mean() < 0.01
    jst = {"conv": jnp.zeros((2, 3, CFG.d_model)),
           "h": jnp.zeros((2, CFG.d_model, CFG.ssm_state))}
    tst = {"conv": torch.zeros((2, 3, CFG.d_model)),
           "h": torch.zeros((2, CFG.d_model, CFG.ssm_state))}
    with jax.disable_jit():
        for i in range(4):
            jst, jo = jssm.mamba_decode(jp, jst, xb[:, i:i + 1])
            tst, to = tssm.mamba_decode(tp, tst, tx[:, i:i + 1])
            np.testing.assert_allclose(
                to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                rtol=0, atol=2 ** -9)
            for k in ("conv", "h"):
                np.testing.assert_allclose(tst[k].numpy(),
                                           np.asarray(jst[k]), rtol=1e-5,
                                           atol=1e-5)
    # the decode reproduces the sequence path (its first 4 tokens)
    np.testing.assert_allclose(to.float().numpy()[:, 0], want[:, 3],
                               rtol=0, atol=2 ** -8)


def _agree_up_to_a_flip(got, want):
    """Logits [B, T, V] of a causal run: each row within 1e-4 of the
    reference's up to its first position that is not, and from there
    within 2 % of the largest logit (the reference's decode-vs-forward
    bound).  Both sides round every projection's output to bf16 after f32
    sums in other orders; a value that lands on the other side of a
    rounding boundary (see the mixer test: one bf16 rounding apart at
    most) reaches every later position through attention and the SSM
    state.  Returns the first such position of each row (T: none)."""
    gap = np.abs(got - want).max(axis=-1)                  # [B, T]
    first = [int(np.argmax(g > 1e-4)) if (g > 1e-4).any() else len(g)
             for g in gap]
    assert (gap <= 0.02 * np.abs(want).max()).all()
    return first


def test_forward_matches_reference(jparams, tparams):
    """hymba's forward (einsum attention over 2 x 36 tokens: the window of
    32 bites in layer 1) op by op on both sides, logits held by
    ``_agree_up_to_a_flip``: 1e-4 (tests/test_torch_families.py's
    tolerance) up to a bf16 rounding flip, 2 % after it.  Here row 0
    agrees throughout; in row 1 layer 0's mamba out_proj rounds one value
    of position 1 the other way (5e-4), and layer 1's attention carries
    it to the positions whose window of 32 holds position 1 (through 32:
    from 33 on the row agrees again)."""
    tokens = np.random.default_rng(6).integers(
        0, CFG.vocab, size=(2, 36)).astype(np.int32)
    with jax.disable_jit():
        jl, _ = JM.forward(JCFG, jparams, {"tokens": jnp.asarray(tokens)},
                           remat="none")
    tl, taux = TM.forward(CFG, tparams, {"tokens": torch.from_numpy(tokens)},
                          remat="none")
    assert torch.isfinite(tl).all() and float(taux) == 0.0
    assert _agree_up_to_a_flip(tl.numpy(), np.asarray(jl))[0] == 36


def _history_state(kv_cache, rng):
    """A bf16 decode state (B 2) holding history: random k / v in the
    cache or pages, row 0 at position 9 and row 1 at 37 (past the window of
    32), and random mamba conv / h, as the reference's and the port's."""
    kw = dict(kv_cache=kv_cache, page_size=PS, kv_dtype="bf16")
    jst = JM.init_decode_state(JCFG, B, MAX_LEN, **kw)
    pos = np.array([9, 37], np.int32)
    kv = jst["layers"]["kv"]
    if kv_cache == "paged":
        hist = rng.normal(size=(2,) + kv.k_pages.shape).astype(np.float32)
        jst["layers"]["kv"] = kv._replace(
            k_pages=jnp.asarray(hist[0]).astype(jnp.bfloat16),
            v_pages=jnp.asarray(hist[1]).astype(jnp.bfloat16))
        jst["page_table"] = jnp.asarray(np.arange(
            1, 1 + B * MAX_LEN // PS, dtype=np.int32).reshape(B, -1))
    else:
        hist = rng.normal(size=(2,) + kv.k.shape).astype(np.float32)
        slots = np.arange(kv.pos.shape[-1])[None, :]
        written = np.where(slots < pos[:, None], slots, -1).astype(np.int32)
        jst["layers"]["kv"] = kv._replace(
            k=jnp.asarray(hist[0]).astype(jnp.bfloat16),
            v=jnp.asarray(hist[1]).astype(jnp.bfloat16),
            pos=jnp.broadcast_to(jnp.asarray(written), kv.pos.shape))
    jst["layers"]["mamba"] = {
        k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3)
        for k, v in jst["layers"]["mamba"].items()}
    jst["pos"] = jnp.asarray(pos)
    return jst, bridge.from_reference(_np(jst))


@pytest.mark.parametrize("kv_cache", ["full", "paged"])
def test_decode_step_matches_reference(jparams, tparams, pin_paged,
                                       kv_cache):
    """One decode step from a state holding history (the window of 32
    bites in layer 1 for row 1), the reference op by op on the same cache
    kind: logits within 1e-4, the written cache or pages bit for bit and
    the mamba state within 1e-5.  Then three more steps within 2 % of the
    largest logit, the reference's decode-vs-forward bound: the x_db and
    projection outputs are rounded to bf16 on both sides after f32 sums
    in other orders, and a value that lands on the other side of a
    rounding boundary moves a row's logits by up to ~2e-2 (seen here)."""
    pin_paged(B, PS, MAX_LEN)
    jst, tst = _history_state(kv_cache, np.random.default_rng(9))
    toks = np.random.default_rng(7).integers(0, CFG.vocab, size=(4, B))
    for t in range(4):
        with jax.disable_jit():
            jst, jl = JM.decode_step(JCFG, jparams, jst,
                                     jnp.asarray(toks[t], jnp.int32))
        tst, tl = TM.decode_step(CFG, tparams, tst, torch.from_numpy(toks[t]))
        jl = np.asarray(jl)
        assert np.isfinite(tl.numpy()).all()
        lim = 1e-4 if t == 0 else 0.02 * np.abs(jl).max()
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=lim)
        if t:
            continue
        for k in ("conv", "h"):
            np.testing.assert_allclose(
                tst["layers"]["mamba"][k].numpy(),
                np.asarray(jst["layers"]["mamba"][k]), rtol=1e-5, atol=1e-5)
        want = bridge.from_reference(_np(jst["layers"]["kv"]))
        for a, b in zip(want, tst["layers"]["kv"]):
            if a is not None:
                assert torch.equal(a, b)


def test_loss_fn_and_gradients_match_reference(jparams):
    """loss_fn (einsum attention, 2 x 36 tokens) and its gradient over
    every param (mamba's in / out / x_db / dt projections, conv, A_log, D
    included) against jax.value_and_grad of the reference's (eager, as
    tests/test_torch_train.py runs it), within that file's limits."""
    batch = jpipe.make_batch(JCFG, jpipe.PipelineConfig(
        seed=0, global_batch=2, seq_len=36), 0)

    def jloss(p):
        return JM.loss_fn(JCFG, p, batch, attn_impl="einsum", remat="none")
    (jval, _), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    live = tree_map(lambda a: a.clone().requires_grad_(True),
                    bridge.from_reference(_np(jparams)))
    val, _ = TM.loss_fn(CFG, live, {"tokens": torch.from_numpy(
        batch["tokens"])}, attn_impl="einsum", remat="none")
    assert abs(float(val.detach()) - float(jval)) <= LOSS_TOL
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    got = [g.numpy() for g in torch.autograd.grad(val, leaves(live))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_ABS
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w)


def test_flash_forward_and_loss_match_einsum(tparams):
    """attn_impl="flash" (K7 / K8's plain versions on the CPU) gives the
    einsum route's loss and gradients: the window and the global layer
    through the flash masks."""
    batch = {"tokens": torch.from_numpy(np.random.default_rng(8).integers(
        0, CFG.vocab, size=(2, 48)))}
    out = {}
    for impl in ("einsum", "flash"):
        live = tree_map(lambda a: a.clone().requires_grad_(True), tparams)
        val, _ = TM.loss_fn(CFG, live, batch, attn_impl=impl, remat="dots")
        out[impl] = (float(val.detach()), [g.numpy() for g in
                                           torch.autograd.grad(
                                               val, leaves(live))])
    assert abs(out["flash"][0] - out["einsum"][0]) <= LOSS_TOL
    for g, w in zip(out["flash"][1], out["einsum"][1]):
        assert np.abs(g - w).max() <= GRAD_ABS


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


# three requests over two slots (refill); the first runs past the reduced
# window of 32
PROMPTS = [[(5 * j + 1) % 200 for j in range(40)], [7, 8], [9, 10, 11, 12]]


def test_serve_matches_reference_engine(jparams, pin_paged):
    """Engine(cfg).compress(aida).serve on the same raw params, paged with
    chunk 8 asked (hymba serves at chunk 1, as in the reference: its
    mamba heads are recurrent): greedy tokens equal to the reference's up
    to near-tie flips, no leaked page.  (The full cache against the
    reference: test_decode_step_matches_reference.)"""
    jeng = JEngine(JCFG, params=jparams).compress(JSpec(**SPEC))
    eng = Engine(CFG, params=bridge.from_reference(_np(jparams)),
                 device="cpu").compress(CompressionSpec(**SPEC))
    pin_paged(2, PS, MAX_LEN)
    jsess = jeng.session(batch_slots=2, max_len=MAX_LEN, kv_cache="paged",
                         scheduler={"chunk": 8})
    sess = eng.session(batch_slots=2, max_len=MAX_LEN, kv_cache="paged",
                       scheduler={"chunk": 8})
    assert sess.chunk == jsess.chunk == 1
    for i, p in enumerate(PROMPTS):
        jsess.submit(JRequest(prompt=p, max_new=6, rid=i))
        sess.submit(Request(prompt=p, max_new=6, rid=i))
    _tokens_agree(jsess.run(), sess.run(), sess.margins)
    assert sess.stats["nonfinite_logit_rows"] == 0
    assert sess.alloc.in_use == 0


@pytest.mark.parametrize("kv_cache", ["paged", "full"])
def test_refill_resets_the_mamba_state(tparams, kv_cache):
    """Five requests over two slots, each admitted into a slot another
    request used: every request's tokens equal the tokens it gets served
    alone in a fresh session (a stale mamba conv / h, or stale cache
    positions, would change them)."""
    eng = Engine(CFG, params=tparams, device="cpu")
    reqs = [Request(prompt=[3 + r, 40 - r, 7 * r + 1][:1 + r % 3],
                    max_new=4 + r, rid=r) for r in range(5)]
    sess = eng.session(batch_slots=2, max_len=MAX_LEN, kv_cache=kv_cache)
    for r in reqs:
        sess.submit(r)
    batched = sess.run()
    assert sess.stats["fills"] == 5
    for r, got in zip(reqs, batched):
        alone = eng.session(batch_slots=2, max_len=MAX_LEN,
                            kv_cache=kv_cache)
        alone.submit(r)
        assert alone.run()[0].tokens == got.tokens, r.rid


def test_prefix_cache_is_refused():
    """prefix_cache=True on hymba's paged cache raises, naming the reason
    (attached pages never reach the mamba heads); the full cache has no
    prefix cache to refuse."""
    eng = Engine(CFG, device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        eng.session(kv_cache="paged", scheduler={"prefix_cache": True})
    eng.session(kv_cache="paged")
    eng.session(kv_cache="full", scheduler={"prefix_cache": True})


def test_reference_prefix_hit_changes_hymba_output(jparams, pin_paged):
    """The fault the refusal avoids, shown on the reference: two requests
    sharing a 16-token prompt page, served one after the other on one
    slot.  With the prefix cache the second attaches the first's page and
    skips its 16 tokens, which never pass through the mamba heads, so its
    logits differ from the serve without the cache."""
    pin_paged(1, PS, MAX_LEN, impl="xla")
    head = [(3 * j + 5) % 200 for j in range(16)]
    prompts = [head + [1, 2], head + [9, 8, 7]]
    rows = {}
    for cached in (False, True):
        sess = JEngine(JCFG, params=jparams).session(
            batch_slots=1, max_len=MAX_LEN, kv_cache="paged",
            scheduler={"prefix_cache": cached})
        got = []
        emit = sess._emit

        def keep(i, logits_i, now, emit=emit, got=got):
            got.append((sess.slot_entry[i].req.rid, np.array(logits_i)))
            emit(i, logits_i, now)
        sess._emit = keep
        for i, p in enumerate(prompts):
            sess.submit(JRequest(prompt=p, max_new=3, rid=i))
        sess.run()
        assert sess.stats["prefix_hits"] == int(cached)
        rows[cached] = [lg for rid, lg in got if rid == 1]
    assert len(rows[True]) == len(rows[False]) == 3
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(rows[True], rows[False]))
    assert gap > 1e-2
