"""Port parity for the rwkv6 family: the WKV recurrence (K9's plain
version, the one CPU tensors take), its one-token step, the time and
channel mixes, the model's forward and decode, compression and the aida
serve, against the JAX package on the same numpy inputs.  The JAX WKV
kernel runs in Pallas interpret mode, as its own tests run it."""
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.linear_scan import rwkv6_fwd as jrwkv6_fwd
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.api.compress import compress_params
from repro_torch.configs import get, reduced
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

JCFG = jreduced(jget("rwkv6-7b"))
CFG = reduced(get("rwkv6-7b"))
MAX_LEN = 32
SPEC = dict(mode="aida", density=0.25)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.from_reference(jax.tree.map(np.asarray, jparams))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _wkv_inputs(rng, b, h, t, dk, dv):
    r = rng.normal(size=(b, h, t, dk)).astype(np.float32) * .5
    k = rng.normal(size=(b, h, t, dk)).astype(np.float32) * .5
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.normal(size=(b, h, t, dk)))).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    return r, k, v, w, u


def test_config_copy_matches_reference():
    for name in ("family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
                 "vocab", "head_dim", "vocab_padded", "rwkv_head_dim",
                 "rope_theta", "tie_embeddings", "norm", "source"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
        assert getattr(get("rwkv6-7b"), name) == \
            getattr(jget("rwkv6-7b"), name), name
    assert CFG.d_model // CFG.rwkv_head_dim == 2       # two WKV heads of 64


# the shapes of the reference's own kernel test (tests/test_kernels.py)
@pytest.mark.parametrize("t,chunk,dk,dv", [(128, 32, 16, 16),
                                           (64, 64, 32, 64),
                                           (96, 16, 8, 8)])
def test_wkv_matches_reference(rng, t, chunk, dk, dv):
    """The port's ops.rwkv6 on CPU tensors (the plain version K9 is held
    to on the card), both impls, against the reference's Pallas kernel and
    its sequential oracle: rtol = atol = 1e-4, the reference's own kernel
    tolerance (f32 sums in other orders)."""
    args = _wkv_inputs(rng, 2, 2, t, dk, dv)
    want = np.asarray(jref.rwkv6_ref(*map(jnp.asarray, args)))
    pallas = np.asarray(jrwkv6_fwd(*map(jnp.asarray, args), chunk=chunk,
                                   interpret=True))
    for impl in ("scan", "kernel"):
        out = tops.rwkv6(*map(_t, args), impl=impl, chunk=chunk)
        assert out.dtype == torch.float32 and out.shape == want.shape
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-4,
                                   atol=1e-4)
    assert tls.rwkv6_scan.launches == 0       # CPU tensors launch nothing


def test_wkv_tiny_decay_stays_exact():
    """Decays near 0 (w = 1e-9): the exact recurrence, no cumulative
    product, so the result holds at the reference's 1e-5 / 1e-6."""
    b, h, t, d = 1, 1, 64, 8
    r = np.full((b, h, t, d), 0.1, np.float32)
    k = np.full((b, h, t, d), 0.1, np.float32)
    v = np.ones((b, h, t, d), np.float32)
    w = np.full((b, h, t, d), 1e-9, np.float32)
    u = np.zeros((h, d), np.float32)
    args = (r, k, v, w, u)
    want = np.asarray(jrwkv6_fwd(*map(jnp.asarray, args), chunk=16,
                                 interpret=True))
    out = tops.rwkv6(*map(_t, args), impl="kernel", chunk=16)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wkv_ragged_t_and_bf16_inputs(rng):
    """impl="scan" takes any T (300 is no multiple of 64), and bf16 r / k /
    v (as the model's projections give them) are read exactly as their
    f32 values."""
    args = _wkv_inputs(rng, 2, 3, 300, 16, 24)
    want = np.asarray(jref.rwkv6_ref(*map(jnp.asarray, args)))
    out = tops.rwkv6(*map(_t, args))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    r, k, v, w, u = map(_t, args)
    bf = [x.to(torch.bfloat16) for x in (r, k, v)]
    want = np.asarray(jref.rwkv6_ref(
        *[jnp.asarray(x.float().numpy()) for x in bf], jnp.asarray(args[3]),
        jnp.asarray(args[4])))
    out = tops.rwkv6(*bf, w, u)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,chunk", [(96, 64), (100, 16)])
def test_kernel_impl_raises_where_the_reference_asserts(rng, t, chunk):
    args = _wkv_inputs(rng, 1, 1, t, 8, 8)
    with pytest.raises(AssertionError):
        jrwkv6_fwd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    with pytest.raises(ValueError, match="not a multiple"):
        tops.rwkv6(*map(_t, args), impl="kernel", chunk=chunk)
    assert tops.rwkv6(*map(_t, args), impl="scan", chunk=chunk).shape[2] == t
    with pytest.raises(ValueError, match="unknown rwkv6 impl"):
        tops.rwkv6(*map(_t, args), impl="pallas")


def test_wkv_grad_matches_reference(rng):
    """On the CPU the plain version is differentiable by autograd, as the
    reference's scan is by jax.grad: gradients of sum(o * g) for every
    input within 1e-4."""
    args = _wkv_inputs(rng, 1, 2, 20, 8, 8)
    g = rng.normal(size=(1, 2, 20, 8)).astype(np.float32)
    want = jax.grad(lambda *a: (jref.rwkv6_ref(*a) * g).sum(),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    (tops.rwkv6(*ts) * _t(g)).sum().backward()
    for x, wg in zip(ts, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg),
                                   rtol=1e-4, atol=1e-4)


def test_decode_step_matches_reference(rng):
    b, h, dk, dv = 3, 2, 8, 12
    S = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    r, k, w = (rng.normal(size=(b, h, dk)).astype(np.float32)
               for _ in range(3))
    v = rng.normal(size=(b, h, dv)).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    js, jo = jops.rwkv6_decode_step(*map(jnp.asarray, (S, r, k, v, w, u)))
    ts, to = tops.rwkv6_decode_step(*map(_t, (S, r, k, v, w, u)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def _bf16(rng, shape, scale=1.0):
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale)
    return x.astype(jnp.bfloat16)


def _bridge(x):
    return bridge.tensor(np.asarray(x))


def test_time_and_channel_mix_match_reference(rng, jparams, tparams):
    """Layer 0's time mix and channel mix over a 12-token segment with a
    non-zero token shift, then one decode token each from the segment's
    state.  The reference runs op by op (``jax.disable_jit``), so both
    sides round to bf16 at the same places and differ in f32 sum order
    only: outputs within 2e-2 (bf16 outputs of O(1): a few ulps), the WKV
    state within 1e-4."""
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tp = ttfm.layer_view(tparams["layers"], 0)
    b, t, d = 2, 12, JCFG.d_model
    x, prev = _bf16(rng, (b, t, d)), _bf16(rng, (b, d))
    xd = _bf16(rng, (b, 1, d))
    tx, tprev, txd = map(_bridge, (x, prev, xd))
    with jax.disable_jit():
        jo, jlast = jssm.rwkv6_time_mix(jp["tm"], x, prev, d_head=64)
        jco, _ = jssm.rwkv6_channel_mix(jp["cm"], x, prev)
        S = jnp.asarray(rng.normal(size=(b, d // 64, 64, 64)), jnp.float32)
        jst, jdo = jssm.rwkv6_time_mix_decode(
            jp["tm"], {"prev": prev, "S": S}, xd, d_head=64)
        jcp, jcdo = jssm.rwkv6_channel_mix_decode(jp["cm"], prev, xd)
    to, tlast = tssm.rwkv6_time_mix(tp["tm"], tx, tprev, d_head=64)
    tco, _ = tssm.rwkv6_channel_mix(tp["cm"], tx, tprev)
    tst, tdo = tssm.rwkv6_time_mix_decode(
        tp["tm"], {"prev": tprev, "S": _bridge(S)}, txd, d_head=64)
    tcp, tcdo = tssm.rwkv6_channel_mix_decode(tp["cm"], tprev, txd)
    for got, want in ((to, jo), (tco, jco), (tdo, jdo), (tcdo, jcdo)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=2e-2)
    assert torch.equal(tlast, _bridge(jlast))
    assert torch.equal(tst["prev"], _bridge(jst["prev"]))
    assert torch.equal(tcp, _bridge(jcp))
    np.testing.assert_allclose(tst["S"].numpy(), np.asarray(jst["S"]),
                               rtol=1e-4, atol=1e-4)


def test_forward_logits_match_reference(jparams, tparams):
    """Reduced rwkv6-7b forward over 2 x 16 tokens, the reference op by
    op.  Both sides round to bf16 at the same places, but the WKV and the
    projections sum in f32 in other orders, so about 2 % of the bf16
    activations after a layer come out one ulp apart (7.8e-3 at their
    magnitude of 2.8), and the recurrence carries such a difference into
    every later position: logits (O(1), f32) within 5e-2, on average
    within 5e-3 (measured: 2.3e-2 and 1.9e-3; the first positions agree
    within 1e-6)."""
    tokens = np.random.default_rng(1).integers(0, JCFG.vocab, (2, 16))
    with jax.disable_jit():
        want, _ = JM.forward(JCFG, jparams,
                             {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        got, aux = TM.forward(CFG, tparams,
                              {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-2)
    assert np.abs(got.numpy() - np.asarray(want)).mean() < 5e-3
    np.testing.assert_allclose(got[:, :2].numpy(), np.asarray(want)[:, :2],
                               rtol=0, atol=1e-5)


def _forward(params, tokens):
    with torch.no_grad():
        return TM.forward(CFG, params, {"tokens": tokens})[0][..., :CFG.vocab]


def _decode(params, tokens):
    """decode_step fed ``tokens`` one at a time: the logits, the final
    state and the state's initial S stack."""
    state = TM.init_decode_state(CFG, tokens.shape[0], MAX_LEN)
    s_stack = state["layers"]["S"]
    steps = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            state, lg = TM.decode_step(CFG, params, state, tokens[:, i])
            steps.append(lg)
    return torch.stack(steps, 1)[..., :CFG.vocab], state, s_stack


TOKENS = torch.from_numpy(
    np.random.default_rng(2).integers(0, CFG.vocab, (2, 24)))


def test_forward_equals_token_by_token_decode(tparams):
    """The model gives one function both ways: the forward's logits at
    every position against decode_step fed the same tokens one at a time,
    the decode state written in place.  The forward's WKV sums its state
    in another order than the decode step's einsum, so bf16 activations
    round one ulp apart in places, as against the reference: logits
    within 5e-2, on average within 5e-3 (measured: 1.5e-3 at most), and
    the greedy token equal wherever the top-2 margin exceeds 5e-2."""
    full = _forward(tparams, TOKENS)
    dec, state, s_stack = _decode(tparams, TOKENS)
    assert state["layers"]["S"] is s_stack and float(s_stack.abs().sum()) > 0
    assert state["pos"].tolist() == [24, 24] and "page_table" not in state
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=0, atol=5e-2)
    assert float((dec - full).abs().mean()) < 5e-3
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 5e-2
    assert torch.equal(dec.argmax(-1)[clear], full.argmax(-1)[clear])


def _kv_swapped(S, r, k, v, w, u):
    _, o = SOUND_STEP(S, r, k, v, w, u)
    return w[..., :, None] * S + v[..., :, None] * k[..., None, :], o


def _decay_first(S, r, k, v, w, u):
    return SOUND_STEP(w[..., :, None] * S, r, k, v, torch.ones_like(w), u)


SOUND_STEP = tops.rwkv6_decode_step


@pytest.mark.parametrize("fault", ["bonus u dropped", "k and v swapped",
                                   "decay before the output"])
def test_wkv_fault_in_decode_breaks_forward_equality(tparams, fault,
                                                     monkeypatch):
    """Controls for the limits above: with a fault planted in the decode's
    WKV the same comparison fails, the logits more than 5e-2 apart
    somewhere or more than 5e-3 on average."""
    params = tparams
    if fault == "bonus u dropped":
        tm = params["layers"]["tm"]
        params = dict(params, layers=dict(
            params["layers"], tm=dict(tm, u=torch.zeros_like(tm["u"]))))
    else:
        monkeypatch.setattr(tops, "rwkv6_decode_step", _kv_swapped
                            if fault == "k and v swapped" else _decay_first)
    gap = (_decode(params, TOKENS)[0] - _forward(tparams, TOKENS)).abs()
    assert float(gap.max()) > 5e-2 or float(gap.mean()) > 5e-3


def test_decode_state_and_bridge_match_reference(jparams, tparams):
    """The port's rwkv6 decode state has the reference's leaves, shapes and
    types, and a reference state crosses the bridge; with no kv_cache asked
    each family takes its own, the paged cache is refused for rwkv6 as in
    the reference, and attention families take the full cache (a dense
    KVCache whose slots read as empty), as in the reference."""
    jst = JM.init_decode_state(JCFG, 3, MAX_LEN)
    tst = TM.init_decode_state(CFG, 3, MAX_LEN, kv_cache="full")
    got = bridge.from_reference(jax.tree.map(np.asarray, jst))
    assert set(got["layers"]) == set(tst["layers"]) == \
        {"tm_prev", "cm_prev", "S"}
    for name, leaf in tst["layers"].items():
        assert leaf.shape == got["layers"][name].shape, name
        assert leaf.dtype == got["layers"][name].dtype, name
    assert tst["pos"].dtype == got["pos"].dtype == torch.int32
    # no kv_cache asked: each family takes its own
    assert set(TM.init_decode_state(CFG, 3, MAX_LEN)) == {"layers", "pos"}
    assert "page_table" in TM.init_decode_state(reduced(get("llama3-8b")),
                                                3, MAX_LEN)
    with pytest.raises(ValueError, match="attention-free"):
        TM.init_decode_state(CFG, 3, MAX_LEN, kv_cache="paged")
    full = TM.init_decode_state(reduced(get("llama3-8b")), 3, MAX_LEN,
                                kv_cache="full")
    assert "page_table" not in full
    assert tuple(full["layers"]["kv"].pos.shape) == (2, 3, MAX_LEN)
    assert bool((full["layers"]["kv"].pos == -1).all())
    assert set(tparams["layers"]["tm"]) == set(jparams["layers"]["tm"])
    assert set(tparams["layers"]["cm"]) == set(jparams["layers"]["cm"])
    assert tparams["lm_head"].shape == (JCFG.d_model, JCFG.vocab_padded)


def test_init_params_tree_matches_reference(jparams):
    """Random init (its numbers differ: other generators) gives the
    reference's tree: every leaf name, shape and type, lm_head untied."""
    tp = TM.init_params(CFG, torch.Generator().manual_seed(0))
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            flat_t["/".join(path)] = tree
    walk(tp, ())
    assert set(flat_t) == set(flat_j)
    for name, leaf in flat_t.items():
        assert tuple(leaf.shape) == tuple(flat_j[name].shape), name
        assert leaf.dtype == torch.float32, name
    assert float(tp["layers"]["tm"]["w0"][0, 0]) == -4.0


def test_compress_params_matches_reference(jparams, tparams):
    """Exactly the reference's leaves are compressed: tm.{wr, wk, wv, wg,
    wo} and cm.{wk, wv, wr}; w_A, w_B, u, w0, mu and the norms stay raw."""
    jout, jstats = jcompress_params(jparams, JSpec(**SPEC), verbose=None)
    tout, tstats = compress_params(tparams, CompressionSpec(**SPEC),
                                   verbose=None)
    assert tstats["n_compressed"] == jstats["n_compressed"] == 8 * 2
    for part in ("tm", "cm"):
        for name, leaf in jout["layers"][part].items():
            compressed = type(leaf).__name__ == "CompressedFC"
            assert (type(tout["layers"][part][name]).__name__
                    == "CompressedFC") == compressed, (part, name)
    assert sorted(n for n, x in tout["layers"]["tm"].items()
                  if isinstance(x, torch.Tensor)) == \
        ["ln_bias", "ln_scale", "mu", "u", "w0", "w_A", "w_B"]


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


def test_aida_serve_matches_reference_engine(jparams):
    """The slice's serving path, Engine(cfg).compress(aida).serve(...), on
    the same raw params: the port compresses them itself and serves on
    the CPU.  Three requests over two slots exercise refill (a slot's
    state is zeroed on admission); prompts feed token by token (chunk 4
    is asked for and forced to 1, as in the reference).  Tokens equal
    the reference Engine's, or differ first at a near-tie."""
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]]
    ref = JEngine(JCFG, params=jparams).compress(JSpec(**SPEC)).serve(
        [JRequest(prompt=p, max_new=6, rid=i) for i, p in enumerate(prompts)],
        batch_slots=2, max_len=MAX_LEN)
    raw = bridge.from_reference(jax.tree.map(np.asarray, jparams))
    eng = Engine(CFG, params=raw, device="cpu").compress(
        CompressionSpec(**SPEC))
    sess = eng.session(batch_slots=2, max_len=MAX_LEN, kv_cache="paged",
                       scheduler={"chunk": 4})
    assert sess.chunk == 1 and sess.alloc is None
    for i, p in enumerate(prompts):
        sess.submit(Request(prompt=p, max_new=6, rid=i))
    out = sess.run()
    _tokens_agree(ref, out, sess.margins)
    assert sess.stats["fills"] == 3 and sess.stats["nonfinite_logit_rows"] == 0
    # slot 1 serves rid 1 (2 + 6 - 1 steps) then rid 2 (3 + 6 - 1)
    assert sess.stats["steps"] == 15


def test_slot_reuse_serves_like_a_fresh_session():
    """A request admitted to a slot that served another one gets the same
    tokens as in a fresh session: the slot's recurrent state is zeroed."""
    eng = Engine(CFG, device="cpu", seed=3)
    reqs = [Request(prompt=[5, 6, 7], max_new=4, rid=0),
            Request(prompt=[11, 12], max_new=5, rid=1)]
    both = eng.serve(reqs, batch_slots=1, max_len=MAX_LEN)
    alone = eng.serve([Request(prompt=[11, 12], max_new=5, rid=1)],
                      batch_slots=1, max_len=MAX_LEN)
    assert both[1].tokens == alone[0].tokens
