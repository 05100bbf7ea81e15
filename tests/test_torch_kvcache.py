"""Port parity for the dense KV cache (``repro_torch.models.kvcache``,
full and ring) and the serving path over it, against the JAX package's
``models/kvcache.py`` and ``models/attention.py`` on the same numpy
inputs; decode against forward on the full cache for every decode family
(the reference's own check); full against paged serving; and the
registry of all ten architectures with the bridge's new leaves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import names as jnames
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import kvcache as jkvc
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api import Engine, Request
from repro_torch.configs import get, names, reduced
from repro_torch.launch import serve as launch
from repro_torch.models import attention as tattn
from repro_torch.models import kvcache as kvc
from repro_torch.models import model as TM

CFG = reduced(get("llama3-8b"), n_layers=2, d_model=64, d_ff=128, vocab=256)
DECODE_ARCHS = [a for a in names() if get(a).has_decode]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cache(rng, b, hkv, slots, dh):
    """A bf16 cache holding random history: every slot written at a
    position below 2 * slots, a few left empty (-1)."""
    k = rng.normal(size=(b, hkv, slots, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, slots, dh)).astype(np.float32)
    pos = rng.integers(0, 2 * slots, size=(b, slots)).astype(np.int32)
    pos[rng.random((b, slots)) < 0.2] = -1
    jc = jkvc.KVCache(jnp.asarray(k).astype(jnp.bfloat16),
                      jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(pos))
    return jc, bridge.from_reference(_np(jc))


def _assert_cache_equal(jc, tc):
    want = bridge.from_reference(_np(jc))
    for name, a, b in zip(kvc.KVCache._fields, want, tc):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("ring", [False, True])
def test_update_matches_reference_bit_for_bit(ring):
    """Five tokens written one at a time into a full or a ring cache of 8
    slots, positions past the last slot included (a full cache drops
    those writes, as the reference's scatter does): k, v and pos equal
    the reference's bit for bit after every write."""
    rng = np.random.default_rng(0)
    jc, tc = _cache(rng, 3, 2, 8, 16)
    for step in range(5):
        cur = np.array([step, 7 + step, 3 * step + 2], np.int32)
        kn = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
        vn = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
        jc = jkvc.update(jc, jnp.asarray(kn), jnp.asarray(vn),
                         jnp.asarray(cur), ring=ring, strategy="scatter")
        out = kvc.update(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(cur), ring=ring)
        assert out is tc                      # written in place
        _assert_cache_equal(jc, tc)


def test_prefill_and_mask_match_reference_bit_for_bit():
    """prefill of a 6-token prefix with row lengths 6, 2 and 0, then
    attention_mask at several positions and windows (-1 = unbounded):
    equal to the reference's bit for bit."""
    rng = np.random.default_rng(1)
    jc, tc = _cache(rng, 3, 2, 8, 16)
    ks = rng.normal(size=(3, 2, 6, 16)).astype(np.float32)
    vs = rng.normal(size=(3, 2, 6, 16)).astype(np.float32)
    lengths = np.array([6, 2, 0], np.int32)
    jc = jkvc.prefill(jc, jnp.asarray(ks), jnp.asarray(vs),
                      jnp.asarray(lengths))
    kvc.prefill(tc, torch.from_numpy(ks), torch.from_numpy(vs),
                torch.from_numpy(lengths))
    _assert_cache_equal(jc, tc)
    for cur in ([0, 5, 9], [3, 3, 3], [15, 1, 8]):
        for window in (-1, 1, 4, 32):
            want = np.asarray(jkvc.attention_mask(
                jc, jnp.asarray(cur, jnp.int32), jnp.int32(window)))
            got = kvc.attention_mask(tc, torch.tensor(cur, dtype=torch.int32),
                                     window)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ring,window,cap", [
    (False, -1, None), (False, 5, 30.0), (True, 6, None), (True, -1, 50.0)])
def test_decode_attend_matches_reference(ring, window, cap):
    """decode_attend (update, then the masked softmax over the slots; G 2)
    against the reference's op by op: the written cache bit for bit, the
    output within 1e-4 (f32 sums in another order, then bf16)."""
    rng = np.random.default_rng(2)
    jc, tc = _cache(rng, 3, 2, 8, 16)
    q = rng.normal(size=(3, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
    v = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
    cur = np.array([4, 11, 17], np.int32)
    kw = dict(window=window, ring=ring, cap=cap, scale=0.25)
    with jax.disable_jit():
        jc, jo = jattn.decode_attend(jc, *(jnp.asarray(x) for x in
                                           (q, k, v, cur)), **kw)
    tc, to = tattn.decode_attend(tc, *(torch.from_numpy(x) for x in
                                       (q, k, v, cur)), **kw)
    _assert_cache_equal(jc, tc)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), rtol=0,
                               atol=1e-4)


def _smoke_cfg(arch):
    return reduced(get(arch))


@pytest.mark.parametrize("kv_cache", ["full", "paged"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch, kv_cache):
    """The reference's own decode-vs-forward check (tests/test_arch_smoke.
    py) on the port, B 2 x 16 tokens at ``reduced()`` size: token by token
    through the full cache (rwkv6: its recurrent state) and through bf16
    pages, the logits within 2 % of the forward's largest.  phi-3-vision
    decodes text, so its forward gets an empty image prefix.  The full
    cache repeats the forward's attention arithmetic; the pages' route
    sums in another order, and a MoE router with a near-tie (a 7e-4 gap
    between its second and third choice here) turns that into another
    expert for a token, whose k / v every later step reads: the MoE
    families' paged decode is held to finite logits, its full decode to
    the check."""
    if arch == "rwkv6-7b" and kv_cache == "paged":
        with pytest.raises(ValueError, match="attention-free"):
            TM.init_decode_state(_smoke_cfg(arch), 2, 16, kv_cache="paged")
        return
    cfg = _smoke_cfg(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 16)))
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        batch["img_embeds"] = torch.zeros((2, 0, cfg.d_model))
    with torch.no_grad():
        full, _ = TM.forward(cfg, params, batch, remat="none")
        state = TM.init_decode_state(cfg, 2, 16, kv_cache=kv_cache,
                                     page_size=4)
        if kv_cache == "paged":
            state["page_table"] = torch.arange(1, 9, dtype=torch.int32
                                               ).reshape(2, 4)
        outs = []
        for t in range(16):
            state, lg = TM.decode_step(cfg, params, state, toks[:, t])
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    scale = float(full.abs().max()) + 1e-6
    assert torch.isfinite(dec).all()
    if cfg.moe is None or kv_cache == "full":
        assert float((dec - full).abs().max()) / scale < 0.02
    if cfg.family == "rwkv6":
        assert float(state["layers"]["S"].abs().max()) > 0


def _tokens_agree(ref, out, margins):
    """Greedy streams agree, or first differ where the top-2 margin of the
    stream that ``margins`` belong to is below 1e-2 (a near-tie)."""
    assert [r.rid for r in ref] == [o.rid for o in out]
    for r, o in zip(ref, out):
        assert len(r.tokens) == len(o.tokens)
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            if a != b:
                assert margins[o.rid][j] < 1e-2, (o.rid, j)
                break


def test_session_paged_matches_full_serving():
    """The reference's refill-heavy case (five requests over two slots) on
    the port: the same greedy tokens through both cache kinds (bf16 pages;
    the two attention routes sum in other orders, so a near-tie may flip),
    no leaked pages, five fills, a page a request at least."""
    def reqs():
        return [Request(prompt=[1, 2 + r], max_new=3 + 2 * r, rid=r)
                for r in range(5)]
    eng = Engine(CFG, device="cpu")
    full = eng.session(batch_slots=2, max_len=32, kv_cache="full")
    for r in reqs():
        full.submit(r)
    ref = full.run()
    assert full.alloc is None and full.stats["fills"] == 5
    sess = eng.session(batch_slots=2, max_len=32, kv_cache="paged",
                       page_size=8, kv_dtype="bf16")
    for r in reqs():
        sess.submit(r)
    paged = sess.run()
    _tokens_agree(ref, paged, sess.margins)
    assert sess.alloc.in_use == 0
    assert sess.stats["fills"] == 5
    assert sess.stats["page_allocs"] >= 5


def test_ring_cache_matches_paged_with_reclamation():
    """h2o-danube (every layer windowed, reduced window 32): its full cache
    is a ring of 32 slots, and serving 56 tokens through it gives the
    paged serve's tokens (up to near ties) while the paged serve frees the
    pages behind the window, holding at most window / page + 2."""
    cfg = reduced(get("h2o-danube-1.8b"))
    eng = Engine(cfg, device="cpu")
    full = eng.session(batch_slots=1, max_len=80, kv_cache="full")
    assert full.state["layers"]["kv"].k.shape[3] == cfg.window == 32
    full.submit(Request(prompt=[1, 2, 3], max_new=56, rid=0))
    ref = full.run()
    sess = eng.session(batch_slots=1, max_len=80, kv_cache="paged",
                       page_size=8, kv_dtype="bf16")
    sess.submit(Request(prompt=[1, 2, 3], max_new=56, rid=0))
    paged = sess.run()
    _tokens_agree(ref, paged, sess.margins)
    assert sess.stats["pages_reclaimed_swa"] > 0
    assert sess.stats["pages_peak"] <= 32 // 8 + 2
    assert full.stats["pages_reclaimed_swa"] == 0


def test_full_cache_serves_at_chunk_1():
    """Chunked prefill writes into pages: chunk 8 asked of a full-cache
    session serves at chunk 1 (no chunked step), as in the reference,
    with the tokens of a chunk-1 session; the slot's cache positions read
    as empty after a refill."""
    eng = Engine(CFG, device="cpu")
    outs = []
    for chunk in (8, 1):
        sess = eng.session(batch_slots=2, max_len=32, kv_cache="full",
                           scheduler={"chunk": chunk})
        assert sess.chunk == 1 and sess.stats["chunk"] == 1
        for r in range(3):
            sess.submit(Request(prompt=list(range(1, 12 - 4 * r)),
                                max_new=4, rid=r))
        outs.append([r.tokens for r in sess.run()])
        assert sess.stats["prefill_steps"] == 0
    assert outs[0] == outs[1]
    sess._reset_slot_state(0)
    pos = sess.state["layers"]["kv"].pos
    assert (pos[:, 0] == -1).all() and (pos[:, 1] >= 0).any()


def test_launcher_serves_from_the_full_cache(tmp_path, capsys):
    """``--kv-cache full`` on the launcher (reduced hymba, CPU): every
    request served at chunk 1; an encoder is refused with exit code 2."""
    js = tmp_path / "m.json"
    assert launch.main(["--arch", "hymba-1.5b", "--device", "cpu",
                        "--kv-cache", "full", "--requests", "3",
                        "--max-new", "4", "--json", str(js)]) == 0
    out = capsys.readouterr().out
    assert "kv=full chunk=1" in out and "3/3 requests" in out
    with pytest.raises(SystemExit) as e:
        launch.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    assert e.value.code == 2


# ------------------------------------------------------- registry, bridge
def test_registry_matches_reference():
    """names() lists the reference's ten architectures, and every config
    (full and reduced) equals the reference's field for field, with the
    same layer windows, padded vocab, has_decode, sub_quadratic and
    parameter counts."""
    assert names() == jnames() and len(names()) == 10
    for arch in names():
        for cfg, jcfg in ((get(arch), jget(arch)),
                          (reduced(get(arch)), jreduced(jget(arch)))):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            for attr in ("layer_windows", "params_count",
                         "active_params_count"):
                assert getattr(cfg, attr)() == getattr(jcfg, attr)(), attr
            for attr in ("vocab_padded", "has_decode", "sub_quadratic",
                         "head_dim"):
                assert getattr(cfg, attr) == getattr(jcfg, attr), attr


@pytest.mark.parametrize("arch", ["hymba-1.5b", "hubert-xlarge",
                                  "phi-3-vision-4.2b"])
def test_bridge_carries_every_new_leaf(arch):
    """The reference's params of the three new architectures (layer-norm
    biases, hymba's mamba / ln_ssm subtrees, the audio frontend) and, for
    the decode families, its full decode state (KVCache, hymba's mamba
    conv / h) come across leaf for leaf, bit for bit, in the layout
    ``init_params`` / ``init_decode_state`` give."""
    jcfg, cfg = jreduced(jget(arch)), reduced(get(arch))
    jp = _np(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = bridge.from_reference(jp)
    own = TM.init_params(cfg, torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tflat = dict(_flat(tp))
    assert set(tflat) == set(dict(_flat(own)))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        got = tflat[key]
        assert tuple(got.shape) == leaf.shape and got.shape == \
            dict(_flat(own))[key].shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      leaf.astype(np.float32))
    if not cfg.has_decode:
        return
    jst = _np(JM.init_decode_state(jcfg, 2, 16))
    tst = bridge.from_reference(jst)
    assert isinstance(tst["layers"]["kv"], kvc.KVCache)
    own_st = TM.init_decode_state(cfg, 2, 16, kv_cache="full")
    for key, got in _flat(tst):
        assert got.shape == dict(_flat(own_st))[key].shape, key
        assert got.dtype == dict(_flat(own_st))[key].dtype, key


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, kvc.KVCache):
        for k, v in zip(tree._fields, tree):
            yield f"{prefix}{k}", v
    else:
        yield prefix.rstrip("/"), tree
