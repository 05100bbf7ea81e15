"""Port parity for the families of slice 11: qwen1.5 (qkv bias, tied head),
h2o-danube (every layer windowed: SWA page reclamation), gemma2 (post-norms,
gelu, softcaps, alternating windows, embed scale), mixtral and dbrx (MoE).

For each architecture at ``reduced()`` size the port's ``forward``,
``decode_step`` and ``prefill_step`` are held against the JAX package's on
the same params (carried by ``repro_torch.bridge``) and inputs made with
numpy, and a greedy ``Engine.compress(aida).serve`` at chunk 1 and 8 gives
the reference's tokens.  Also K7 / K8's plain versions at the head dims
these families bring (80, 96, 256) against the reference's flash kernels
in interpret mode."""
import dataclasses

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
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from repro.models import model as JM
from repro.sched import prefill as jprefill
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as TM
from repro_torch.sched import prefill_step

ARCHS = ["qwen1.5-0.5b", "h2o-danube-1.8b", "gemma2-2b", "mixtral-8x7b",
         "dbrx-132b"]
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
B, MAX_LEN, PS = 3, 64, 4
SPEC = dict(mode="aida", density=0.25)


def _cfgs(arch):
    return jreduced(jget(arch), **SMALL), reduced(get(arch), **SMALL)


@pytest.fixture(scope="module")
def jparams():
    cache = {}

    def params(arch):
        if arch not in cache:
            cache[arch] = JM.init_params(_cfgs(arch)[0],
                                         jax.random.PRNGKey(0))
        return cache[arch]
    return params


@pytest.fixture
def pin_paged():
    """Route the reference's paged attention (decode and chunk) through its
    Pallas kernels, the arithmetic the port's K2 / K3 keep, instead of a
    timing-dependent tuner pick (its other candidate, the XLA gather,
    rounds elsewhere); the tuner cache is restored afterwards."""
    saved = dict(jtune._CACHE)

    def pin(jcfg, batch, page_size, max_len, chunk, pb=2):
        geo = (jcfg.n_kv, jcfg.n_heads // jcfg.n_kv, jcfg.head_dim,
               page_size, max_len // page_size, batch)
        jtune.record(jtune.paged_key(*geo, False, True),
                     jtune.KernelChoice("pallas", (("pb", pb),)))
        jtune.record(jtune.paged_chunk_key(*geo, chunk, False, True),
                     jtune.KernelChoice("pallas", (("pb", pb),
                                                   ("qt", chunk))))
    yield pin
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    ref, port = dataclasses.asdict(jget(arch)), dataclasses.asdict(get(arch))
    assert port == ref
    jcfg, cfg = _cfgs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_windows() == jcfg.layer_windows()
    assert get(arch).head_dim == jget(arch).head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(jparams, arch):
    """The training forward (einsum attention) op by op on both sides: both
    round to bf16 at the same places and differ only in f32 sum order,
    logits within 1e-4 and the MoE aux within 1e-6."""
    jcfg, cfg = _cfgs(arch)
    params = jparams(arch)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32)
    with jax.disable_jit():
        jl, jaux = JM.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                              remat="none")
    tl, taux = TM.forward(cfg, bridge.from_reference(_np(params)),
                          {"tokens": torch.from_numpy(tokens)},
                          remat="none")
    assert tl.shape == jl.shape and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert (float(taux) > 0) == (cfg.moe is not None)


def _paged_state(jcfg, rng):
    """A paged bf16 decode state holding history: row 0 at position 3
    over pages 1-4, row 1 at position 9 with a hole (-1), row 2 idle."""
    jstate = JM.init_decode_state(jcfg, B, MAX_LEN, kv_cache="paged",
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
    return jstate


def _assert_pages_equal(jstate, tstate):
    pages = bridge.from_reference(_np(jstate["layers"]["kv"]))
    got = tstate["layers"]["kv"]
    assert torch.equal(pages.k_pages[:, 1:], got.k_pages[:, 1:])
    assert torch.equal(pages.v_pages[:, 1:], got.v_pages[:, 1:])
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(jparams, pin_paged, arch):
    """One decode step over a paged bf16 pool with history, the reference
    op by op: logits within 1e-4 and the written pages bit for bit."""
    jcfg, cfg = _cfgs(arch)
    pin_paged(jcfg, B, PS, MAX_LEN, 1)
    params = jparams(arch)
    rng = np.random.default_rng(2)
    jstate = _paged_state(jcfg, rng)
    tstate = bridge.from_reference(_np(jstate))
    tok = rng.integers(0, cfg.vocab, size=B).astype(np.int32)
    with jax.disable_jit():
        jstate, jl = JM.decode_step(jcfg, params, jstate, jnp.asarray(tok))
    tstate, tl = TM.decode_step(cfg, bridge.from_reference(_np(params)),
                                tstate, torch.from_numpy(tok))
    ref, out = np.asarray(jl)[:2], tl.numpy()[:2]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    _assert_pages_equal(jstate, tstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(jparams, pin_paged, arch):
    """One chunked step (row 0 a full chunk, row 1 two tokens, row 2 idle)
    over the same pool, the reference op by op: the fed positions' logits
    within 1e-4 and the written pages bit for bit."""
    jcfg, cfg = _cfgs(arch)
    chunk = 4
    pin_paged(jcfg, B, PS, MAX_LEN, chunk)
    params = jparams(arch)
    rng = np.random.default_rng(3)
    jstate = _paged_state(jcfg, rng)
    tstate = bridge.from_reference(_np(jstate))
    tokens = rng.integers(0, cfg.vocab, size=(B, chunk)).astype(np.int32)
    n_tok = np.array([chunk, 2, 0], np.int32)
    with jax.disable_jit():
        jstate, jl = jprefill.prefill_step(jcfg, params, jstate,
                                           jnp.asarray(tokens),
                                           jnp.asarray(n_tok))
    tstate, tl = prefill_step(cfg, bridge.from_reference(_np(params)),
                              tstate, torch.from_numpy(tokens).long(),
                              torch.from_numpy(n_tok))
    fed = np.arange(chunk)[None, :] < n_tok[:, None]
    ref, out = np.asarray(jl)[fed], tl.numpy()[fed]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    _assert_pages_equal(jstate, tstate)


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


# three requests over two slots (refill); where a layer is windowed the
# first prompt runs past the reduced window of 32 (h2o-danube and mixtral
# then reclaim pages), elsewhere it is cut to 12 tokens
PROMPTS = [[(5 * j + 1) % 200 for j in range(52)], [7, 8], [9, 10, 11, 12]]


def _prompts(cfg):
    if any(w > 0 for w in cfg.layer_windows()):
        return PROMPTS
    return [PROMPTS[0][:12]] + PROMPTS[1:]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_engine(jparams, pin_paged, arch):
    """Engine(cfg).compress(aida).serve on the same raw params, at chunk 1
    and at chunk 8: greedy tokens agree with the reference's at the same
    chunk up to near-tie flips, with the same SWA page reclamation count
    and no leaked page.  MoE layers route the batch as the reference does
    (a decode step is one group of 2 tokens, a chunk one of 16), so each
    chunk is held against the reference at that chunk."""
    jcfg, cfg = _cfgs(arch)
    params = jparams(arch)
    jeng = JEngine(jcfg, params=params).compress(JSpec(**SPEC))
    eng = Engine(cfg, params=bridge.from_reference(_np(params)),
                 device="cpu").compress(CompressionSpec(**SPEC))
    windowed = all(w > 0 for w in cfg.layer_windows())
    for chunk in (1, 8):
        # the whole table (4 pages) a grid step: fewer interpreted steps
        pin_paged(jcfg, 2, 16, MAX_LEN, chunk, pb=MAX_LEN // 16)
        jsess = jeng.session(batch_slots=2, max_len=MAX_LEN,
                             scheduler={"chunk": chunk})
        sess = eng.session(batch_slots=2, max_len=MAX_LEN,
                           scheduler={"chunk": chunk})
        for i, p in enumerate(_prompts(cfg)):
            jsess.submit(JRequest(prompt=p, max_new=8, rid=i))
            sess.submit(Request(prompt=p, max_new=8, rid=i))
        ref, out = jsess.run(), sess.run()
        _tokens_agree(ref, out, sess.margins)
        reclaimed = sess.stats["pages_reclaimed_swa"]
        assert reclaimed == jsess.stats["pages_reclaimed_swa"]
        assert (reclaimed > 0) == windowed
        assert sess.alloc.in_use == 0
        assert sess.stats["nonfinite_logit_rows"] == 0


def test_swa_reclaim_frees_only_pages_behind_the_window():
    """reclaimable_prefix against the reference's, and a served sequence
    holds O(window) pages: its peak stays under window / page + 2."""
    from repro.kvstore import alloc as jalloc
    from repro_torch import kvstore as kvs
    for pos in range(0, 80, 3):
        for window, ps in ((32, 16), (32, 4), (-1, 16), (5, 4)):
            assert kvs.reclaimable_prefix(pos, window, ps) == \
                jalloc.reclaimable_prefix(pos, window, ps)
    cfg = reduced(get("h2o-danube-1.8b"), **SMALL)
    eng = Engine(cfg, device="cpu")
    sess = eng.session(batch_slots=1, max_len=128, page_size=4)
    sess.submit(Request(prompt=list(range(1, 90)), max_new=4, rid=0))
    sess.run()
    assert sess.stats["pages_reclaimed_swa"] > 0
    assert sess.alloc.peak <= cfg.window // 4 + 2
    assert sess.alloc.in_use == 0


# ------------------------------------------------ K7 / K8 at the new widths
def _flash_inputs(rng, h, hkv, t, d):
    q = (rng.normal(size=(1, h, t, d)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(1, hkv, t, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(1, hkv, t, d)).astype(np.float32)
    do = rng.normal(size=(1, h, t, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("d,causal,window,softcap", [
    (80, True, None, None), (96, True, 64, None), (256, True, None, 50.0),
    (256, False, None, None)])
def test_plain_flash_matches_pallas_at_new_head_dims(d, causal, window,
                                                     softcap):
    """K7 / K8's plain versions against the reference's Pallas kernels
    (interpret mode) at the head dims of h2o-danube (80), phi-3-vision
    (96) and gemma2 (256), T = 128: f32 on both sides, only the sum order
    differs."""
    rng = np.random.default_rng(d)
    q, k, v, do = _flash_inputs(rng, 4, 2, 128, d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_fwd(jq, jk, jv, bq=64, bk=64, **kw)
    want = flash_attention_bwd(jq, jk, jv, o, lse, jdo, bq=64, bk=64, **kw)
    t = bridge.tensor
    to, tlse = fa.flash_attention_fwd(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), rtol=1e-5,
                               atol=1e-5)
    got = fa.flash_attention_bwd(t(q), t(k), t(v), t(np.asarray(o)),
                                 t(np.asarray(lse)), t(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=2e-5)


def test_flash_wrapper_takes_the_new_widths_only():
    """The wrappers' input check takes 32, 64, 80, 96, 128 and 256 and
    still refuses anything else (48, 512)."""
    for d in (32, 64, 80, 96, 128, 256):
        z = torch.zeros((1, 4, 16, d))
        fa._check(z, z[:, :2], z[:, :2])
    for d in (48, 512):
        z = torch.zeros((1, 4, 16, d))
        with pytest.raises(ValueError, match="head dims"):
            fa._check(z, z[:, :2], z[:, :2])
