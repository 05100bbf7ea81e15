"""Port parity for the layer-norm encoder (hubert: audio frame features
through a frontend projection, non-causal attention, gelu MLP, per-frame
labels) and phi-3-vision (an image prefix of precomputed patch embeddings
before the text, the loss over the text tail, text-only decode), against
the JAX package on the same params (carried by ``repro_torch.bridge``) and
the same numpy batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import tune as jtune
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.api import Engine
from repro_torch.configs import get, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import leaves, tree_map

# as tests/test_torch_train.py
LOSS_TOL, GRAD_ABS, GRAD_REL = 2e-3, 5e-3, 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    jcfg, cfg = jreduced(jget(arch)), reduced(get(arch))
    if cfg.frontend == "vision":           # 8 image rows, as the arch smoke
        jcfg = dataclasses.replace(jcfg, n_img_tokens=8)
        cfg = dataclasses.replace(cfg, n_img_tokens=8)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("hubert-xlarge", "phi-3-vision-4.2b"):
        jcfg, cfg = _cfgs(arch)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, cfg, jp, bridge.from_reference(_np(jp)))
    return out


def _batch(jcfg, seq_len):
    """The reference pipeline's batch, and the port's (its own copy of the
    pipeline gives the same arrays) as tensors."""
    pc = jpipe.PipelineConfig(seed=0, global_batch=2, seq_len=seq_len)
    jb = jpipe.make_batch(jcfg, pc, 0)
    tb = tpipe.make_batch(jcfg, tpipe.PipelineConfig(
        seed=0, global_batch=2, seq_len=seq_len), 0)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    return jb, {k: torch.from_numpy(v) for k, v in tb.items()}


@pytest.mark.parametrize("shape", [(2, 9, 128), (3, 1280)])
def test_layer_norm_matches_reference(shape):
    """layer_norm (f32 mean / var, eps 1e-5, bf16 result) against the
    reference's on bf16 inputs and random scale / bias: equal, or one bf16
    rounding apart where the f32 sums (in other orders) straddle a
    boundary."""
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    p = {"scale": rng.normal(size=shape[-1:]).astype(np.float32),
         "bias": rng.normal(size=shape[-1:]).astype(np.float32)}
    want = np.asarray(jlayers.layer_norm(xb, jax.tree.map(jnp.asarray, p))
                      .astype(jnp.float32))
    got = tlayers.layer_norm(bridge.tensor(np.asarray(xb)),
                             {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().numpy() - want)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (gap <= ulp).all() and (gap > 0).mean() < 0.01
    init = tlayers.layer_norm_init(7)
    assert torch.equal(init["scale"], torch.ones(7))
    assert torch.equal(init["bias"], torch.zeros(7))


@pytest.mark.parametrize("window", [None, 5])
def test_noncausal_flash_attention_matches_reference(window):
    """attn_apply(causal=False, impl="flash") through K7's plain version
    against the reference's through its flash kernel (Pallas, interpret
    mode) on the same layer params and bf16 input, 2 x 24 tokens: the bf16
    outputs within one rounding (f32 inside both); and the port's flash
    route within 2e-2 of its einsum route, which rounds p to bf16."""
    rng = np.random.default_rng(3)
    d, h, dh = 64, 4, 16
    jp = jattn.attn_init(jax.random.PRNGKey(1), d, h, h, dh)
    tp = bridge.from_reference(_np(jp))
    x = jnp.asarray(rng.normal(size=(2, 24, d)).astype(np.float32)).astype(
        jnp.bfloat16)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    kw = dict(n_heads=h, n_kv=h, d_head=dh, causal=False)
    want = jattn.attn_apply(jp, x, jnp.asarray(pos), impl="flash",
                            window=-1 if window is None else window, **kw)
    tx = bridge.tensor(np.asarray(x))
    tpos = torch.from_numpy(pos.copy())
    win = -1 if window is None else window
    got = tattn.attn_apply(tp, tx, tpos, impl="flash", window=win, **kw)
    want = np.asarray(want.astype(jnp.float32))
    gap = np.abs(got.float().numpy() - want)
    assert (gap <= np.abs(want) * 2.0 ** -7 + 1e-6).all()
    ein = tattn.attn_apply(tp, tx, tpos, impl="einsum", window=win, **kw)
    assert float((ein.float() - got.float()).abs().max()) <= 2e-2
    # the plain versions see the same non-causal mask as the reference's
    q = rng.normal(size=(1, 2, 16, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 16, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 16, 16)).astype(np.float32)
    ref = jops.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                         window=window, impl="ref")
    from repro_torch.kernels import ops as tops
    out = tops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=False, window=window, impl="flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _first_layer_within_a_rounding(jcfg, cfg, jp, tp, jb, tb):
    """Layer 0's output, op by op on both sides: equal but for at most
    0.1 % of its values, each within one bf16 rounding of the layer's
    largest value (the f32 sums before a rounding run in other orders, so
    now and then a value lands on the other side of a boundary, and the
    residual add rounds the moved value again)."""
    with jax.disable_jit():
        if cfg.frontend == "audio":
            jx = jlayers.dense(jnp.asarray(jb["frames"]).astype(jnp.bfloat16),
                               jp["frontend"])
        else:
            jx = jnp.concatenate([jnp.asarray(jb["img_embeds"]).astype(
                jnp.bfloat16), jlayers.embed(jnp.asarray(jb["tokens"]),
                                             jp["embed"])], axis=1)
        b, s, _ = jx.shape
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        jy, _ = JT.block_forward(jcfg, jax.tree.map(lambda a: a[0],
                                                    jp["layers"]),
                                 jx, pos, -1)
    tx = TM._inputs(cfg, tp, tb)
    assert torch.equal(tx, bridge.tensor(np.asarray(jx)))
    ty, _ = TT.block_forward(cfg, TT.layer_view(tp["layers"], 0), tx,
                             torch.arange(s)[None].expand(b, s), -1)
    want = np.asarray(jy.astype(jnp.float32))
    gap = np.abs(ty.float().numpy() - want)
    assert gap.max() <= np.abs(want).max() * 2.0 ** -7
    assert (gap > 0).mean() <= 1e-3


def _logits_close(got, want):
    """Logits within 2 % of the largest (the reference's decode-vs-forward
    bound): a value one rounding apart in layer 0 (see
    _first_layer_within_a_rounding) reaches the later positions, or, in an
    encoder, every position."""
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_hubert_forward_matches_reference(models):
    """hubert's forward on the pipeline's frames (2 x 24 frames of 512
    features): the frontend projection, layer norms, non-causal einsum
    attention and the ungated gelu MLP op by op on both sides; layer 0
    within a rounding, the logits within 2 % of the largest."""
    jcfg, cfg, jp, tp = models["hubert-xlarge"]
    assert cfg.family == "encoder" and not cfg.causal and cfg.norm == "layer"
    jb, tb = _batch(jcfg, 24)
    _first_layer_within_a_rounding(jcfg, cfg, jp, tp, jb, tb)
    with jax.disable_jit():
        jl, _ = JM.forward(jcfg, jp, {"frames": jnp.asarray(jb["frames"])},
                           remat="none")
    tl, aux = TM.forward(cfg, tp, {"frames": tb["frames"]}, remat="none")
    assert tl.shape == (2, 24, cfg.vocab_padded)
    _logits_close(tl.numpy(), np.asarray(jl))


def _loss_and_grads_match(jcfg, cfg, jp, jb, tb, attn_impl="einsum"):
    def jloss(p):
        return JM.loss_fn(jcfg, p, jb, attn_impl="einsum", remat="none")
    (jval, _), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    live = tree_map(lambda a: a.clone().requires_grad_(True),
                    bridge.from_reference(_np(jp)))
    val, aux = TM.loss_fn(cfg, live, tb, attn_impl=attn_impl, remat="dots")
    assert float(aux["aux"]) == 0.0
    assert abs(float(val.detach()) - float(jval)) <= LOSS_TOL
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    # an audio model never reads its token embedding: no gradient (zero)
    got = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
           for p, g in zip(leaves(live), torch.autograd.grad(
               val, leaves(live), allow_unused=True))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_ABS
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w)
    return float(val.detach())


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_hubert_loss_and_gradients_match_reference(models, attn_impl):
    """hubert's loss over per-frame labels (every position, no shift) and
    its gradient over every param (the frontend, layer-norm scales and
    biases included) against jax.value_and_grad of the reference's einsum
    loss (eager, as tests/test_torch_train.py runs it), the port by einsum
    and by flash (K7 / K8's plain versions, non-causal), within that
    file's limits.  A label of -1 is masked."""
    jcfg, cfg, jp, _ = models["hubert-xlarge"]
    jb, tb = _batch(jcfg, 24)
    jb["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    loss = _loss_and_grads_match(jcfg, cfg, jp, jb, tb, attn_impl)
    # the labels, not shifted tokens, are what it predicts
    tb["labels"] = torch.roll(tb["labels"], 1, dims=1)
    with torch.no_grad():
        other, _ = TM.loss_fn(cfg, bridge.from_reference(_np(jp)), tb)
    assert abs(float(other) - loss) > 1e-3


def test_phi3_vision_forward_matches_reference(models):
    """phi-3-vision's forward on the pipeline's batch (8 image rows, then
    24 text tokens) op by op on both sides: the image rows go first;
    layer 0 within a rounding, the logits [2, 32, Vpad] within 2 % of the
    largest."""
    jcfg, cfg, jp, tp = models["phi-3-vision-4.2b"]
    jb, tb = _batch(jcfg, 32)
    assert tb["tokens"].shape == (2, 24)
    assert tb["img_embeds"].shape == (2, 8, cfg.d_model)
    _first_layer_within_a_rounding(jcfg, cfg, jp, tp, jb, tb)
    with jax.disable_jit():
        jl, _ = JM.forward(jcfg, jp, jax.tree.map(jnp.asarray, jb),
                           remat="none")
    tl, _ = TM.forward(cfg, tp, tb, remat="none")
    assert tl.shape == (2, 32, cfg.vocab_padded)
    _logits_close(tl.numpy(), np.asarray(jl))
    # the image rows lead: other image rows change every text position
    tb2 = dict(tb, img_embeds=tb["img_embeds"] * 2)
    tl2, _ = TM.forward(cfg, tp, tb2, remat="none")
    assert float((tl2[:, 8:] - tl[:, 8:]).abs().max()) > 1e-3


def test_phi3_vision_text_tail_loss_matches_reference(models):
    """The loss over the text tail only (next-token labels of the 24 text
    positions; the image rows carry none) and its gradients against the
    reference's, streamed (chunks of 8) and whole."""
    jcfg, cfg, jp, tp = models["phi-3-vision-4.2b"]
    jb, tb = _batch(jcfg, 32)
    loss = _loss_and_grads_match(jcfg, cfg, jp, jb, tb)
    with torch.no_grad():
        streamed, _ = TM.loss_fn(cfg, tp, tb, streamed_loss=True,
                                 loss_chunk=8)
    with jax.disable_jit():
        jstreamed, _ = JM.loss_fn(jcfg, jp, jb, streamed_loss=True,
                                  loss_chunk=8)
    assert abs(float(streamed) - float(jstreamed)) <= LOSS_TOL
    assert abs(float(streamed) - loss) <= LOSS_TOL


@pytest.mark.parametrize("kv_cache", ["full", "paged"])
def test_phi3_vision_text_decode_matches_reference(models, kv_cache):
    """phi-3-vision decodes text only, as the reference serves it: six
    decode steps from empty state on the full cache or bf16 pages (the
    reference's paged attention pinned to its Pallas kernel in interpret
    mode, the arithmetic K2 keeps, as tests/test_torch_families.py does),
    logits within 1e-4 of the reference's op by op at every step
    (multi-head attention, H = Hkv)."""
    jcfg, cfg, jp, tp = models["phi-3-vision-4.2b"]
    saved = dict(jtune._CACHE)
    jtune.record(jtune.paged_key(jcfg.n_kv, 1, jcfg.head_dim, 8, 2, 2,
                                 False, True),
                 jtune.KernelChoice("pallas", (("pb", 2),)))
    kw = dict(kv_cache=kv_cache, page_size=8, kv_dtype="bf16")
    jst = JM.init_decode_state(jcfg, 2, 16, **kw)
    tst = TM.init_decode_state(cfg, 2, 16, **kw)
    if kv_cache == "paged":
        table = np.arange(1, 5, dtype=np.int32).reshape(2, 2)
        jst["page_table"] = jnp.asarray(table)
        tst["page_table"] = torch.from_numpy(table)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(6, 2))
    for t in range(6):
        with jax.disable_jit():
            jst, jl = JM.decode_step(jcfg, jp, jst,
                                     jnp.asarray(toks[t], jnp.int32))
        tst, tl = TM.decode_step(cfg, tp, tst, torch.from_numpy(toks[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


def test_hubert_session_is_refused(models):
    """An encoder has no decode step: a session raises, as the reference
    asserts; chunked prefill reports no support either."""
    from repro_torch.sched import supports_chunked_prefill
    _, cfg, _, tp = models["hubert-xlarge"]
    assert not cfg.has_decode and not supports_chunked_prefill(cfg)
    with pytest.raises(ValueError, match="encoder"):
        Engine(cfg, params=tp, device="cpu").session()
