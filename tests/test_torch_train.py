"""Port parity for the training path: ``attn_apply``, ``loss_fn`` and its
gradients, AdamW, ``make_train_step`` and the data pipeline of the port
against the JAX package, on the same params carried across by
``repro_torch.bridge`` and the same numpy batches.

Tolerances.  Both sides round activations to bf16 at the same places, but
a value near a bf16 rounding boundary flips by one bf16 unit (0.4 %) on
a tiny f32 difference, and the flip travels.  The reference's own spread
between two orderings of the same einsum loss (``loss_fn``'s scan against
a per-layer loop, reduced llama3-8b, B=2, T=64) is 7.7e-4 in the loss,
2.3e-3 max abs and 1.1e-2 relative L2 in the gradients; the port is held
to 2e-3 / 5e-3 / 2e-2, above that floor and far below what a wrong term
(a scale, the mask, the softcap chain rule) would cost.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.data import pipeline as jpipe
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.runtime import fault_tolerance as jft
from repro.train import trainer as jtrainer
from repro_torch import bridge
from repro_torch.configs import get, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves, tree_map
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.train import trainer

LOSS_TOL, GRAD_ABS, GRAD_REL = 2e-3, 5e-3, 2e-2
KV = [4, 2]                      # reduced llama3-8b (MHA) and a GQA variant


def _cfgs(n_kv):
    return (dataclasses.replace(jreduced(jget("llama3-8b")), n_kv=n_kv),
            dataclasses.replace(reduced(get("llama3-8b")), n_kv=n_kv))


@pytest.fixture(scope="module")
def setup():
    """Per n_kv: configs, reference params, bridged params, one batch."""
    out = {}
    for n_kv in KV:
        jcfg, cfg = _cfgs(n_kv)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        batch = jpipe.make_batch(jcfg, jpipe.PipelineConfig(
            seed=0, global_batch=2, seq_len=64), 0)
        out[n_kv] = (jcfg, cfg, jp, bridge.from_reference(
            jax.tree.map(np.asarray, jp)), batch)
    return out


def _ref_flash_loop(jcfg, batch):
    """The reference's flash loss, layer by layer: its ``stack_forward``
    scans the windows as traced data, which ``attn_apply(impl="flash")``
    cannot turn into the static int the kernel needs, so the layers are
    unrolled here with ``int(window)`` around the same pieces."""
    toks = jnp.asarray(batch["tokens"])

    def loss(params):
        x = JL.embed(toks, params["embed"])
        b, s, _ = x.shape
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        for i, w in enumerate(jcfg.layer_windows()):
            layer = jax.tree.map(lambda a: a[i], params["layers"])
            x, _ = JT.block_forward(jcfg, layer, x, pos, int(w),
                                    attn_impl="flash")
        x = JT._norm(jcfg)(x, params["final_norm"])
        logits = jnp.matmul(x, params["lm_head"].astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
        labels = toks[:, 1:]
        return JM._xent(logits[:, :-1], jnp.maximum(labels, 0),
                        (labels >= 0).astype(jnp.float32), jcfg.vocab)
    return loss


@pytest.fixture(scope="module")
def ref_grads(setup):
    """(loss, grad leaves) of the reference: ``loss_fn`` (einsum) and the
    per-layer flash loop, per n_kv."""
    out = {}
    for n_kv, (jcfg, _, jp, _, batch) in setup.items():
        fns = {"einsum": lambda p: JM.loss_fn(jcfg, p, batch,
                                              attn_impl="einsum")[0],
               "flash": _ref_flash_loop(jcfg, batch)}
        for impl, fn in fns.items():
            val, g = jax.value_and_grad(fn)(jp)
            out[n_kv, impl] = (float(val),
                               [np.asarray(x) for x in jax.tree.leaves(g)])
    return out


def _port_grads(cfg, tp, batch, **kw):
    live = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    lval, aux = TM.loss_fn(cfg, live, {"tokens": torch.from_numpy(
        batch["tokens"])}, **kw)
    assert float(aux["aux"]) == 0.0
    grads = torch.autograd.grad(lval, leaves(live))
    return float(lval.detach()), [g.numpy() for g in grads]


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_ABS
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w)


# ------------------------------------------------------------ attn_apply
@pytest.mark.parametrize("impl,window,cap", [
    ("einsum", -1, None), ("einsum", 9, 20.0), ("chunked", -1, None),
    ("chunked", 9, None), ("flash", -1, None), ("flash", 9, 20.0)])
@pytest.mark.parametrize("n_kv", KV)
def test_attn_apply_matches_reference(setup, impl, window, cap, n_kv):
    """One attention layer on the same bf16 input: the outputs are bf16
    and differ by at most one bf16 unit where a rounding flips (2^-7
    relative), and by nothing on average."""
    jcfg, cfg, jp, tp, _ = setup[n_kv]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    pos = np.broadcast_to(np.arange(32)[None], (2, 32)).astype(np.int32)
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv, d_head=jcfg.head_dim,
              window=window, cap=cap, theta=jcfg.rope_theta, impl=impl,
              chunk=8)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want = np.asarray(JA.attn_apply(jlayer, jx, jnp.asarray(pos), **kw),
                      np.float32)
    got = TA.attn_apply(TT.unstack(tp["layers"]["attn"], 2)[0],
                        bridge.tensor(np.asarray(jx)),
                        torch.from_numpy(pos), **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    assert np.abs(got - want).mean() < 1e-4


# --------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("n_kv", KV)
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_loss_fn_and_grads_match_reference(setup, ref_grads, n_kv, impl):
    """einsum against the reference's ``loss_fn``; flash against its
    per-layer flash loop (Pallas in interpret mode)."""
    _, cfg, _, tp, batch = setup[n_kv]
    loss, grads = _port_grads(cfg, tp, batch, attn_impl=impl)
    want_loss, want_grads = ref_grads[n_kv, impl]
    assert abs(loss - want_loss) <= LOSS_TOL
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("n_kv", KV)
def test_streamed_loss_matches_reference_xent(setup, ref_grads, n_kv):
    """The streamed cross-entropy over 24-token chunks (63 positions: a
    ragged last chunk) against the reference's whole-logits ``_xent``."""
    _, cfg, _, tp, batch = setup[n_kv]
    loss, grads = _port_grads(cfg, tp, batch, attn_impl="einsum",
                              streamed_loss=True, loss_chunk=24)
    want_loss, want_grads = ref_grads[n_kv, "einsum"]
    assert abs(loss - want_loss) <= LOSS_TOL
    _assert_grads_close(grads, want_grads)


def test_remat_full_equals_dots_and_bad_remat_raises(setup):
    """Recomputing each layer in the backward changes no number."""
    _, cfg, _, tp, batch = setup[2]
    a = _port_grads(cfg, tp, batch, attn_impl="flash", remat="dots")
    b = _port_grads(cfg, tp, batch, attn_impl="flash", remat="full")
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="remat"):
        _port_grads(cfg, tp, batch, remat="some")


def _saved_bytes(cfg, tp, batch, remat):
    """Bytes that the forward allocates and leaves alive for the backward
    (the autograd graph's saved tensors, a checkpoint's inputs and the
    selective policy's kept outputs), counted by storage: every op output
    of the forward is tracked, and what is still alive after it counts.
    (Hooks of ``saved_tensors_hooks`` do not see inside a checkpoint, whose
    own hooks take their place there.)  Then the backward runs."""
    import gc
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    made = []

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend(weakref.ref(t.untyped_storage())
                        for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out

    live = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    with Track():
        lval, _ = TM.loss_fn(cfg, live, {"tokens": torch.from_numpy(
            batch["tokens"])}, attn_impl="flash", remat=remat)
    gc.collect()
    alive = {st.data_ptr(): st.nbytes() for st in (r() for r in made)
             if st is not None}
    torch.autograd.grad(lval, leaves(live))
    return sum(alive.values())


def test_remat_dots_saves_only_the_products(setup, ref_grads, monkeypatch):
    """The reference's "dots" policy: each layer keeps the outputs of its
    products with no batch dims (``aten.mm``, one per projection) and
    recomputes the rest.  Grads equal "none" and "full" bit for bit and
    stay within the tolerance of the reference's; the bytes the forward
    leaves for the backward order "full" < "dots" < "none"."""
    _, cfg, _, tp, batch = setup[2]
    saved = []
    policy = TT._dots_policy

    def spy(ctx, op, *a, **kw):
        out = policy(ctx, op, *a, **kw)
        if not ctx.is_recompute and out == \
                torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out
    monkeypatch.setattr(TT, "_dots_policy", spy)
    grads = {r: _port_grads(cfg, tp, batch, attn_impl="flash", remat=r)
             for r in TT.REMAT}
    assert saved and set(saved) <= set(TT._DOTS)
    assert len(saved) == 7 * cfg.n_layers      # q, k, v, o, gate, up, down
    for r in ("none", "full"):
        assert grads[r][0] == grads["dots"][0]
        for x, y in zip(grads[r][1], grads["dots"][1]):
            np.testing.assert_array_equal(x, y)
    want_loss, want_grads = ref_grads[2, "flash"]
    assert abs(grads["dots"][0] - want_loss) <= LOSS_TOL
    _assert_grads_close(grads["dots"][1], want_grads)
    monkeypatch.setattr(TT, "_dots_policy", policy)
    held = {r: _saved_bytes(cfg, tp, batch, r) for r in TT.REMAT}
    assert held["full"] < held["dots"] < held["none"], held


# ----------------------------------------------------------------- AdamW
def test_adamw_apply_matches_reference(setup):
    """Two AdamW steps (the second from non-zero moments) on the same
    params and grads, warmup and clipping active: params, m and v within
    f32 rounding (rtol 1e-5, atol 1e-7), grad_norm and lr too."""
    jcfg, _, jp, _, _ = setup[2]
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                              clip_norm=0.5)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(ocfg))
    rng = np.random.default_rng(2)
    jgrads = [jax.tree.map(lambda p: jnp.asarray(rng.normal(
        size=p.shape).astype(np.float32) * 0.1), jp) for _ in range(2)]
    jopt = jadamw.init(jp)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jp))
    topt = bridge.from_reference(jax.tree.map(np.asarray, jopt))
    jparams = jp
    for jg in jgrads:
        jparams, jopt, jm = jadamw.apply(ocfg, jparams, jopt, jg)
        tparams, topt, tm = adamw.apply(
            tcfg, tparams, topt,
            bridge.from_reference(jax.tree.map(np.asarray, jg)))
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(topt.step) == int(jopt.step) == 2
    for tree_t, tree_j in ((tparams, jparams), (topt.m, jopt.m),
                           (topt.v, jopt.v)):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = jadamw.AdamWConfig()
    want = float(jadamw.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = float(adamw.schedule(adamw.AdamWConfig(),
                               torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compression", [None, "bf16", "int8"])
def test_train_steps_match_reference(setup, microbatches, compression):
    """Three ``make_train_step`` steps from the same bridged TrainState on
    the same batches: per-step losses within 4e-3 (twice the loss
    tolerance: from the second step on, the params carry the first steps'
    noise), and the params' total change within 3e-2 relative L2 of the
    reference's per leaf (1.5e-2 measured, with int8 compression).  eps = 1 keeps AdamW's step about linear in the gradient (its
    sqrt(v) is <= 0.3 here): at the default eps the first steps move each
    weight by about +-lr whatever the gradient's size, so a tiny gradient
    whose sign the bf16 noise flips would swing the comparison."""
    jcfg, cfg, jp, _, _ = setup[2]
    opt = dict(lr=1e-2, warmup_steps=1, eps=1.0)
    jtc = jtrainer.TrainConfig(opt=jadamw.AdamWConfig(**opt),
                               microbatches=microbatches,
                               grad_compression=compression)
    ttc = trainer.TrainConfig(opt=adamw.AdamWConfig(**opt),
                              microbatches=microbatches,
                              grad_compression=compression)
    jstate = jtrainer.TrainState(params=jp, opt=jadamw.init(jp))
    tstate = bridge.from_reference(jax.tree.map(np.asarray, jstate))
    assert isinstance(tstate, trainer.TrainState)
    start = [p.clone() for p in leaves(tstate.params)]
    jstep = jtrainer.make_train_step(jcfg, jtc)
    tstep = trainer.make_train_step(cfg, ttc)
    pc = jpipe.PipelineConfig(seed=3, global_batch=4, seq_len=32)
    for i in range(3):
        batch = jpipe.make_batch(jcfg, pc, i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2 * LOSS_TOL
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
    assert int(tstate.opt.step) == 3
    for p0, pt, pj in zip(start, leaves(tstate.params),
                          jax.tree.leaves(jstate.params)):
        dt, dj = (pt - p0).numpy(), np.asarray(pj) - p0.numpy()
        assert np.linalg.norm(dt - dj) <= 3e-2 * np.linalg.norm(dj)


def test_cast_params_bf16_grads_reach_f32_params(setup):
    """With ``cast_params_bf16`` the matrices enter the loss as bf16 and
    their gradients come back to the f32 params: the step matches the
    reference's."""
    jcfg, cfg, jp, _, batch = setup[2]
    opt = dict(lr=1e-3, warmup_steps=1)
    jtc = jtrainer.TrainConfig(opt=jadamw.AdamWConfig(**opt),
                               cast_params_bf16=True)
    ttc = trainer.TrainConfig(opt=adamw.AdamWConfig(**opt),
                              cast_params_bf16=True)
    jstate = jtrainer.TrainState(params=jp, opt=jadamw.init(jp))
    tstate = bridge.from_reference(jax.tree.map(np.asarray, jstate))
    jstate, jm = jax.jit(jtrainer.make_train_step(jcfg, jtc))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tm = trainer.make_train_step(cfg, ttc)(
        tstate, {"tokens": torch.from_numpy(batch["tokens"])})
    assert all(p.dtype == torch.float32 for p in leaves(tstate.params))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-2)


# ------------------------------------------------------ data and the loop
@pytest.mark.parametrize("seed,batch,seq,n_shards", [
    (0, 2, 2048, 1), (7, 8, 128, 2), (3, 4, 33, 4)])
def test_data_iterator_bit_identical(seed, batch, seq, n_shards):
    cfg, jcfg = get("llama3-8b"), jget("llama3-8b")
    for shard in range(n_shards):
        kw = dict(seed=seed, global_batch=batch, seq_len=seq,
                  n_shards=n_shards, shard_id=shard)
        ti = tpipe.DataIterator(cfg, tpipe.PipelineConfig(**kw))
        ji = jpipe.DataIterator(jcfg, jpipe.PipelineConfig(**kw))
        for _ in range(3):
            a, b = next(ti), next(ji)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert ti.state() == ji.state()
        again = tpipe.DataIterator.restore(cfg, tpipe.PipelineConfig(**kw),
                                           ti.state())
        np.testing.assert_array_equal(next(again)["tokens"],
                                      next(ji)["tokens"])


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(4)
    times = list(rng.normal(1.0, 0.01, size=60))
    times[30] = times[45] = 3.0
    a, b = tft.StragglerDetector(window=20), jft.StragglerDetector(window=20)
    assert [a.record(t) for t in times] == [b.record(t) for t in times]
    assert a.flags == b.flags == 2 and a.chronic(2) and not a.chronic()


def test_run_on_cpu_and_needs_a_card_by_default():
    """``trainer.run`` on the CPU through the flash path: finite, falling
    losses, the straggler detector fed each step; without ``device`` it
    runs on the card, or raises where there is none."""
    cfg = reduced(get("llama3-8b"))
    lines = []
    det = tft.StragglerDetector()
    tc = trainer.TrainConfig(attn_impl="flash", remat="full",
                             opt=adamw.AdamWConfig(lr=3e-3,
                                                   warmup_steps=1))
    it = tpipe.DataIterator(cfg, tpipe.PipelineConfig(seed=0,
                                                      global_batch=2,
                                                      seq_len=64))
    state = trainer.run(cfg, tc, it, 4, straggler=det, log_every=1,
                        log=lines.append, device="cpu")
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(state.opt.step) == 4 and len(det.times) == 4
    assert it.step == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.run(cfg, tc, it, 1)
