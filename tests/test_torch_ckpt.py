"""Port parity for checkpoints, restarts and gradient compression:
``repro_torch.checkpoint.CheckpointManager`` against the JAX package's
on-disk format both ways (the same files, bit for bit, bf16 leaves
included), the JAX package's ``test_system.py`` checkpoint and
fault-tolerance cases on the port, a restart that equals the run it
interrupts, and ``compress_grads`` / ``decompress_grads`` /
``ErrorFeedback`` against the reference's.

The module loads no JAX at import; the reference runs inside the tests
that hold the port against it."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import DataIterator, PipelineConfig, make_batch
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves
from repro_torch.runtime import compression
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.train import trainer

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)
CFG = reduced(get("llama3-8b"), **SMALL)
TC = trainer.TrainConfig(remat="none",
                         opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=1))


def make_iter(b=4, s=32, start=0):
    return DataIterator(CFG, PipelineConfig(seed=1, global_batch=b,
                                            seq_len=s), start_step=start)


def _state(seed=0):
    return trainer.init_state(CFG, torch.Generator().manual_seed(seed))


def _assert_equal(a, b):
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def leaves_of(state):
    return [state.opt.step, *leaves(state.params), *leaves(state.opt.m),
            *leaves(state.opt.v)]


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npy")}


# -------------------------------------------- the reference's format
@pytest.fixture(scope="module")
def ref_state():
    """A reference TrainState after one jitted step at reduced size
    (moments and step non-zero), as numpy leaves."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get as jget
    from repro.configs import reduced as jreduced
    from repro.data import pipeline as jpipe
    from repro.train import trainer as jtrainer
    jcfg = jreduced(jget("llama3-8b"), **SMALL)
    state = jtrainer.init_state(jcfg, jax.random.PRNGKey(0))
    batch = jpipe.make_batch(jcfg, jpipe.PipelineConfig(
        seed=1, global_batch=4, seq_len=32), 0)
    step = jax.jit(jtrainer.make_train_step(
        jcfg, jtrainer.TrainConfig(remat="none")))
    state, _ = step(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, state)


def test_reference_checkpoint_restores_into_the_port(tmp_path, ref_state):
    """A TrainState the reference's manager wrote restores into the port's
    containers bit for bit (``bridge`` of the same state), with its
    ``extra``."""
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    extra = {"data": {"step": 1, "seed": 1}}
    JManager(str(tmp_path)).save(1, ref_state, extra=extra, blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    got, got_extra = mgr.restore(_state(seed=5))
    assert got_extra == extra
    want = bridge.from_reference(ref_state)
    assert isinstance(got, trainer.TrainState)
    assert got.opt.step.shape == () and int(got.opt.step) == 1
    _assert_equal(got, want)


def test_port_checkpoint_is_the_reference_format(tmp_path, ref_state):
    """The port's save of the bridged state writes the reference's files
    byte for byte and its manifest field for field (``treedef`` aside:
    each package describes its own tree), and the reference's
    ``restore`` reads it back bit for bit."""
    import jax
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    extra = {"data": {"step": 1, "seed": 1}}
    JManager(str(tmp_path / "ref")).save(1, ref_state, extra=extra,
                                         blocking=True)
    port = CheckpointManager(str(tmp_path / "port"))
    port.save(1, bridge.from_reference(ref_state), extra=extra,
              blocking=True)
    a, b = (tmp_path / d / "step_00000001" for d in ("ref", "port"))
    assert _files(a) == _files(b)
    ma, mb = (json.load(open(d / "manifest.json")) for d in (a, b))
    assert ma.pop("treedef").startswith("PyTreeDef(")
    assert mb.pop("treedef").startswith("TrainState(params=")
    assert ma == mb
    assert (b / ".COMMITTED").read_text() == "ok"
    restored, got_extra = JManager(str(tmp_path / "port")).restore(
        jax.tree.map(np.zeros_like, ref_state))
    assert got_extra == extra
    for x, y in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_state)):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 leaves (and a 0-d int32): the reference writes raw 2-byte
    words (``<V2``, manifest "bfloat16"), the port reads them bit for bit
    and writes the same bytes.  The reference's own ``restore`` cannot
    cast a loaded bf16 leaf back (ROADMAP queue 3), from its files or the
    port's alike."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 16, size=(3, 5), dtype=np.uint16)
    words[0, :3] = [0x7F80, 0xFF80, 0x7FC1]            # inf, -inf, nan
    ref = {"b": jnp.asarray(words.view(ml_dtypes.bfloat16)),
           "s": jnp.asarray(7, jnp.int32),
           "w": jnp.asarray(rng.normal(size=(4,)).astype(np.float32))}
    JManager(str(tmp_path / "ref")).save(3, ref, blocking=True)
    port = {"b": torch.from_numpy(words.view(np.int16).copy())
            .view(torch.bfloat16),
            "s": torch.tensor(7, dtype=torch.int32),
            "w": torch.from_numpy(np.array(ref["w"]))}
    CheckpointManager(str(tmp_path / "port")).save(3, port, blocking=True)
    a, b = (tmp_path / d / "step_00000003" for d in ("ref", "port"))
    assert _files(a) == _files(b)
    assert json.load(open(a / "manifest.json"))["dtypes"] == \
        json.load(open(b / "manifest.json"))["dtypes"] == \
        ["bfloat16", "int32", "float32"]
    template = {k: torch.zeros_like(v) for k, v in port.items()}
    for d in ("ref", "port"):
        got, _ = CheckpointManager(str(tmp_path / d)).restore(template)
        assert got["b"].dtype == torch.bfloat16
        assert torch.equal(got["b"].view(torch.int16),
                           port["b"].view(torch.int16))
        assert got["s"].shape == () and int(got["s"]) == 7
        assert torch.equal(got["w"], port["w"])
        with pytest.raises(ValueError, match="cast"):
            JManager(str(tmp_path / d)).restore(ref)


# ------------------------------------- test_system.py's cases, ported
def test_checkpoint_roundtrip_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    it = make_iter()
    state = trainer.run(CFG, TC, it, 3, ckpt_mgr=mgr, ckpt_every=1,
                        log_every=0, device="cpu")
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.list_steps() == [2, 3]  # retention
    restored, extra = mgr.restore(_state(seed=9))
    _assert_equal(restored, state)
    assert extra["data"]["step"] == 3  # exact data resume point
    it2 = DataIterator.restore(CFG, PipelineConfig(seed=1, global_batch=4,
                                                   seq_len=32),
                               extra["data"])
    np.testing.assert_array_equal(next(it2)["tokens"],
                                  make_batch(CFG, it2.pc, 3)["tokens"])


def test_checkpoint_atomicity(tmp_path):
    """A torn write (no .COMMITTED) and a ``.tmp`` directory are both
    invisible."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)}, blocking=True)
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "step_00000002" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_00000003.tmp")
    (tmp_path / "step_00000003.tmp" / ".COMMITTED").write_text("ok")
    assert mgr.list_steps() == [1] and mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": 0})


def test_restore_checks_structure_and_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2), "b": torch.ones(3)}, blocking=True)
    with pytest.raises(AssertionError, match="structure"):
        mgr.restore({"a": torch.ones(2)})
    with pytest.raises(AssertionError, match="shape mismatch"):
        mgr.restore({"a": torch.ones(2), "b": torch.ones(4)})
    got, _ = mgr.restore({"a": torch.zeros(2, dtype=torch.float64),
                          "b": torch.zeros(3)})
    assert got["a"].dtype == torch.float64        # the template's dtype


def test_restart_loop_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.ones(2)}, blocking=True)
    calls = []

    def run_fn(resume_step):
        calls.append(resume_step)
        if len(calls) < 3:
            raise RuntimeError("node died")

    loop = ft.RestartLoop(mgr, max_restarts=5, log=lambda *a: None)
    assert loop.supervise(run_fn) == 2
    assert calls == [5, 5, 5]
    with pytest.raises(RuntimeError, match="node died"):
        ft.RestartLoop(mgr, max_restarts=1, log=lambda *a: None).supervise(
            lambda s: (_ for _ in ()).throw(RuntimeError("node died")))


def test_heartbeat_and_straggler_match_reference():
    from repro.runtime import fault_tolerance as jft
    t = [0.0]
    hb = ft.HeartbeatRegistry(timeout_s=10, clock=lambda: t[0])
    jhb = jft.HeartbeatRegistry(timeout_s=10, clock=lambda: t[0])
    for now, node in ((0, "n0"), (0, "n1"), (5, "n0")):
        t[0] = now
        hb.ping(node)
        jhb.ping(node)
    t[0] = 12
    assert hb.dead_nodes() == jhb.dead_nodes() == ["n1"]
    assert not hb.healthy()
    sd = ft.StragglerDetector(window=20, z_thresh=4.0, min_samples=5)
    jsd = jft.StragglerDetector(window=20, z_thresh=4.0, min_samples=5)
    r = np.random.default_rng(0)
    times = [1.0 + float(r.normal()) * 1e-3 for _ in range(15)] + [3.0]
    assert [sd.record(x) for x in times] == [jsd.record(x) for x in times]
    assert sd.flags == jsd.flags == 1 and not sd.chronic()


@pytest.mark.parametrize("chips,mp,gb,pods", [
    (512, 16, 256, 2), (504, 16, 256, 1), (100, 16, 256, 1),
    (16, 16, 7, 1), (48, 4, 30, 3), (8, 1, 3, 2)])
def test_elastic_plan_matches_reference(chips, mp, gb, pods):
    from repro.runtime import fault_tolerance as jft
    assert ft.plan_elastic_mesh(chips, mp, gb, pods) == \
        ft.ElasticPlan(*dataclasses.astuple(
            jft.plan_elastic_mesh(chips, mp, gb, pods)))
    with pytest.raises(AssertionError, match="fewer chips"):
        ft.plan_elastic_mesh(mp - 1, mp + 1, gb)


def test_save_snapshots_before_the_in_place_step(tmp_path):
    """save() returns with its own host copy: the next step, which updates
    params and moments in place, cannot reach the file being written."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    before = [x.clone() for x in leaves_of(state)]
    step = trainer.make_train_step(CFG, TC)
    batch = {k: torch.from_numpy(v) for k, v in next(make_iter()).items()}
    mgr.save(0, state)                     # async: the writer is running
    state, _ = step(state, batch)          # in place
    mgr.wait()
    restored, _ = mgr.restore(_state(seed=3))
    for a, b, now in zip(leaves_of(restored), before, leaves_of(state)):
        assert torch.equal(a, b)
    assert not torch.equal(leaves(restored.params)[0],
                           leaves(state.params)[0])


def test_restart_resume_equals_the_uninterrupted_run(tmp_path):
    """4 steps checkpointed at step 2, a fault after step 3, a resume from
    step 2 under ``RestartLoop``: params, moments and step equal the
    uninterrupted run's bit for bit."""
    whole = trainer.run(CFG, TC, make_iter(), 4, log_every=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep_last=1)
    calls, final = [], {}

    def run_fn(resume_step):
        calls.append(resume_step)
        state, start = None, 0
        if resume_step is not None:
            state, extra = mgr.restore(_state(seed=4))
            start = extra["data"]["step"]
        it = make_iter(start=start)
        n = 3 if resume_step is None else 4 - start
        state = trainer.run(CFG, TC, it, n, state=state, log_every=0,
                            device="cpu", ckpt_mgr=mgr, ckpt_every=2)
        if resume_step is None:
            raise RuntimeError("preempted after step 3")
        final["state"] = state

    assert ft.RestartLoop(mgr, log=lambda *a: None).supervise(run_fn) == 1
    assert calls == [None, 2]
    _assert_equal(final["state"], whole)


def test_elastic_restore_onto_another_device_and_mesh(tmp_path):
    """A checkpoint holds whole tensors, whatever wrote them: restored
    with ``device=`` onto the CPU it equals the state saved."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(1, state, blocking=True)
    restored, _ = mgr.restore(_state(seed=2), device="cpu")
    _assert_equal(restored, state)
    assert all(x.device.type == "cpu" for x in leaves_of(restored))


# ------------------------------------------------- gradient compression
def _grads(rng):
    return {"a": rng.normal(size=(64, 48)).astype(np.float32),
            "b": {"c": rng.normal(size=(5000,)).astype(np.float32) * 1e-3,
                  "d": np.zeros((3, 7), np.float32)}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
        return
    want = np.asarray(want)
    got = got.numpy() if got.dtype != torch.bfloat16 else \
        got.view(torch.int16).numpy()
    if want.dtype.name == "bfloat16":
        want = want.view(np.int16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_compression_matches_reference():
    """bf16 / int8 payloads, their decodes and the round trip equal the
    reference's bit for bit; int8's chunks pad each leaf to 2048 values."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import compression as jc
    g = _grads(np.random.default_rng(0))
    jg, tg = jax.tree.map(jnp.asarray, g), _t(g)
    for scheme in ("bf16", "int8"):
        jpay = jc.compress_grads(jg, scheme)
        tpay = compression.compress_grads(tg, scheme)
        _same(tpay, jpay)
        _same(compression.decompress_grads(tpay, scheme),
              jc.decompress_grads(jpay, scheme))
        _same(compression.roundtrip(tg, scheme), jc.roundtrip(jg, scheme))
    tpay = compression.compress_grads(tg, "int8")
    assert tpay["b"]["c"]["q"].shape == (3, 2048)
    shapes = {"a": (64, 48), "b": {"c": (5000,), "d": (3, 7)}}
    _same(compression.decompress_grads(tpay, "int8", shapes=shapes),
          jc.roundtrip(jg, "int8"))
    with pytest.raises(ValueError):
        compression.compress_grads(tg, "fp8")


def test_error_feedback_matches_reference():
    """Five steps of int8 error feedback: every decode and the residual
    equal the reference's bit for bit; ``encode`` is ``apply``'s payload
    and leaves the same residual."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import compression as jc
    rng = np.random.default_rng(1)
    first = _grads(rng)
    ef = compression.ErrorFeedback(_t(first))
    twin = compression.ErrorFeedback(_t(first))
    jef = jc.ErrorFeedback(jax.tree.map(jnp.asarray, first))
    for i in range(5):
        g = first if i == 0 else _grads(rng)
        dec = ef.apply(_t(g))
        _same(dec, jef.apply(jax.tree.map(jnp.asarray, g)))
        _same(ef.residual, jef.residual)
        enc = twin.encode(_t(g))
        _same(compression.decompress_grads(enc, "int8", shapes={
            "a": (64, 48), "b": {"c": (5000,), "d": (3, 7)}}), dec)
        _same(twin.residual, ef.residual)
