"""Port parity for data-parallel training and the training launcher:
``make_train_step(mesh=)`` over 2 gloo ranks (``shard.comm.spawn``) against
one device at two microbatches bit for bit, the compressed wire, a
checkpoint written by the ranks restored onto one device,
``python -m repro_torch.launch.train`` against the reference's steps, its
restart and resume, its ranks over a process group, and the examples of
``repro_torch.examples`` on the CPU.

The ranks import this module, which loads neither JAX nor the JAX package
at import (the reference runs inside the test that holds the launcher
against it)."""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import DataIterator, PipelineConfig
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves
from repro_torch.runtime.compression import CHUNK
from repro_torch.shard import comm
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)
CFG = reduced(get("llama3-8b"), **SMALL)
STEPS, GB, SEQ = 3, 4, 32
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
#: int8 on the wire against the uncompressed exchange: per-step losses
#: within about 1 % of the loss (4.0 to 5.6); measured 3.19e-3 and 1.84e-2
#: at steps 2 and 3 (step 1 is equal: the loss is taken before any
#: gradient travels)
INT8_LOSS_TOL = 5e-2
#: the train tolerance of tests/test_torch_train.py (a per-step loss)
LOSS_TOL = 2 * 2e-3
SCHEMES = (None, "bf16", "int8")


def _tc(scheme=None, microbatches=1):
    return trainer.TrainConfig(remat="none", grad_compression=scheme,
                               microbatches=microbatches, opt=OPT)


def _it(start=0):
    return DataIterator(CFG, PipelineConfig(seed=2, global_batch=GB,
                                            seq_len=SEQ), start_step=start)


def _init():
    return trainer.init_state(CFG, torch.Generator().manual_seed(0))


def _steps(tc, n, mesh=None):
    """(state, losses, wire bytes a step) of n steps from the seed-0
    state on the global batches."""
    state, it = _init(), _it()
    step = trainer.make_train_step(CFG, tc, mesh=mesh)
    losses = []
    comm.reset_stats()
    for _ in range(n):
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses, comm.STATS["bytes"] / n


def _np_state(state):
    return [x.numpy().copy() for x in
            [state.opt.step, *leaves(state.params), *leaves(state.opt.m),
             *leaves(state.opt.v)]]


def dp_rank(rank, workdir):
    """One of two data-parallel ranks: three steps under each wire
    scheme, then two steps of ``trainer.run`` checkpointed by rank 0."""
    mesh = make_host_mesh(1, 2, backend="gloo", device="cpu")
    out = {}
    for scheme in SCHEMES:
        state, losses, wire = _steps(_tc(scheme), STEPS, mesh)
        out[scheme] = {"state": _np_state(state), "losses": losses,
                       "bytes": wire,
                       "agree": trainer.params_agree(state.params, mesh)}
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    trainer.run(CFG, _tc(), _it(), 2, mesh=mesh, ckpt_mgr=mgr,
                ckpt_every=2, log_every=0)
    mgr.wait()
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    outs = comm.spawn(2, dp_rank, (str(work),), backend="gloo",
                      workdir=str(work), threads=1, timeout=240)
    return outs, work


@pytest.fixture(scope="module")
def one_device():
    """One device at two microbatches, uncompressed: the ranks' oracle."""
    return _steps(_tc(microbatches=2), STEPS)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_two_ranks_equal_one_device_at_two_microbatches(dp, one_device):
    """Uncompressed, each rank's params, moments, step and losses equal
    one device's at ``microbatches=2`` bit for bit, and the ranks agree."""
    outs, _ = dp
    state, losses, _ = one_device
    for out in outs:
        assert out[None]["losses"] == losses
        assert out[None]["agree"]
        _assert_same(out[None]["state"], _np_state(state))


def test_compressed_wire_at_two_ranks(dp, one_device):
    """bf16 and int8 on the wire: the ranks agree bit for bit, losses are
    finite and fall, step 1 equals the uncompressed loss, and int8 stays
    within ``INT8_LOSS_TOL`` of the uncompressed run."""
    outs, _ = dp
    _, losses, _ = one_device
    for scheme in ("bf16", "int8"):
        got = outs[0][scheme]["losses"]
        assert outs[1][scheme]["losses"] == got
        assert all(o[scheme]["agree"] for o in outs)
        _assert_same(outs[0][scheme]["state"], outs[1][scheme]["state"])
        assert np.isfinite(got).all() and got[-1] < got[0]
        assert got[0] == losses[0]
    gap = np.abs(np.subtract(outs[0]["int8"]["losses"], losses))
    assert gap.max() <= INT8_LOSS_TOL, gap


def test_wire_carries_the_compressed_payload(dp):
    """Bytes a rank sends a step: the f32 loss and grads, their bf16 cast,
    or int8 codes with an f32 scale per 2048-value chunk of each leaf,
    every part on an 8-byte boundary, in one gather."""
    outs, _ = dp
    sizes = [p.numel() for p in leaves(_init().params)]

    def pad(n):
        return n + (-n) % 8
    chunks = [-(-n // CHUNK) for n in sizes]
    want = {None: 8 + sum(pad(4 * n) for n in sizes),
            "bf16": 8 + sum(pad(2 * n) for n in sizes),
            "int8": 8 + sum(c * CHUNK + pad(4 * c) for c in chunks)}
    for scheme in SCHEMES:
        assert outs[0][scheme]["bytes"] == want[scheme], scheme
    assert want["bf16"] < 0.51 * want[None]


def test_one_rank_wire_equals_the_roundtrip():
    """The wire at one rank (``trainer.exchange``: pack, gather, unpack,
    decompress, add from zeros) gives ``roundtrip``'s grads and the loss
    bit for bit under every scheme; a mesh of one (no group) takes the
    single-device step, equal to it over 3 steps."""
    from repro_torch.runtime.compression import roundtrip
    state, it = _init(), _it()
    batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
    lval, _ = trainer.M.loss_fn(CFG, live, batch, remat="none")
    grads = torch.autograd.grad(lval, leaves(live))
    grads = trainer._fill(state.params, iter(grads))
    for scheme in SCHEMES:
        want = leaves(grads) if scheme is None else \
            leaves(roundtrip(grads, scheme))
        loss, got = trainer.exchange(lval.detach(), grads, scheme, 1,
                                     lambda buf, group: [buf])
        assert torch.equal(loss, lval.detach())
        assert len(leaves(got)) == len(want)
        for x, y in zip(leaves(got), want):
            assert x.dtype == torch.float32 and torch.equal(x, y), scheme
    mesh = make_host_mesh(1, 1, device="cpu")
    assert mesh.backend is None and mesh.shape == (1, 1)
    for scheme in SCHEMES:
        a, la, _ = _steps(_tc(scheme), STEPS, mesh)
        b, lb, _ = _steps(_tc(scheme), STEPS)
        assert la == lb
        _assert_same(_np_state(a), _np_state(b))


def test_rank_checkpoint_restores_on_one_device(dp):
    """Rank 0 alone wrote the step-2 checkpoint of the two ranks' run; it
    restores onto one device and equals one device's two steps at two
    microbatches bit for bit."""
    _, work = dp
    mgr = CheckpointManager(str(work / "ckpt"))
    assert mgr.list_steps() == [2]
    restored, extra = mgr.restore(_init(), device="cpu")
    assert extra["data"]["step"] == 2
    state, _, _ = _steps(_tc(microbatches=2), 2)
    _assert_same(_np_state(restored), _np_state(state))


def test_model_axis_is_not_ported():
    mesh = Mesh(shape=(1, 2), rank=0, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        trainer.make_train_step(CFG, _tc(), mesh=mesh)


# ------------------------------------------------------------ launcher
def _launch(monkeypatch, argv):
    from repro_torch.launch import train as tlaunch
    monkeypatch.setattr(tlaunch, "get", lambda a: reduced(get(a), **SMALL))
    return tlaunch.main(["--arch", "llama3-8b", "--device", "cpu",
                         "--global-batch", "2", "--seq", "32", *argv])


def _losses(text):
    return [float(ln.split("loss=")[1].split()[0])
            for ln in text.splitlines() if ln.startswith("step ")]


def test_launcher_matches_reference_steps(tmp_path, monkeypatch, capsys):
    """From the reference's initial state (its own checkpoint at step 0),
    the launcher's three losses are those of the reference launcher's
    jitted step on the same batches, within the train tolerance.  (The
    reference launcher itself stops under JAX 0.9 in its sharded
    embedding gather: ROADMAP queue 3.)"""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    from repro.configs import get as jget
    from repro.configs import reduced as jreduced
    from repro.data.pipeline import DataIterator as JIter
    from repro.data.pipeline import PipelineConfig as JPipe
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.train import trainer as jtrainer
    jcfg = jreduced(jget("llama3-8b"), **SMALL)
    state = jtrainer.init_state(jcfg, jax.random.PRNGKey(0))
    JManager(str(tmp_path)).save(0, state, extra={"data": {
        "step": 0, "seed": 0}}, blocking=True)
    step = jax.jit(jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(
        opt=JOpt(lr=3e-4, total_steps=STEPS))))
    data, want = JIter(jcfg, JPipe(seed=0, global_batch=2, seq_len=32)), []
    for _ in range(STEPS):
        state, m = step(state, jax.tree.map(jnp.asarray, next(data)))
        want.append(float(m["loss"]))
    _launch(monkeypatch, ["--steps", str(STEPS), "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[launch] restored step 0" in out
    got = _losses(out)
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert CheckpointManager(str(tmp_path)).list_steps() == [1, 2, 3]


def test_launcher_restarts_and_resumes(tmp_path, monkeypatch, capsys):
    """A fault after step 3 is caught by ``RestartLoop``, which resumes
    from step 2's checkpoint: step 4's files equal an uninterrupted run's
    byte for byte; a new launch on the directory resumes from step 4."""
    _restart_and_resume(tmp_path, monkeypatch, capsys, [])


def test_launcher_int8_run_resumes_bit_for_bit(tmp_path, monkeypatch,
                                               capsys):
    """The same with int8 on the wire: the compressed step keeps no state
    outside the checkpoint, so the resumed run writes the uninterrupted
    run's bytes."""
    _restart_and_resume(tmp_path, monkeypatch, capsys,
                        ["--grad-compression", "int8"])


def _restart_and_resume(tmp_path, monkeypatch, capsys, extra):
    args = ["--steps", "4", "--ckpt-every", "2", "--remat", "none", *extra]
    _launch(monkeypatch, [*args, "--ckpt-dir", str(tmp_path / "a")])
    make, calls = trainer.make_train_step, []

    def faulty(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("preempted")
            return out
        return run
    monkeypatch.setattr(trainer, "make_train_step", faulty)
    capsys.readouterr()
    _launch(monkeypatch, [*args, "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[ft] failure: RuntimeError('preempted'); restart 1/3 from " \
        "step 2" in out and "[launch] restored step 2" in out
    assert len(calls) == 5
    a, b = (tmp_path / d / "step_00000004" for d in ("a", "b"))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    _launch(monkeypatch, [*args, "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[launch] restored step 4" in out and len(calls) == 5


def test_launcher_refuses_the_cpu_without_asking_and_production(
        monkeypatch, capsys):
    """No card and no --device cpu: exit 2 with resolve_device's message;
    --multi-pod and a production-sized group raise, naming the item that
    ports the production mesh."""
    from repro_torch.launch import train as tlaunch
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tlaunch.main(["--arch", "llama3-8b", "--multi-pod"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            tlaunch.main(["--arch", "llama3-8b"])
        assert e.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(tlaunch, "maybe_init_distributed",
                        lambda d: (256, 0, "gloo", torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tlaunch.main(["--arch", "llama3-8b", "--device", "cpu"])


def test_launcher_ranks_over_a_process_group(tmp_path, monkeypatch):
    """Two launcher processes joined by COORDINATOR_ADDR / NUM_PROCESSES /
    PROCESS_ID (gloo on the CPU) write the step-3 checkpoint one process
    at two microbatches writes, byte for byte."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--steps", "3", "--global-batch", "4", "--seq", "32",
            "--remat", "none", "--ckpt-every", "3", "--device", "cpu"]
    code = ("import sys\n"
            "from repro_torch.configs import get, reduced\n"
            "import repro_torch.launch.train as t\n"
            f"t.get = lambda a: reduced(get(a), **{SMALL!r})\n"
            "sys.exit(t.main(sys.argv[1:]))\n")
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   COORDINATOR_ADDR=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, "--arch", "llama3-8b", *args,
             "--ckpt-dir", str(tmp_path / "dp")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "local mesh 2x1 (data x model) over gloo" in outs[0]
    _launch(monkeypatch, [*args, "--microbatches", "2",
                          "--ckpt-dir", str(tmp_path / "one")])
    a, b = (tmp_path / d / "step_00000003" for d in ("dp", "one"))
    for n in sorted(os.listdir(a)):
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


# ------------------------------------------------------------ examples
def _tiny_llm(arch):
    return dataclasses.replace(reduced(get(arch)), name=arch + "-tiny")


@pytest.mark.parametrize("name,argv,expect", [
    ("quickstart", ["--steps", "4"], ["checkpoints: steps [2, 4]",
                                      "request 2: "]),
    ("train_llm", ["--steps", "3"], ["done; checkpoints at []",
                                     "[api] decode smoke via Engine"]),
    ("serve_aida", ["--train-steps", "3"], ["served 8 requests"]),
    ("aida_emulator_demo", [], ["emulator == oracle: True",
                                "EXACT match", "(paper: 14.5x)"])])
def test_example_runs_on_the_cpu(name, argv, expect, tmp_path, monkeypatch,
                                 capsys):
    """Each example of ``repro_torch.examples`` on ``--device cpu`` at a
    small step count (train_llm at its family's reduced size)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_llm":
        monkeypatch.setattr(mod, "build_cfg", _tiny_llm)
    if name in ("quickstart", "train_llm"):
        argv = [*argv, "--ckpt-dir", str(tmp_path)]
    mod.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, (text, out[-2000:])
    assert "MISMATCH" not in out and "oracle: False" not in out
