"""The port stands alone: importing it (and the chip smoke script) loads
neither JAX nor the reference package (the disaggregated and resilience
layers, the backend registry, the emulator and cycle models, the shard
layer, checkpoints, the training launcher and the examples included), nor
does a spawned mesh rank or data-parallel training rank, and its entry
points refuse to run on the CPU unless asked to."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bridge, chip_smoke\n"
        "from repro_torch.api import engine, session, compress\n"
        "from repro_torch.models import model\n"
        "from repro_torch.train import trainer\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.data import pipeline\n"
        "from repro_torch.runtime import compression, fault_tolerance\n"
        "from repro_torch.kernels import ops, flash_attention\n"
        "from repro_torch.kernels import linear_scan, lut_matmul\n"
        "from repro_torch.models import ssm\n"
        "from repro_torch.configs import rwkv6_7b\n"
        "import repro_torch.launch.serve, repro_torch.obs, repro_torch.sched\n"
        "from repro_torch.sched import workload, metrics, prefix\n"
        "from repro_torch.obs import analyze, trace, recorder, timing\n"
        "import repro_torch.disagg, repro_torch.resil\n"
        "from repro_torch.disagg import session as dsession, migrate, router\n"
        "from repro_torch.resil import faults, policy, health\n"
        "from repro_torch.api import registry, backends, dispatch\n"
        "from repro_torch.core import acsr, associative, aida_fc\n"
        "from repro_torch.core import aida_sim, eie_sim, device\n"
        "import repro_torch.shard, repro_torch.launch.mesh\n"
        "from repro_torch.shard import plan, partition, apply, comm\n"
        "import repro_torch.checkpoint, repro_torch.launch.train\n"
        "from repro_torch.checkpoint import ckpt\n"
        "from repro_torch.examples import quickstart, train_llm\n"
        "from repro_torch.examples import serve_aida, aida_emulator_demo\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, line)


def test_engine_without_device_needs_a_card():
    from repro_torch import Engine, get
    if torch.cuda.is_available():
        assert Engine(get("llama3-8b")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(get("llama3-8b"))
    assert Engine(get("llama3-8b"), device="cpu").device.type == "cpu"


EXAMPLES = ("quickstart", "train_llm", "serve_aida", "aida_emulator_demo")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_needs_a_card(name, monkeypatch):
    """The examples run on the card unless ``--device cpu``: without a
    card they stop before any work with resolve_device's error."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_train_launcher_without_device_needs_a_card(capsys):
    from repro_torch.launch import train as tlaunch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "llama3-8b"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err



def test_launcher_help_loads_no_jax_and_no_reference():
    """``python -m repro_torch.launch.serve --help`` runs with the
    reference package and JAX made unimportable: it needs neither."""
    code = (
        "import runpy, sys\n"
        "sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro')))\n"
        "sys.argv = ['serve', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.serve',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--prefix-cache" in proc.stdout and "--device" in proc.stdout
    for flag in ("--disagg", "--prefill-slots", "--decode-slots",
                 "--fault-plan", "--deadline-ticks", "--max-retries",
                 "--mesh", "--mesh-backend"):
        assert flag in proc.stdout, flag


@pytest.mark.parametrize("module,flags", [
    ("repro_torch.launch.train", ("--arch", "--steps", "--global-batch",
                                  "--seq", "--lr", "--microbatches", "--remat",
                                  "--grad-compression", "--multi-pod",
                                  "--local-mesh", "--ckpt-dir", "--ckpt-every",
                                  "--device")),
    *((f"repro_torch.examples.{name}", ("--device",)) for name in EXAMPLES)])
def test_train_launcher_and_examples_help_load_no_jax(module, flags):
    """``python -m <module> --help`` for the training launcher and every
    example runs with JAX and the reference package made unimportable."""
    code = (
        "import runpy, sys\n"
        "sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro')))\n"
        f"sys.argv = [{module!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in flags:
        assert flag in proc.stdout, flag


def rank_modules(rank):
    """A mesh rank's serve (2 ranks, gloo, a reduced llama3-8b in aida),
    then the JAX and reference modules the rank has loaded."""
    import sys
    from repro_torch import CompressionSpec, Engine, Request, get
    from repro_torch.configs import reduced
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, backend="gloo", device="cpu")
    eng = Engine(reduced(get("llama3-8b")), device="cpu").compress(
        CompressionSpec(mode="aida", density=0.25), verbose=None)
    sess = eng.session(batch_slots=2, max_len=32, mesh=mesh)
    sess.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
    assert len(sess.run()[0].tokens) == 2
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_spawned_mesh_rank_loads_no_jax_and_no_reference(tmp_path):
    """Ranks started by ``shard.comm.spawn`` from a process without JAX
    serve without loading it (or the reference) either."""
    code = (
        "import sys\n"
        "from repro_torch.shard import comm\n"
        "import test_torch_isolation as t\n"
        f"outs = comm.spawn(2, t.rank_modules, workdir={str(tmp_path)!r}, "
        "threads=1, timeout=240)\n"
        "assert outs == [[], []], outs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def dp_rank_modules(rank):
    """A data-parallel training rank's step (2 ranks, gloo, a reduced
    llama3-8b, int8 on the wire), then the JAX and reference modules the
    rank has loaded."""
    import sys
    from repro_torch import get
    from repro_torch.configs import reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer
    mesh = make_host_mesh(1, 2, backend="gloo", device="cpu")
    cfg = reduced(get("llama3-8b"))
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0))
    step = trainer.make_train_step(cfg, trainer.TrainConfig(
        remat="none", grad_compression="int8"), mesh=mesh)
    tokens = torch.arange(64, dtype=torch.int32).reshape(2, 32) % cfg.vocab
    state, m = step(state, {"tokens": tokens})
    assert bool(torch.isfinite(m["loss"]))
    assert trainer.params_agree(state.params, mesh)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_spawned_training_rank_loads_no_jax_and_no_reference(tmp_path):
    """Data-parallel training ranks started by ``shard.comm.spawn`` from a
    process without JAX train without loading it (or the reference)."""
    code = (
        "import sys\n"
        "from repro_torch.shard import comm\n"
        "import test_torch_isolation as t\n"
        f"outs = comm.spawn(2, t.dp_rank_modules, workdir={str(tmp_path)!r}, "
        "threads=1, timeout=240)\n"
        "assert outs == [[], []], outs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
