"""The port stands alone: importing it (and the chip smoke script) loads
neither JAX nor the reference package (the disaggregated and resilience
layers, the backend registry, the emulator and cycle models and the shard
layer included), nor does a spawned mesh rank, and its entry point
refuses to run on the CPU unless asked to."""
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
