"""The port stands alone: importing it (and the chip smoke script) loads
neither JAX nor the reference package, and its entry point refuses to run
on the CPU unless asked to."""
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

