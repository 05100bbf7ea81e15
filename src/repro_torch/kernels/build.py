"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (the paged-attention
source once for each of its ranges, ``VARIANTS``).  Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing is built at
import: the first CUDA launch of a kernel (or an explicit
:func:`build_all`) builds every missing library, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
#: the paged-attention kernel's keys a range (its template argument): one
#: library each, so their builds run side by side; "paged_attention" is
#: the untuned 256, the others are its VARIANTS
PAGED_RANGES = (128, 256, 512)
#: libraries built from another source with macros of their own: name ->
#: (source, extra nvcc flags)
VARIANTS = {f"paged_attention_r{r}": ("paged_attention", (f"-DPA_RANGE={r}",))
            for r in PAGED_RANGES if r != 256}
SOURCES = ("acsr_spmv", "paged_attention", *VARIANTS, "int8_matmul",
           "lut_matmul", "flash_attention", "linear_scan", "lut_product")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNTERS: Dict[Tuple[object, int], object] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def paged_library(range_keys: int) -> str:
    """The library of the paged-attention kernel at ``range_keys`` keys a
    range."""
    name = f"paged_attention_r{range_keys}"
    return name if name in VARIANTS else "paged_attention"


def _source(name: str) -> Tuple[pathlib.Path, Tuple[str, ...]]:
    """The .cu a library is built from, and its extra flags."""
    src, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", extra


def _lib_path(name: str) -> pathlib.Path:
    # the shared headers are part of every source's key
    cu, extra = _source(name)
    src = b"".join(p.read_bytes() for p in
                   [cu, *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra).encode()) \
        .hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build_all() -> float:
    """Build every kernel library that is missing; returns the seconds
    spent.  Raises with the compiler's output if any build fails."""
    todo = [(n, _lib_path(n)) for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, path in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cu, extra = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, str(cu)]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, path)      # atomic: a reader never sees half
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu``, or a VARIANTS
    entry), built on first use."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def sm_count(device) -> int:
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def counters(device, stream: int, n: int):
    """At least ``n`` int32 entries of scratch kept zero between launches
    on ``stream``: merge counters (a kernel whose last block of a tile
    merges the tile's partials finds out it is last from its counter and
    resets it), and K6's int64 sums, which its last blocks zero again.
    Made once per stream, so launches on two streams never share one."""
    import torch
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf
