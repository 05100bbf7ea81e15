"""PyTorch / CUDA port of the AIDA serving system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports none of
it and keeps its module layout and public names.  Its hot loops are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` on first use
and loaded with ``ctypes``; every kernel has a plain PyTorch version that
CPU tensors take.
"""
from repro_torch.api import (MODES, WORKLOADS, BackendRegistry,  # noqa
                             Capabilities, CapabilityError, CompressionSpec,
                             Engine, Executor, FCProblem, Request, Result,
                             Session, backend_names, get_backend,
                             register_backend)
from repro_torch.configs import get, reduced  # noqa: F401
