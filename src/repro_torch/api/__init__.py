"""`repro_torch.api` — the port's engine facade.

Compress, serve and price a model at any of the paper's operating points
(dense / int8 / codebook4 / acsr / aida), on any registered backend
(`torch-dense`, `cuda`, `ap-emulator`, `cycle-sim`)::

    from repro_torch.api import Engine, Request, CompressionSpec

    eng = Engine(cfg).compress(CompressionSpec(mode="aida", density=0.25))
    results = eng.serve([Request(prompt=[1, 2, 3], max_new=8)])
    table1 = eng.estimate(backend="cycle-sim", workload="table1")

The light value types (CompressionSpec, FCProblem, Request, Result, the
registry) import eagerly; Engine / Session (which pull in the model zoo)
load lazily (PEP 562), so that `models.layers` and `core.sparse_fc` can
import `repro_torch.api.dispatch` at module scope without a cycle.
"""
from repro_torch.api.registry import (BackendRegistry,  # noqa: F401
                                      Capabilities, CapabilityError,
                                      Executor, backend_names, get_backend,
                                      register_backend)
from repro_torch.api.spec import (MODES, WORKLOADS,  # noqa: F401
                                  CompressionSpec, FCProblem, Request,
                                  Result)

__all__ = [
    "Engine", "Session", "Request", "Result", "compress_params",
    "CompressionSpec", "FCProblem", "MODES", "WORKLOADS",
    "BackendRegistry", "Capabilities", "CapabilityError", "Executor",
    "backend_names", "get_backend", "register_backend",
]

_LAZY = {
    "Engine": ("repro_torch.api.engine", "Engine"),
    "Session": ("repro_torch.api.session", "Session"),
    "compress_params": ("repro_torch.api.compress", "compress_params"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
