"""Executor protocol + backend registry — the facade's pluggable spine.

A backend is a named `Executor` advertising `Capabilities`; the registry
maps names to instances.  The backends live in
`repro_torch.api.backends` and are imported lazily on first lookup, so
importing this module costs nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


class CapabilityError(NotImplementedError):
    """Raised when a backend is asked for a surface it does not implement."""


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can do; the Engine routes on these flags."""
    batched_decode: bool = False       # make_decode_step() works
    cycle_accounting: bool = False     # estimate() returns cycle counts
    per_layer_override: bool = False   # honours CompressionSpec.overrides
    modes: Tuple[str, ...] = ()        # FC modes the backend executes


class Executor:
    """Common protocol for every execution backend.

    Subclasses override the surfaces their capability flags advertise;
    the base implementations raise CapabilityError with a pointer to a
    backend that does support the surface.
    """
    name: str = "abstract"
    caps: Capabilities = Capabilities()

    # ---- batched decode (serving) -------------------------------------
    def make_decode_step(self, cfg, plan=None):
        """-> step(params, state, tokens) -> (state', logits [B, Vpad]);
        ``plan``: a `shard.ShardingPlan` to serve over a mesh."""
        raise CapabilityError(
            f"backend {self.name!r} has no batched decode; use one of "
            f"{_REGISTRY.supporting('batched_decode')}")

    # ---- single FC layer ----------------------------------------------
    def run_fc(self, layer, x):
        """Apply one (possibly compressed) FC layer: y = x @ W.T."""
        raise CapabilityError(
            f"backend {self.name!r} cannot run FC layers directly")

    # ---- cycle accounting ---------------------------------------------
    def estimate(self, workload, device=None, **kw) -> dict:
        """Cycle/perf estimate for a workload (FCProblem or named);
        ``device``: where a backend that runs the layer runs it."""
        raise CapabilityError(
            f"backend {self.name!r} has no cycle accounting; use one of "
            f"{_REGISTRY.supporting('cycle_accounting')}")

    def __repr__(self):
        return f"<Executor {self.name!r} caps={self.caps}>"


class BackendRegistry:
    """Name -> Executor mapping with capability queries."""

    def __init__(self):
        self._backends: Dict[str, Executor] = {}

    def register(self, backend: Executor) -> Executor:
        self._backends[backend.name] = backend
        return backend

    def get(self, name: str) -> Executor:
        if name not in self._backends:
            from repro_torch.api import backends  # noqa: F401 (registers)
        if name not in self._backends:
            raise KeyError(f"unknown backend {name!r}; "
                           f"registered: {self.names()}")
        return self._backends[name]

    def names(self) -> List[str]:
        if not self._backends:
            from repro_torch.api import backends  # noqa: F401
        return sorted(self._backends)

    def supporting(self, capability: str) -> List[str]:
        return [n for n in self.names()
                if getattr(self._backends[n].caps, capability)]


#: Process-wide default registry (backends self-register on import).
_REGISTRY = BackendRegistry()


def register_backend(backend: Executor) -> Executor:
    return _REGISTRY.register(backend)


def get_backend(name: str) -> Executor:
    return _REGISTRY.get(name)


def backend_names() -> List[str]:
    return _REGISTRY.names()
