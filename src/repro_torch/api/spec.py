"""Facade value types: the compression recipe, requests and results."""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

#: The five FC operating points (``aida`` = the paper's full configuration).
MODES: Tuple[str, ...] = ("dense", "int8", "codebook4", "acsr", "aida")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Offline Deep-Compression recipe (prune -> k-means share -> pack).

    ``overrides`` maps projection-name substrings to modes, e.g.
    ``{"wo": "dense"}``; ``"skip"`` leaves the projection a raw matrix."""
    mode: str = "aida"
    density: float = 0.10
    k: int = 16
    block_rows: int = 128
    kmeans_iters: int = 25
    #: value storage dtype for acsr-mode nonzeros: "f32" or "bf16"
    dtype: str = "f32"
    overrides: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; choose from {MODES}")
        if self.dtype not in ("f32", "bf16"):
            raise ValueError(
                f"unknown value dtype {self.dtype!r}; 'f32' or 'bf16'")
        for name, mode in self.overrides.items():
            if mode not in MODES + ("skip",):
                raise ValueError(
                    f"override {name!r}: unknown mode {mode!r}")

    def mode_for(self, projection: str) -> str:
        """Mode for one projection leaf (first matching override wins)."""
        for sub, mode in self.overrides.items():
            if sub in projection:
                return mode
        return self.mode

    @classmethod
    def coerce(cls, spec) -> "CompressionSpec":
        """Accept a CompressionSpec, a bare mode string, or None (default)."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(mode=spec)
        raise TypeError(f"cannot coerce {type(spec).__name__} "
                        "to CompressionSpec")


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    temperature: float = 0.0
    rid: int = 0
    # completion budget in ticks from submit (overrides
    # ResilConfig.deadline_ticks; None = the session's default)
    deadline_ticks: Optional[int] = None


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]
