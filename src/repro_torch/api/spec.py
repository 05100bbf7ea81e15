"""Facade value types: the compression recipe, FC workload descriptions,
requests and results (numpy and the standard library only, so the api
package imports it eagerly without the model zoo)."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import acsr

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
    #: shard-aware stacking: pad each packed container's partition axis
    #: (ACSR row blocks / output channels) to a multiple of this count,
    #: so a `shard.ShardingPlan` with tp == shards bands it with no
    #: session-time padding.  1 = no padding; plans also pad lazily, so
    #: this is an encode-time optimization, not a requirement.
    shards: int = 1
    overrides: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; choose from {MODES}")
        if self.dtype not in ("f32", "bf16"):
            raise ValueError(
                f"unknown value dtype {self.dtype!r}; 'f32' or 'bf16'")
        if not isinstance(self.shards, int) or self.shards < 1:
            raise ValueError(
                f"shards must be a positive int, got {self.shards!r}")
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
class FCProblem:
    """One concrete FC-layer instance (the paper's C = f(W x B) primitive).

    ``coded=False``: ``w``/``b`` are signed integers with |w| < 2^m,
    |b| < 2^n (bit-serial Fig. 3 mode).  ``coded=True``: ``w``/``b`` are
    codebook indices (0 = structural zero) and ``cents_w``/``cents_a`` are
    the integer codebooks (bit-parallel perfect-induction mode).  Host
    values, numpy int64.
    """
    w: np.ndarray
    b: np.ndarray
    m: int = 4
    n: int = 4
    activation: Optional[str] = "relu"
    coded: bool = False
    cents_w: Optional[np.ndarray] = None
    cents_a: Optional[np.ndarray] = None

    def __post_init__(self):
        self.w = np.asarray(self.w, np.int64)
        self.b = np.asarray(self.b, np.int64)
        if self.coded and (self.cents_w is None or self.cents_a is None):
            raise ValueError("coded FCProblem needs cents_w and cents_a")

    # Derived quantities shared by the emulator and the closed-form model,
    # so both backends agree on them by construction.
    @property
    def nnz_b(self) -> int:
        return int((self.b != 0).sum())

    @property
    def max_row_nnz(self) -> int:
        return acsr.max_row_nnz(self.w)

    @property
    def prod_bits(self) -> int:
        """Coded-mode product wordlength from the codebook outer product."""
        if not self.coded:
            return self.m + self.n
        pmax = int(np.abs(np.outer(np.asarray(self.cents_w, np.int64),
                                   np.asarray(self.cents_a, np.int64))).max())
        return max(1, math.ceil(math.log2(pmax + 1)))


#: Named cycle-model workloads understood by Engine.estimate.
WORKLOADS: Tuple[str, ...] = ("alexnet-fc", "ctc-lstm", "table1")


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
