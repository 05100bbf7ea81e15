"""Request-lifecycle robustness policy: deadlines, retry, shed, degrade.

:class:`ResilConfig` is the user-facing knob bundle accepted by
``Engine.session(resil=...)`` (as a config, a dict, or a bare
``"preset:seed"`` fault-plan string). ``resil=None`` means the layer is
entirely absent: the serving path without any of its seams.

:class:`ResilState` is the per-session runtime: the (optional) fault
plan, the degradation ladder, the watchdog, and the counters that
``sched.metrics.summarize`` reports under ``"resil"``.

A request that cannot be served within policy becomes a structured
:class:`RequestFailed` result (never an unhandled exception):

- ``deadline``          — missed its ``deadline_ticks`` budget
- ``shed``              — rejected by load shedding while queued
- ``retries_exhausted`` — re-admitted more than ``max_retries`` times
- ``oversized``         — can never fit the page pool it was routed to
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from . import faults


@dataclasses.dataclass
class RequestFailed:
    """Structured terminal result for a request the engine gave up on."""

    rid: int
    reason: str
    tokens: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0

    def __repr__(self):  # compact, log-friendly
        return (
            f"RequestFailed(rid={self.rid}, reason={self.reason!r}, "
            f"n_tokens={len(self.tokens)}, retries={self.retries})"
        )


@dataclasses.dataclass
class ResilConfig:
    """Knobs for the resilience layer. All optional; None disables."""

    # Default per-request completion budget, in ticks from submit.
    deadline_ticks: Optional[int] = None
    # Re-admissions (recompute) allowed before RequestFailed.
    max_retries: int = 2
    # Shed queued work when sum(worst-case page need) exceeds this
    # fraction of the usable pool. None disables shedding.
    shed_watermark: Optional[float] = None
    # Demote new admissions' KV to int8 under sustained page pressure.
    degrade_kv: bool = False
    degrade_low_frac: float = 0.25
    degrade_sustain_ticks: int = 8
    # Disagg: ticks a handoff may wait before falling back to
    # co-located prefill on the decode role. None disables.
    handoff_timeout: Optional[int] = None
    # Disagg: ticks before a dropped handoff is redelivered.  The cadence
    # is the fault plan's own parameter (``fault_plan={"preset":
    # "drop-handoff", "redeliver_after": N}``); this field keeps the
    # reference's signature, which reads it nowhere, and refuses any
    # value but its default rather than ignore it.
    redeliver_after: int = 3
    # Watchdog audit cadence in ticks (0 disables).
    watchdog_every: int = 0
    # Consecutive faulted steps before a role is drained as wedged.
    wedge_ticks: int = 10
    # FaultPlan, "preset:seed" string, or None.
    fault_plan: Optional[Union[faults.FaultPlan, str]] = None

    def __post_init__(self):
        if isinstance(self.fault_plan, str):
            self.fault_plan = faults.FaultPlan.parse(self.fault_plan)
        elif isinstance(self.fault_plan, dict):
            # {"preset": ..., "seed": ..., <param overrides>} — a nested
            # "params" dict is accepted too and flattened into overrides
            spec = dict(self.fault_plan)
            spec.update(spec.pop("params", {}))
            self.fault_plan = faults.FaultPlan.make(**spec)
        if self.deadline_ticks is not None and self.deadline_ticks < 1:
            raise ValueError("deadline_ticks must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.shed_watermark is not None and not 0.0 < self.shed_watermark:
            raise ValueError("shed_watermark must be > 0")
        if self.handoff_timeout is not None and self.handoff_timeout < 1:
            raise ValueError("handoff_timeout must be >= 1")
        if self.wedge_ticks < 1:
            raise ValueError("wedge_ticks must be >= 1")
        if self.redeliver_after != 3:
            raise ValueError(
                "redeliver_after is the fault plan's parameter: pass "
                "fault_plan={'preset': 'drop-handoff', "
                "'redeliver_after': N}")

    @classmethod
    def coerce(cls, val) -> "ResilConfig":
        if isinstance(val, cls):
            return val
        if isinstance(val, faults.FaultPlan):
            return cls(fault_plan=val)
        if isinstance(val, str):
            return cls(fault_plan=faults.FaultPlan.parse(val))
        if isinstance(val, dict):
            return cls(**val)
        if val is True:
            return cls()
        raise TypeError(f"cannot coerce {type(val).__name__} to ResilConfig")


class DegradeState:
    """Hysteresis ladder for graceful degradation under page pressure.

    Level 0: normal. Level 1: release prefix-cache pins. Level 2: also
    demote *new admissions'* KV to int8 (pool dtype is fixed for a live
    session, so demotion is enforced at the next session boundary via
    ``Engine.session`` consulting :meth:`ResilState.next_kv_dtype`).
    """

    def __init__(self, low_frac: float, sustain: int):
        self.low_frac = low_frac
        self.high_frac = min(1.0, 2.0 * low_frac)
        self.sustain = max(1, sustain)
        self.low_ticks = 0
        self.level = 0
        # observability seam: a ``(name, **args)`` emitter (obs.Tracer
        # .hook); fires only on level TRANSITIONS, never per tick.
        self.obs = None

    def update(self, free_frac: float) -> int:
        if free_frac < self.low_frac:
            self.low_ticks += 1
        elif free_frac > self.high_frac:
            self.low_ticks = 0
        prev = self.level
        if self.low_ticks >= self.sustain:
            self.level = 2
        elif self.low_ticks >= (self.sustain + 1) // 2:
            self.level = 1
        else:
            self.level = 0
        if self.obs is not None and self.level != prev:
            self.obs("resil.degrade", level=self.level, prev=prev,
                     free_frac=round(free_frac, 4))
        return self.level

    @property
    def kv_demote(self) -> bool:
        return self.level >= 2


class ResilState:
    """Per-session runtime state for the resilience layer."""

    COUNTERS = (
        "deadline_miss",
        "shed",
        "retries",
        "failed",
        "degraded_admissions",
        "handoff_fallbacks",
        "fault_steps",
        "wait_ticks",
        "watchdog_audits",
        "watchdog_recoveries",
    )

    def __init__(self, cfg: ResilConfig):
        self.cfg = cfg
        self.plan: Optional[faults.FaultPlan] = cfg.fault_plan
        self.stats: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self.degrade = (
            DegradeState(cfg.degrade_low_frac, cfg.degrade_sustain_ticks)
            if cfg.degrade_kv
            else None
        )
        from . import health  # local import: health has no deps on policy

        self.watchdog = (
            health.Watchdog(cfg.watchdog_every) if cfg.watchdog_every > 0 else None
        )

    def count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def deadline_for(self, req, tick: int) -> Optional[int]:
        """Absolute deadline tick for `req` submitted at `tick`."""
        dl = getattr(req, "deadline_ticks", None)
        if dl is None:
            dl = self.cfg.deadline_ticks
        return None if dl is None else tick + dl

    def next_kv_dtype(self, default: str) -> str:
        """KV dtype for the *next* session, honoring the degrade ladder."""
        if self.degrade is not None and self.degrade.kv_demote:
            return "int8"
        return default

    def summary(self) -> Dict[str, int]:
        out = dict(self.stats)
        if self.plan is not None:
            out["fault_plan"] = self.plan.describe()
            out["faults"] = dict(self.plan.stats)
        if self.degrade is not None:
            out["degrade_level"] = self.degrade.level
        return out
