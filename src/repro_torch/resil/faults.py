"""Seeded, deterministic fault injection for the serving stack.

A :class:`FaultPlan` is a pure function of ``(seed, preset)``: every
decision it makes — drop this handoff, stall that role for a tick, hold
back a fraction of the page pool — is derived by hashing the decision's
coordinates (role, tick, rid, attempt) together with the seed. There is
no internal RNG state, so replaying the same workload under the same
plan yields byte-identical decisions regardless of call order, and two
independently constructed plans with the same ``(seed, preset)`` agree.

Injection seams (callers, not this module, own the semantics):

- ``check_step(role, tick)`` — called at the top of a Session advance;
  raises :class:`InjectedFault` to burn the tick (role-stall, straggler).
- ``drop_handoff(rid, attempt)`` / ``handoff_delay(rid)`` — consulted by
  the disagg orchestrator when a prefill->decode handoff is enqueued.
- ``page_holdback(usable, tick, role)`` — number of pages the allocator
  should pretend are unavailable this tick (page-spike).

Decisions are deterministic; the per-class counters in ``stats`` are a
convenience for attribution and are equally deterministic for a fixed
workload.  Standard library only: the same hashes as the JAX package's
plan, so every ``(preset, seed)`` makes the same decisions bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional


class InjectedFault(RuntimeError):
    """A deliberately injected fault (not a bug). Carries its class and
    the (role, tick) coordinates of the decision so catchers can trace
    the injection without re-deriving them."""

    def __init__(self, fault_class: str, msg: str,
                 role: Optional[str] = None, tick: Optional[int] = None):
        super().__init__(msg)
        self.fault_class = fault_class
        self.role = role
        self.tick = tick


# Built-in presets. Window starts get a small seed-derived jitter so
# different seeds exercise different phases of the workload.
PRESETS: Dict[str, Dict] = {
    "none": {},
    # Drop or delay prefill->decode handoffs at the router seam.
    "drop-handoff": {
        "drop_p": 0.35,
        "max_drops": 2,
        "delay_p": 0.35,
        "max_delay": 3,
        "redeliver_after": 3,
    },
    # One role fails every step for a contiguous window of ticks.
    "role-stall": {"role": "decode", "start": 5, "span": 6, "jitter": 4},
    # A fraction of the page pool becomes unavailable for a window.
    "page-spike": {"role": "decode", "start": 4, "span": 8, "frac": 0.6, "jitter": 4},
    # Scattered single-tick stalls on one role (tail latency).
    "straggler": {"role": "prefill", "p": 0.3},
}


def _role_match(target: str, role: str) -> bool:
    # A co-located session (role "engine") embodies every role.
    return role == target or role == "engine" or target == "any"


@dataclasses.dataclass
class FaultPlan:
    preset: str
    seed: int = 0
    params: Dict = dataclasses.field(default_factory=dict)
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def make(cls, preset: str, seed: int = 0, **overrides) -> "FaultPlan":
        if preset not in PRESETS:
            raise ValueError(
                f"unknown fault preset {preset!r}; choose from {sorted(PRESETS)}"
            )
        params = dict(PRESETS[preset])
        params.update(overrides)
        return cls(preset=preset, seed=int(seed), params=params)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``"preset"`` or ``"preset:seed"`` (e.g. ``drop-handoff:3``)."""
        if isinstance(spec, FaultPlan):
            return spec
        name, _, seed_s = str(spec).partition(":")
        seed = 0
        if seed_s:
            try:
                seed = int(seed_s)
            except ValueError:
                raise ValueError(f"bad fault plan seed in {spec!r} (want PRESET:SEED)")
        return cls.make(name, seed)

    def describe(self) -> str:
        return f"{self.preset}:{self.seed}"

    # ---- deterministic decision primitive -------------------------------
    def _unit(self, *keys) -> float:
        """Uniform [0, 1) from a stable hash of (seed, preset, keys)."""
        payload = f"{self.seed}|{self.preset}|" + "|".join(str(k) for k in keys)
        h = hashlib.blake2b(payload.encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0**64

    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def _window(self) -> Optional[range]:
        if "start" not in self.params:
            return None
        start = self.params["start"]
        jitter = self.params.get("jitter", 0)
        if jitter:
            start += int(self._unit("window") * (jitter + 1))
        return range(start, start + self.params["span"])

    # ---- step seam ------------------------------------------------------
    def step_fault(self, role: str, tick: int) -> Optional[str]:
        """Fault class that hits `role` stepping at `tick`, or None."""
        p = self.params
        if self.preset == "role-stall" and _role_match(p["role"], role):
            if tick in self._window():
                return "role-stall"
        if self.preset == "straggler" and _role_match(p["role"], role):
            if self._unit("straggle", role, tick) < p["p"]:
                return "straggler"
        return None

    def check_step(self, role: str, tick: int) -> None:
        """Raise InjectedFault if this role's step faults at this tick."""
        cls = self.step_fault(role, tick)
        if cls is not None:
            self._count(cls)
            raise InjectedFault(cls, f"{cls}: role={role} tick={tick}",
                                role=role, tick=tick)

    # ---- handoff seam ---------------------------------------------------
    def drop_handoff(self, rid: int, attempt: int) -> bool:
        """Whether delivery `attempt` (0-based) of rid's handoff is dropped."""
        p = self.params
        if self.preset != "drop-handoff":
            return False
        if attempt >= p["max_drops"]:  # guarantee eventual delivery
            return False
        if self._unit("drop", rid, attempt) < p["drop_p"]:
            self._count("drop-handoff")
            return True
        return False

    def handoff_delay(self, rid: int) -> int:
        """Extra ticks before rid's handoff becomes visible to decode."""
        p = self.params
        if self.preset != "drop-handoff":
            return 0
        if self._unit("delay", rid) < p["delay_p"]:
            d = 1 + int(self._unit("delay-n", rid) * p["max_delay"])
            self._count("delay-handoff")
            return d
        return 0

    @property
    def redeliver_after(self) -> int:
        return self.params.get("redeliver_after", 3)

    # ---- allocator seam -------------------------------------------------
    def page_holdback(self, usable: int, tick: int, role: str = "engine") -> int:
        """Pages to hold out of `role`'s pool at `tick` (page-spike)."""
        p = self.params
        if self.preset != "page-spike" or not _role_match(p["role"], role):
            return 0
        if tick in self._window():
            n = int(usable * p["frac"])
            if n > 0:
                self._count("page-spike-ticks")
            return n
        return 0
