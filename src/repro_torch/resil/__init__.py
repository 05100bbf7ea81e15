"""repro_torch.resil — deterministic fault injection, request
deadlines/retry, and graceful degradation for the serving stack.

Three layers:

- :mod:`repro_torch.resil.faults` — seeded :class:`FaultPlan` presets
  (drop-handoff, role-stall, page-spike, straggler), replayable from
  ``(seed, preset)``.
- :mod:`repro_torch.resil.policy` — :class:`ResilConfig` (deadlines,
  bounded retry, load shedding, degradation ladder) and the structured
  :class:`RequestFailed` terminal result.
- :mod:`repro_torch.resil.health` — allocator/slot invariant audits and
  the :class:`Watchdog`.

Activate via ``Engine.session(resil=...)`` — a ResilConfig, a dict of
its fields, or a bare ``"preset:seed"`` fault-plan string. ``resil=None``
(the default) leaves serving behavior exactly as before.
"""

from repro_torch.resil.faults import PRESETS, FaultPlan, InjectedFault
from repro_torch.resil.health import (HealthError, Watchdog, audit_allocator,
                                      audit_session)
from repro_torch.resil.policy import (DegradeState, RequestFailed,
                                      ResilConfig, ResilState)

__all__ = [
    "PRESETS", "FaultPlan", "InjectedFault",
    "HealthError", "Watchdog", "audit_allocator", "audit_session",
    "DegradeState", "RequestFailed", "ResilConfig", "ResilState",
]
