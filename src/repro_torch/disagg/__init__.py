"""Disaggregated prefill / decode serving of the port.

Splits the serving session into a prefill role and a decode role, each
with its own batch slots, page pool and allocator, joined by a page
migration channel and a role-aware router with decode -> prefill
back-pressure.  See session.py for the roles and the orchestrator,
migrate.py for the page channel, router.py for admission routing.  Entry
points: ``Engine.session(disagg=...)`` / ``Engine.serve(disagg=...)`` /
``python -m repro_torch.launch.serve --disagg``.  Both roles run on one
device; roles on disjoint devices wait for the shard layer's port.
"""
from repro_torch.disagg.migrate import Handoff, migrate_kv
from repro_torch.disagg.router import DisaggRouter
from repro_torch.disagg.session import (DecodeSession, DisaggConfig,
                                        DisaggSession, PrefillSession)

__all__ = [
    "DecodeSession", "DisaggConfig", "DisaggRouter", "DisaggSession",
    "Handoff", "PrefillSession", "migrate_kv",
]
