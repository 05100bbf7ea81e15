"""`repro_torch.sched` — the continuous-batching serving scheduler.

The layer between requests and the model step: a policy object decides
which requests occupy batch slots (`scheduler` — FIFO or
shortest-prompt-first with aging, page-pool admission control and
youngest-first preemption instead of `OutOfPages` crashes), the
chunked-prefill step gets prompts into KV pages C tokens per model call
(`prefill`), a content-addressed page cache prefills shared prompt
prefixes once (`prefix`, over `PageAllocator` refcounts), and `workload`
+ `metrics` make heterogeneous serving reproducible and measurable
(TTFT / TPOT / p50-p99 / goodput).

`repro_torch.api.Session` drives all of it; this package holds the
policy, the Session holds the device state.
"""
from repro_torch.sched import prefix, scheduler  # noqa: F401
from repro_torch.sched.metrics import percentile, summarize
from repro_torch.sched.prefill import prefill_step, supports_chunked_prefill
from repro_torch.sched.prefix import PrefixCache, page_hashes
from repro_torch.sched.scheduler import (SchedConfig, SchedEntry, Scheduler,
                                         page_need)
from repro_torch.sched.workload import WorkloadSpec, generate, timed_requests

__all__ = [
    "PrefixCache", "SchedConfig", "SchedEntry", "Scheduler",
    "WorkloadSpec", "generate", "page_hashes", "page_need", "percentile",
    "prefill_step", "summarize", "supports_chunked_prefill",
    "timed_requests",
]
