"""Scheduler of the port (FIFO) and its chunked-prefill step."""
from repro_torch.sched import scheduler  # noqa: F401
from repro_torch.sched.prefill import (prefill_step,  # noqa: F401
                                       supports_chunked_prefill)
from repro_torch.sched.scheduler import (SchedConfig, SchedEntry,  # noqa
                                         Scheduler, page_need)
