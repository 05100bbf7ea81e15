"""Scheduler of the port (FIFO, chunk 1)."""
from repro_torch.sched import scheduler  # noqa: F401
from repro_torch.sched.scheduler import (SchedConfig, SchedEntry,  # noqa
                                         Scheduler, page_need)
