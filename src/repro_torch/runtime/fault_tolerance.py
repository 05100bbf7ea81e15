"""Fault tolerance & elasticity for long training jobs (the port's copy of
the JAX package's ``runtime/fault_tolerance.py``: stdlib only, the same
decisions and messages).

Components (all host-side control plane; the data plane is
``checkpoint.ckpt``):

  HeartbeatRegistry   - workers ping; a monitor marks nodes dead after a
                        timeout and triggers job-level restart decisions.
  StragglerDetector   - robust z-score over step times; persistent outliers
                        are flagged for eviction/replacement.
  ElasticPlan         - given the surviving chip count, picks the largest
                        admissible mesh (data axis shrinks first, model axis
                        kept) and the adjusted global batch; restoring onto
                        the new mesh is ``CheckpointManager.restore``
                        (checkpoints hold whole tensors, so they fit any
                        mesh).
  RestartLoop         - supervise(train_fn): run -> on failure restore the
                        latest checkpoint -> resume, with bounded retries.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_seen: Dict[str, float] = {}

    def ping(self, node_id: str) -> None:
        self.last_seen[node_id] = self.clock()

    def dead_nodes(self) -> List[str]:
        now = self.clock()
        return [n for n, t in self.last_seen.items()
                if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_nodes()


class StragglerDetector:
    """Median/MAD z-score over a sliding window of step times."""

    def __init__(self, window: int = 50, z_thresh: float = 4.0,
                 min_samples: int = 10):
        self.window = window
        self.z = z_thresh
        self.min_samples = min_samples
        self.times: List[float] = []
        self.flags = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.min_samples:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
        sigma = 1.4826 * max(mad, 1e-9)
        if (dt - med) / sigma > self.z:
            self.flags += 1
            return True
        return False

    def chronic(self, k: int = 3) -> bool:
        return self.flags >= k


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int
    note: str


def plan_elastic_mesh(surviving_chips: int, model_parallel: int,
                      global_batch: int,
                      pods: int = 1) -> ElasticPlan:
    """Shrink the data axis to the largest power of two that fits, keep the
    model axis (so tensor-parallel bands of every weight remain valid), and
    round the global batch down to a multiple of the new dp size."""
    assert surviving_chips >= model_parallel, \
        "fewer chips than one model-parallel group"
    dp = surviving_chips // model_parallel
    dp = 2 ** int(math.floor(math.log2(dp)))
    chips = dp * model_parallel
    gb = max(dp, (global_batch // dp) * dp)
    if pods > 1 and dp % pods == 0:
        return ElasticPlan((pods, dp // pods, model_parallel),
                           ("pod", "data", "model"), gb,
                           f"{chips} chips, {pods} pods")
    return ElasticPlan((dp, model_parallel), ("data", "model"), gb,
                       f"{chips} chips, single group")


class RestartLoop:
    """supervise(run_fn): restart from latest checkpoint on failure."""

    def __init__(self, ckpt_mgr, max_restarts: int = 3, log=print):
        self.mgr = ckpt_mgr
        self.max_restarts = max_restarts
        self.log = log
        self.restarts = 0

    def supervise(self, run_fn: Callable[[Optional[int]], None]) -> int:
        """run_fn(resume_step) should raise on failure. Returns restarts."""
        while True:
            try:
                run_fn(self.mgr.latest_step())
                return self.restarts
            except Exception as e:  # noqa: BLE001 - any worker fault
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # a save still being written by this process is let finish,
                # so the restart sees every checkpoint the run committed
                self.mgr.wait()
                self.log(f"[ft] failure: {e!r}; restart "
                         f"{self.restarts}/{self.max_restarts} from step "
                         f"{self.mgr.latest_step()}")
