"""Serving session: continuous batching over a fixed-slot decode batch and
a paged KV pool (attention families, by default), a dense per-slot KV
cache (``kv_cache="full"``) or the per-slot recurrent state (rwkv6, which
has nothing to page), driven by timed traffic.

Requests occupy slots; a finished slot is refilled from the scheduler's
queue without stopping the batch.  The scheduler (`repro_torch.sched`)
decides admission order (FIFO, or shortest-prompt-first with aging),
admits a request only when its worst-case page need fits the pool, and
under page pressure the youngest slot is preempted back to the queue
(recompute resume) instead of letting ``OutOfPages`` crash the batch.
With ``chunk`` > 1 a step that has prompt tokens pending runs the
chunked-prefill step (up to ``chunk`` prompt tokens per prefilling slot,
one token per decoding slot); otherwise, and with chunk 1, prompts feed
token by token through the decode step.  Pages are allocated host-side
the step a sequence crosses a page boundary and freed the moment its
request completes.  Where every layer is windowed (h2o-danube, mixtral),
a page that has slid wholly behind the widest window is freed after each
step (SWA reclamation), so a sequence holds O(window) pages.

The decode step is the backend's (``backend=``, an `api.registry`
name or Executor; `torch-dense` when not given): the Engine passes its
active backend, and both decode backends give `models.model.decode_step`,
whose compressed projections reach the CUDA kernels through
`models.layers.dense`.

Traffic: ``run_workload`` serves ``[(arrival_step, Request)]`` (see
``sched.workload``), fast-forwarding idle gaps; every request leaves a
lifecycle record in ``records`` (the JAX package's schema) that
``sched.metrics.summarize`` folds into TTFT / TPOT / goodput.  With
``prefix_cache`` full prompt pages are content-hashed and shared across
requests (refcounted): a request whose prompt starts with a cached prefix
attaches those page ids and prefills from the first page after them.
``temperature > 0`` samples from ``softmax(logits / T)`` with a CPU
``torch.Generator`` seeded by ``seed``, so the same logits rows give the
same tokens on the card and on the CPU.  ``obs=`` takes an
``obs.Tracer``: the tick-clock event stream of every seam, and wall
phases around each step.

Without pages (the full cache, and rwkv6 whatever ``kv_cache`` asks, as
in the JAX package) there is no allocator, no page table and no prefix
cache, admission always fits, prompts feed at chunk 1, and on admission a
slot's slot-shaped state is zeroed and its cache positions read as empty
(-1).  hymba's mamba state is zeroed on admission under either cache.  An
encoder (no decode step) is refused.  One difference from the JAX
package: hymba refuses the prefix cache, since attached prompt pages never
pass through its mamba heads, whose state would miss them.

Resilience (``resil=``, `repro_torch.resil`): a ``ResilConfig`` (or dict,
or ``"preset:seed"`` fault-plan string) adds per-request deadlines, load
shedding, the degradation ladder, the watchdog's audits and seeded fault
injection; a request the session gives up on leaves as a structured
``RequestFailed`` in ``failed``, never as an exception.  An injected step
fault is raised before the step enqueues any work on the device, so the
tick is lost and nothing is launched.  ``resil=None`` (the default) is the
serving path without any of these seams.  The disaggregated roles
(`repro_torch.disagg`) are subclasses of this session.

Mesh serving: a ``plan`` (`repro_torch.shard.ShardingPlan`, built by
``Engine.session(mesh=...)``) makes the session one rank of a
tensor-parallel serve: its params are this rank's bands of the banded
projections (compressed leaves padded to the tp degree first), a paged
pool keeps this rank's KV heads, and the decode and chunked steps run
every projection and the paged attention over the mesh.  Every rank runs
this same host loop (scheduler, allocator, prefix cache) in lockstep:
the gathered logits are the same on every rank, so every rank takes the
same decisions.  ``plan=None`` is the single-device path.
"""
from __future__ import annotations

import collections
import contextlib
import time
import warnings
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kvstore as kvs
from repro_torch import obs as obs_mod
from repro_torch import resil as rsl
from repro_torch import sched as schd
from repro_torch.api import env
from repro_torch.api.registry import get_backend
from repro_torch.api.spec import Request, Result
from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache as kvc
from repro_torch.models import model as M

# the REPRO_KV_CACHE / REPRO_KV_DTYPE knobs, resolved once at import
# (`api.env`); a session's kv_cache= / kv_dtype= arguments win
KV_CACHE_DEFAULT = env.KV_CACHE
KV_DTYPE_DEFAULT = env.KV_DTYPE
ON_INCOMPLETE = ("raise", "warn", "ignore")


def resolve_kv_cache(kv_cache: Optional[str], cfg: ArchConfig) -> str:
    """None -> the env default; "auto" -> paged wherever there is
    attention state."""
    kv = KV_CACHE_DEFAULT if kv_cache is None else kv_cache
    if kv == "auto":
        kv = "full" if cfg.family == "rwkv6" else "paged"
    return kv


def _unserved_record(req: Request) -> dict:
    """Lifecycle record of a request that never reached submit() (terminal
    state 'unserved'); Session.submit's records start from it."""
    return {"rid": req.rid, "prompt_len": len(req.prompt),
            "max_new": req.max_new, "submit_step": None,
            "submit_time": None, "admit_step": None, "admit_time": None,
            "first_token_step": None, "first_token_time": None,
            "finish_time": None, "n_generated": 0, "preemptions": 0,
            "prefix_pages": 0, "state": "unserved",
            "failed_reason": None, "retries": 0}


class Session:
    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 4,
                 max_len: int = 256, *, device, seed: int = 0,
                 kv_cache: Optional[str] = None, page_size: int = 16,
                 kv_pool_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, scheduler=None,
                 resil=None, obs=None, backend=None, plan=None):
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is an encoder: it has no decode "
                             "step to serve")
        # the decode step comes from the backend (a name or an Executor;
        # None: torch-dense); one without batched decode raises here
        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch-dense")
        self.backend = backend
        self._step = backend.make_decode_step(cfg) if plan is None \
            else backend.make_decode_step(cfg, plan=plan)
        self.device = torch.device(device)
        self.plan = plan
        if plan is not None:
            from repro_torch import shard
            from repro_torch.launch.mesh import same_device
            if not same_device(plan.mesh.device, self.device):
                raise ValueError(f"the mesh's rank runs on "
                                 f"{plan.mesh.device}, the session on "
                                 f"{self.device}")
            # this rank's bands of the banded projections
            params = shard.prepare_params(plan, cfg, params)
        self.cfg, self.params = cfg, params
        self.slots = batch_slots
        self.max_len = max_len
        self.page_size = page_size
        self.kv_dtype = kv_dtype or KV_DTYPE_DEFAULT
        self.kv_cache = "full" if cfg.family == "rwkv6" \
            else resolve_kv_cache(kv_cache, cfg)
        self.sched = schd.Scheduler(schd.SchedConfig.coerce(scheduler))
        if self.sched.cfg.prefix_cache and self.kv_cache == "paged" \
                and cfg.family == "hymba":
            raise ValueError(
                f"{cfg.name}: no prefix cache for a family with per-token "
                "recurrent state: attached prompt pages are never fed "
                "through its mamba heads, so their state would miss them")
        # chunked prefill needs pages to write into and attention-only
        # token mixing; elsewhere prompts feed token by token
        self.chunk = self.sched.cfg.chunk if (
            self.kv_cache == "paged"
            and schd.supports_chunked_prefill(cfg)) else 1
        self.stats = {"steps": 0, "prefill_steps": 0, "fills": 0,
                      "preemptions": 0, "chunk": self.chunk,
                      "page_allocs": 0, "pages_in_use": 0, "pages_peak": 0,
                      "pages_reclaimed_swa": 0, "prefix_hits": 0,
                      "prefix_pages_reused": 0, "nonfinite_logit_rows": 0}
        self._init_state(kv_pool_pages)
        self.slot_pos = [0] * batch_slots
        self.slot_entry: List[Optional[schd.SchedEntry]] = \
            [None] * batch_slots
        self.slot_pending: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        # per slot, the next prompt page to offer the prefix cache
        self.slot_cache_j: List[int] = [0] * batch_slots
        self.results: List[Result] = []
        self.failed: List[rsl.RequestFailed] = []
        #: one lifecycle record per request (the JAX package's schema)
        self.records: List[dict] = []
        #: per request, the top-2 logit margin of every emitted token
        self.margins: Dict[int, List[float]] = {}
        # sampling draws: a CPU generator, advanced only by sampled tokens
        self.gen = torch.Generator().manual_seed(seed)
        # resilience layer: None is the path without it; a ResilState may
        # be shared by the disaggregated roles, so counters meet in one
        # place
        if resil is None or isinstance(resil, rsl.ResilState):
            self.resil = resil
        else:
            self.resil = rsl.ResilState(rsl.ResilConfig.coerce(resil))
        self.role = "engine"       # disaggregated roles: prefill / decode
        self.tick = 0              # scheduling-opportunity clock
        # observability: obs.NULL keeps every seam on the untraced path
        # (hooks stay None, emits are no-ops)
        self.tracer = obs if obs is not None else obs_mod.NULL
        if self.tracer.enabled:
            self._wire_obs()

    def _init_state(self, kv_pool_pages: Optional[int]):
        if self.kv_cache == "full":
            self.state = M.init_decode_state(self.cfg, self.slots,
                                             self.max_len, kv_cache="full",
                                             device=self.device)
            self.alloc = self.prefix = self.host_table = None
            self._swa_window = None
            return
        if self.kv_cache != "paged":
            raise ValueError(f"unknown kv_cache {self.kv_cache!r}")
        self.state = M.init_decode_state(
            self.cfg, self.slots, self.max_len, kv_cache="paged",
            page_size=self.page_size, kv_pool_pages=kv_pool_pages,
            kv_dtype=self.kv_dtype, device=self.device)
        if self.plan is not None:          # this rank's KV heads
            from repro_torch import shard
            self.state = shard.place_state(self.plan, self.state,
                                           self.cfg.n_kv)
        self.alloc = kvs.PageAllocator(self.state["layers"]["kv"].n_pages)
        # host mirror of the device page table (allocation decisions never
        # read device memory back)
        self.host_table = np.full(
            (self.slots, self.state["page_table"].shape[1]), -1, np.int64)
        # pages can be reclaimed only when EVERY layer is windowed (one
        # global layer keeps the whole history)
        wins = self.cfg.layer_windows()
        self._swa_window = max(wins) if wins and all(
            w > 0 for w in wins) else None
        self.prefix = schd.PrefixCache() \
            if self.sched.cfg.prefix_cache else None

    def _wire_obs(self) -> None:
        """Attach the tracer to the host-side seams; the hook reads
        ``self.role`` and ``self.tick`` when it fires, so a disaggregated
        role renamed after construction stamps its own name."""
        def hook(name, **args):
            self.tracer.instant(name, tick=self.tick, role=self.role,
                                **args)
        if self.alloc is not None:
            self.alloc.obs = hook
        if self.prefix is not None:
            self.prefix.obs = hook
        self.sched.obs = hook
        if self.resil is not None:
            if self.resil.degrade is not None:
                self.resil.degrade.obs = hook
            if self.resil.watchdog is not None:
                self.resil.watchdog.obs = hook

    def _step_ctx(self, phase: str):
        """Wall-clock phase accounting around a step and its logits copy
        (tracing on only); wall times never enter the event stream."""
        if not self.tracer.enabled:
            return contextlib.nullcontext()
        return self.tracer.wall.phase(phase)

    # ------------------------------------------------------------ public
    def submit(self, req: Request) -> None:
        # submit runs between steps, after the last step's logits reached
        # the host, so its clock reading is real time on the card too
        entry = self.sched.submit(req, step=self.stats["steps"],
                                  now=time.perf_counter())
        if self.alloc is not None:
            entry.hashes = schd.page_hashes(req.prompt, self.page_size)
        rec = dict(_unserved_record(req), submit_step=entry.submit_step,
                   submit_time=entry.submit_time, state="queued")
        entry.record = rec
        self.records.append(rec)
        if self.resil is not None:
            entry.deadline_tick = self.resil.deadline_for(req, self.tick)
            rec["deadline_tick"] = entry.deadline_tick
        self.tracer.instant("req.submit", tick=self.tick, role=self.role,
                            rid=req.rid, prompt_len=len(req.prompt),
                            max_new=req.max_new)

    def run(self, max_steps: int = 10_000,
            on_incomplete: str = "raise") -> List[Result]:
        """Drain the queue; returns all results in rid order.
        ``on_incomplete``: what to do when ``max_steps`` runs out (or
        admission deadlocks) with requests queued or in flight — "raise",
        "warn" (partial results) or "ignore"."""
        return self.run_workload([], max_steps=max_steps,
                                 on_incomplete=on_incomplete)

    def run_workload(self, arrivals: Sequence[Tuple[int, Request]],
                     max_steps: int = 10_000,
                     on_incomplete: str = "raise") -> List[Result]:
        """Serve timed traffic: ``arrivals`` is [(arrival_step, Request)]
        (see sched.workload); requests already submit()ed count as step-0
        arrivals.  Idle gaps fast-forward the clock.  A ``HealthError`` or
        ``OutOfPages`` escaping the loop dumps the flight recorder (when
        the tracer has one) before it is raised again."""
        if on_incomplete not in ON_INCOMPLETE:
            raise ValueError(f"on_incomplete={on_incomplete!r}; choose one "
                             f"of {ON_INCOMPLETE}")
        try:
            return self._run_loop(arrivals, max_steps, on_incomplete)
        except (rsl.HealthError, kvs.OutOfPages) as e:
            self.tracer.crash(type(e).__name__, role=self.role,
                              tick=self.tick, error=str(e))
            raise

    def _run_loop(self, arrivals: Sequence[Tuple[int, Request]],
                  max_steps: int, on_incomplete: str) -> List[Result]:
        pending: Deque[Tuple[int, Request]] = collections.deque(
            sorted(arrivals, key=lambda a: a[0]))
        # the arrival clock follows the model-call count but jumps over
        # idle gaps; stats["steps"] counts executed model calls only
        clock = self.stats["steps"]
        for _ in range(max_steps):
            self.tick = clock
            while pending and pending[0][0] <= clock:
                self.submit(pending.popleft()[1])
            if self.resil is not None:
                self._resil_tick(clock)
            self._fill_slots()
            if all(e is None for e in self.slot_entry):
                if self._fault_waiting():
                    # an injected page spike holds the pool: burn the tick
                    # so the window can pass, not an admission deadlock
                    self.resil.count("wait_ticks")
                    clock += 1
                    continue
                if len(self.sched):
                    self._incomplete(on_incomplete, blocked=True,
                                     pending=pending)
                    break
                if pending:        # idle until the next arrival
                    clock = pending[0][0]
                    continue
                break
            try:
                self._advance()
            except rsl.InjectedFault as f:
                # an injected step failure (role-stall / straggler): the
                # tick is lost, the work is not
                self.resil.count("fault_steps")
                self.tracer.instant("fault.injected", tick=self.tick,
                                    role=self.role, fault=f.fault_class)
            except kvs.OutOfPages:
                if self._fault_waiting():
                    # a page spike squeezed even the last runner: wait the
                    # window out (pages come back, recompute resumes)
                    self.resil.count("wait_ticks")
                else:
                    raise
            clock += 1
        else:
            self._incomplete(on_incomplete, blocked=False, pending=pending)
        return sorted(self.results, key=lambda r: r.rid)

    def _incomplete(self, on_incomplete: str, blocked: bool,
                    pending: Sequence[Tuple[int, Request]] = ()) -> None:
        """Terminal records for everything that never finished (arrivals
        still pending included), then raise, warn or pass."""
        live = [e for e in self.slot_entry if e is not None]
        live += list(self.sched.queue)
        for e in live:
            if e.record is not None and e.record.get("state") == "queued":
                e.record["state"] = "unserved"
        for _, req in pending:
            self.records.append(_unserved_record(req))
        unfinished = [e.req.rid for e in live]
        unfinished += [req.rid for _, req in pending]  # never submitted
        if not unfinished or on_incomplete == "ignore":
            return
        why = ("admission blocked (page pool too small for the "
               "head-of-line request's worst-case need)" if blocked
               else "max_steps exhausted")
        msg = (f"Session.run stopped with {len(unfinished)} unfinished "
               f"request(s) {sorted(unfinished)}: {why}; "
               f"{len(self.results)} completed")
        if on_incomplete == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=4)
            return
        raise kvs.OutOfPages(msg) if blocked else RuntimeError(msg)

    # ------------------------------------------------------- resil layer
    def resil_summary(self) -> Optional[dict]:
        """Shed / retry / deadline-miss / fault counters, or None when the
        resilience layer is off."""
        return None if self.resil is None else self.resil.summary()

    def _fault_waiting(self) -> bool:
        """Idle because an injected page spike holds the pool (burn the
        tick), not because admission is deadlocked."""
        return (self.resil is not None and self.alloc is not None
                and self.alloc.holdback > 0)

    def _resil_tick(self, tick: int) -> None:
        """Per-tick policy: the fault plan's page holdback, deadline expiry,
        load shedding past the watermark, the degradation ladder and the
        watchdog's audit."""
        r = self.resil
        if r.plan is not None and self.alloc is not None:
            self.alloc.holdback = r.plan.page_holdback(
                self.alloc.n_pages - 1, tick, role=self.role)
        self._expire_queue_deadlines(tick)
        self._expire_slot_deadlines(tick)
        if r.cfg.shed_watermark is not None and self.alloc is not None:
            self._shed_load()
        if r.degrade is not None and self.alloc is not None:
            usable = max(1, self.alloc.n_pages - 1)
            if r.degrade.update(self.alloc.available / usable) >= 1 \
                    and self.prefix is not None:
                self.prefix.release(self.alloc, 1)  # level 1: drop LRU pins
        if r.watchdog is not None and r.watchdog.due(tick):
            r.count("watchdog_audits")
            r.watchdog.audit(self)

    def _expire_queue_deadlines(self, tick: int) -> None:
        for e in self.sched.pop_expired(tick):
            self.resil.count("deadline_miss")
            self._fail_entry(e, "deadline")

    def _expire_slot_deadlines(self, tick: int) -> None:
        for i, entry in enumerate(self.slot_entry):
            if entry is None or entry.deadline_tick is None \
                    or tick <= entry.deadline_tick:
                continue
            self._detach_slot(i)
            self.resil.count("deadline_miss")
            self._fail_entry(entry, "deadline")

    def _shed_load(self) -> None:
        """Refuse never-admitted queued work, youngest first, while the
        queue's summed worst-case page need exceeds the watermark share
        of the usable pool."""
        r = self.resil
        limit = r.cfg.shed_watermark * max(1, self.alloc.n_pages - 1)
        total = sum(self._page_need(e) for e in self.sched.queue)
        while total > limit:
            e = self.sched.shed_youngest()
            if e is None:
                break
            total -= self._page_need(e)
            r.count("shed")
            self.tracer.instant("sched.shed", tick=self.tick,
                                role=self.role, rid=e.req.rid)
            self._fail_entry(e, "shed")

    def _fail_entry(self, entry: schd.SchedEntry, reason: str) -> None:
        """Terminal structured failure: the request leaves as a
        RequestFailed result, never as an unhandled exception."""
        rec = entry.record
        if rec is not None:
            rec["state"] = "failed"
            rec["failed_reason"] = reason
            rec["retries"] = entry.retries
            rec["n_generated"] = len(entry.out)
        self.failed.append(rsl.RequestFailed(
            rid=entry.req.rid, reason=reason, tokens=list(entry.out),
            retries=entry.retries))
        if self.resil is not None:
            self.resil.count("failed")
        self.tracer.instant("resil.fail", tick=self.tick, role=self.role,
                            rid=entry.req.rid, reason=reason,
                            retries=entry.retries)
        # flight-recorder post-mortem: the ticks leading up to the failure
        self.tracer.crash(f"RequestFailed_{reason}", rid=entry.req.rid,
                          why=reason, role=self.role, tick=self.tick)

    # --------------------------------------------------------- admission
    def _page_need(self, entry: schd.SchedEntry) -> int:
        req = entry.req
        return schd.page_need(
            len(req.prompt) + len(entry.out), req.max_new - len(entry.out),
            self.max_len, self.page_size)

    def _prefix_hit_pids(self, entry: schd.SchedEntry) -> List[int]:
        """Page ids of the leading full prompt pages this entry could
        attach from the prefix cache right now (a pure lookup, no refs)."""
        if self.prefix is None:
            return []
        n = schd.prefix.usable_prefix_pages(len(entry.req.prompt),
                                            self.page_size)
        pids: List[int] = []
        for j in range(min(n, self.host_table.shape[1])):
            pid = self.prefix.peek(entry.hashes[j])
            if pid is None:
                break
            pids.append(pid)
        return pids

    def _fits(self, entry: schd.SchedEntry) -> bool:
        if self.alloc is None:
            return True            # no pages: every slot is pre-allocated
        hits = self._prefix_hit_pids(entry)
        avail = self.alloc.available
        if self.prefix is not None:
            # pages only the cache still holds can be released under
            # pressure — but not the ones this entry would attach itself
            avail += self.prefix.releasable(self.alloc, exclude=hits)
        return self._page_need(entry) - len(hits) <= avail

    def _fill_slots(self):
        for i in range(self.slots):
            if self.slot_entry[i] is not None:
                continue
            entry = self.sched.next_entry(self._fits,
                                          step=self.stats["steps"])
            if entry is None:
                break
            self._admit(i, entry)

    def _admit(self, i: int, entry: schd.SchedEntry):
        req = entry.req
        rec = entry.record
        if rec["admit_step"] is None:
            rec["admit_step"] = self.stats["steps"]
            # between steps: the last step's logits are already on the host
            rec["admit_time"] = time.perf_counter()
        if self.resil is not None and self.resil.degrade is not None \
                and self.resil.degrade.kv_demote and not rec.get("degraded"):
            # level 2: this admission would take int8 KV in the next
            # session (a live session's pool dtype is fixed)
            rec["degraded"] = True
            self.resil.count("degraded_admissions")
        self.tracer.instant("sched.admit", tick=self.tick, role=self.role,
                            slot=i, rid=req.rid, resumed=len(entry.out))
        self.slot_entry[i] = entry
        # recompute resume: a preempted request re-prefills its prompt
        # PLUS its generated-so-far tokens, then continues
        self.slot_pending[i] = list(req.prompt) + list(entry.out)
        self.slot_out[i] = list(entry.out)
        self._reset_slot_state(i)
        self.stats["fills"] += 1
        self.slot_cache_j[i] = 0
        if self.prefix is not None:
            self._attach_prefix(i, entry)

    def _attach_prefix(self, i: int, entry: schd.SchedEntry):
        """Reuse cached prefix pages: their ids go into this slot's table
        row (host mirror and device table together, one host-to-device
        copy), ``pos`` moves past them and the covered prompt tokens are
        skipped."""
        n = schd.prefix.usable_prefix_pages(len(entry.req.prompt),
                                            self.page_size)
        pids: List[int] = []
        for j in range(min(n, self.host_table.shape[1])):
            pid = self.prefix.lookup(entry.hashes[j])
            if pid is None:
                break
            self.alloc.ref(pid)
            self.host_table[i, j] = pid
            pids.append(pid)
        if not pids:
            return
        self.state["page_table"][i, :len(pids)] = torch.tensor(
            pids, dtype=torch.int32).to(self.device)
        skip = len(pids) * self.page_size
        self.slot_pending[i] = self.slot_pending[i][skip:]
        self.slot_pos[i] = skip
        self.state["pos"][i] = skip
        self.slot_cache_j[i] = len(pids)
        entry.prefix_pages += len(pids)
        entry.record["prefix_pages"] += len(pids)
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_reused"] += len(pids)
        self.stats["pages_in_use"] = self.alloc.in_use

    def _reset_slot_state(self, i: int):
        """Release the slot's pages, zero its slot-shaped state ([L, B,
        ...]: a dense cache, hymba's mamba state, rwkv6's state) with a
        dense cache's positions at -1 (never written), and rewind its
        position.  Stale page contents are harmless: the position mask
        never reaches unwritten slots and int8 scales reset on
        re-allocation."""
        self._release_slot_pages(i)
        for leaf in _slot_leaves(self.state["layers"]):
            leaf[:, i] = 0
        kv = self.state["layers"].get("kv")
        if isinstance(kv, kvc.KVCache):
            kv.pos[:, i] = -1
        self.state["pos"][i] = 0
        self.slot_pos[i] = 0

    # ------------------------------------------------------ paged KV admin
    def _release_slot_pages(self, i: int) -> None:
        """Drop slot ``i``'s hold on its pages (request done, slot reset,
        preemption); shared prefix pages just lose this slot's ref."""
        if self.alloc is None:
            return
        pages = [int(p) for p in self.host_table[i] if p >= 0]
        if not pages:
            return
        self.alloc.free(pages)
        self.host_table[i] = -1
        self.state["page_table"][i] = kvs.NO_PAGE
        self.stats["pages_in_use"] = self.alloc.in_use

    def _detach_slot(self, i: int,
                     release: bool = True) -> schd.SchedEntry:
        """Take slot ``i``'s request out of the batch and return its entry,
        the tokens generated so far kept on it; the slot's pages are
        released unless the caller hands them on (``release=False``)."""
        entry = self.slot_entry[i]
        entry.out = list(self.slot_out[i])
        if release:
            self._release_slot_pages(i)
        self.slot_entry[i] = None
        self.slot_pending[i] = []
        self.slot_out[i] = []
        return entry

    def _preempt_slot(self, i: int) -> None:
        """Evict slot ``i`` back to the queue front: pages freed now,
        tokens regenerated on re-admission."""
        entry = self.slot_entry[i]
        entry.record["preemptions"] += 1
        # traced before the pages go, whose frees the allocator traces
        self.tracer.instant("sched.preempt", tick=self.tick,
                            role=self.role, slot=i, rid=entry.req.rid,
                            generated=len(self.slot_out[i]))
        self.sched.requeue(self._detach_slot(i))
        self.stats["preemptions"] += 1

    def _ensure_pages(self, counts: List[int]) -> None:
        """Before a step, make sure each active slot owns every page its
        next ``counts[i]`` tokens land in; fresh int8 pages get their
        scales cleared.  Transactional: on OutOfPages this round's grants
        are rolled back."""
        if self.alloc is None:
            return
        npp = self.host_table.shape[1]
        events = []
        try:
            for i, entry in enumerate(self.slot_entry):
                if entry is None or counts[i] == 0:
                    continue
                lo = self.slot_pos[i] // self.page_size
                hi = (self.slot_pos[i] + counts[i] - 1) // self.page_size
                for pi in range(lo, min(hi, npp - 1) + 1):
                    if self.host_table[i, pi] >= 0:
                        continue
                    pid = self.alloc.alloc()
                    self.host_table[i, pi] = pid
                    events.append((i, pi, pid))
        except kvs.OutOfPages:
            for i, pi, pid in events:
                self.host_table[i, pi] = -1
            self.alloc.free(pid for _, _, pid in events)
            raise
        if not events:
            return
        si, pi, pids = (torch.tensor([e[n] for e in events],
                                     dtype=torch.long, device=self.device)
                        for n in range(3))
        self.state["page_table"][si, pi] = pids.to(torch.int32)
        kv = self.state["layers"]["kv"]
        if kv.quantized:
            kv.k_scale[:, pids] = 0.0
            kv.v_scale[:, pids] = 0.0
        self.stats["page_allocs"] = self.alloc.total_allocs
        self.stats["pages_in_use"] = self.alloc.in_use
        self.stats["pages_peak"] = self.alloc.peak

    def _ensure_pages_or_preempt(self, counts: List[int]) -> None:
        """Allocate; on OutOfPages release prefix-cache pins LRU-first,
        then preempt the youngest slot, until the rest fits.  A pool too
        small for one request still raises."""
        while True:
            try:
                self._ensure_pages(counts)
                return
            except kvs.OutOfPages:
                if self.prefix is not None \
                        and self.prefix.release(self.alloc, 1):
                    continue
                victim = schd.Scheduler.choose_victim(self.slot_entry)
                if victim is None:
                    raise
                self._preempt_slot(victim)
                counts[victim] = 0

    def _reclaim_swa_pages(self) -> None:
        """Where every layer is windowed, free the pages that slid wholly
        behind the widest window: host table and allocator now, the device
        table's entries set to NO_PAGE (the kernels mask such an entry)."""
        if self._swa_window is None:
            return
        events = []
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            dead = kvs.reclaimable_prefix(self.slot_pos[i],
                                          self._swa_window, self.page_size)
            for pi in range(min(dead, self.host_table.shape[1])):
                pid = int(self.host_table[i, pi])
                if pid >= 0:
                    self.alloc.free([pid])
                    self.host_table[i, pi] = -1
                    events.append((i, pi))
        if not events:
            return
        si, pi = (torch.tensor([e[n] for e in events], dtype=torch.long,
                               device=self.device) for n in range(2))
        self.state["page_table"][si, pi] = kvs.NO_PAGE
        self.stats["pages_reclaimed_swa"] += len(events)
        self.stats["pages_in_use"] = self.alloc.in_use

    def _insert_slot_prefix(self, i: int, entry: schd.SchedEntry) -> None:
        """Pin slot ``i``'s freshly completed full prompt pages into the
        prefix cache (first writer wins; generated-token pages are never
        cached)."""
        n_full = len(entry.req.prompt) // self.page_size
        j = self.slot_cache_j[i]
        while j < min(n_full, self.host_table.shape[1]) \
                and self.slot_pos[i] >= (j + 1) * self.page_size:
            pid = int(self.host_table[i, j])
            if pid >= 0:           # may be gone (SWA reclamation)
                self.prefix.insert(entry.hashes[j], pid, self.alloc)
            j += 1
        self.slot_cache_j[i] = j

    def _insert_prefix_pages(self) -> None:
        if self.prefix is None:
            return
        for i, entry in enumerate(self.slot_entry):
            if entry is not None:
                self._insert_slot_prefix(i, entry)

    # ------------------------------------------------------------ stepping
    def _advance(self):
        """A chunked step while any active slot still has prompt tokens
        pending, a decode step otherwise; then the SWA reclamation and the
        prefix cache's new pages.  The fault plan's step check comes first:
        an injected fault raises before any work reaches the device."""
        if self.resil is not None and self.resil.plan is not None:
            self.resil.plan.check_step(self.role, self.tick)
        if self.chunk > 1 and any(self.slot_pending[i]
                                  for i, e in enumerate(self.slot_entry)
                                  if e is not None):
            self._advance_chunked()
        else:
            self._advance_decode()
        self._reclaim_swa_pages()
        self._insert_prefix_pages()

    def _active_counts(self, chunk: int) -> List[int]:
        """Tokens each slot feeds this step: up to ``chunk`` pending prompt
        tokens, else 1 (its next token); 0 for an idle slot."""
        counts = [0] * self.slots
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            counts[i] = min(chunk, len(self.slot_pending[i])) \
                if self.slot_pending[i] else 1
        return counts

    def _next_token(self, i: int, entry: schd.SchedEntry) -> int:
        """The token a decoding slot feeds: its last output, else the last
        prompt token."""
        if self.slot_out[i]:
            return self.slot_out[i][-1]
        return entry.req.prompt[-1]

    def _advance_decode(self):
        """One token per active slot through the decode step."""
        counts = self._active_counts(1)
        self._ensure_pages_or_preempt(counts)
        tokens = np.zeros((self.slots,), np.int64)
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            tokens[i] = self.slot_pending[i][0] if self.slot_pending[i] \
                else self._next_token(i, entry)
        with self._step_ctx("decode"), torch.no_grad():
            self.state, logits = self._step(
                self.params, self.state,
                torch.as_tensor(tokens, device=self.device))
            # the copy to the host waits for the card: every time read
            # after it is a real one, not an enqueue time
            logits = logits[:, : self.cfg.vocab].cpu().numpy()
        now = time.perf_counter()
        self.stats["steps"] += 1
        self.tracer.span("step.decode", tick=self.tick, role=self.role,
                         active=sum(1 for c in counts if c),
                         step=self.stats["steps"])
        for i, entry in enumerate(self.slot_entry):
            if entry is not None:
                self.slot_pos[i] += 1
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            if self.slot_pending[i]:
                self.slot_pending[i].pop(0)
                if self.slot_pending[i]:
                    continue  # still prefilling
            self._emit(i, logits[i], now)

    def _advance_chunked(self):
        """Mixed prefill + decode step: up to ``chunk`` prompt tokens per
        prefilling slot, 1 token per decoding slot, all in one call."""
        counts = self._active_counts(self.chunk)
        self._ensure_pages_or_preempt(counts)
        tokens = np.zeros((self.slots, self.chunk), np.int64)
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            if self.slot_pending[i]:
                tokens[i, :counts[i]] = self.slot_pending[i][:counts[i]]
            else:
                tokens[i, 0] = self._next_token(i, entry)
        # only each slot's last fed position is sampled: bring just those
        # rows to the host
        last = torch.as_tensor([max(c - 1, 0) for c in counts],
                               device=self.device)
        with self._step_ctx("prefill"), torch.no_grad():
            self.state, logits = schd.prefill_step(
                self.cfg, self.params, self.state,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(counts, dtype=torch.int32,
                                device=self.device), plan=self.plan)
            # the copy to the host waits for the card (see _advance_decode)
            logits = logits[torch.arange(self.slots, device=self.device),
                            last, : self.cfg.vocab].cpu().numpy()
        now = time.perf_counter()
        self.stats["steps"] += 1
        self.stats["prefill_steps"] += 1
        self.tracer.span("step.prefill", tick=self.tick, role=self.role,
                         active=sum(1 for c in counts if c),
                         tokens=sum(counts), step=self.stats["steps"])
        for i, entry in enumerate(self.slot_entry):
            if entry is not None:
                self.slot_pos[i] += counts[i]
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            if self.slot_pending[i]:
                del self.slot_pending[i][:counts[i]]
                if self.slot_pending[i]:
                    continue  # still prefilling
            self._emit(i, logits[i], now)

    def _sample(self, logits_i: np.ndarray, temperature: float) -> int:
        """One draw from softmax(logits / T), in f64 on the host."""
        p = torch.softmax(torch.from_numpy(logits_i).double() / temperature,
                          dim=-1)
        return int(torch.multinomial(p, 1, generator=self.gen))

    def _emit(self, i: int, logits_i: np.ndarray, now: float):
        """The next token for slot ``i`` (greedy, or sampled when the
        request has a temperature); finish the request at max_new and
        return its pages at once.  ``now``: the host clock after this
        step's logits reached the host."""
        entry = self.slot_entry[i]
        req = entry.req
        if req.temperature > 0:
            nxt = self._sample(logits_i, req.temperature)
        else:
            nxt = int(logits_i.argmax())
        top2 = np.partition(logits_i, -2)[-2:]
        self.margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        if not np.isfinite(logits_i).all():
            self.stats["nonfinite_logit_rows"] += 1
        self.slot_out[i].append(nxt)
        rec = entry.record
        if rec["first_token_time"] is None:
            rec["first_token_time"] = now
            rec["first_token_step"] = self.stats["steps"]
            self.tracer.instant("req.first_token", tick=self.tick,
                                role=self.role, slot=i, rid=req.rid)
        if len(self.slot_out[i]) >= req.max_new:
            self.results.append(Result(req.rid, self.slot_out[i]))
            rec["finish_time"] = now
            rec["n_generated"] = len(self.slot_out[i])
            rec["state"] = "completed"
            self.tracer.instant("req.finish", tick=self.tick,
                                role=self.role, slot=i, rid=req.rid,
                                tokens=len(self.slot_out[i]))
            self.slot_entry[i] = None
            self._release_slot_pages(i)


def _slot_leaves(tree):
    """The [L, B, ...] tensors of a decode state's layers: everything but
    a page pool, whose pages no slot owns."""
    if isinstance(tree, kvs.PagedKV):
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _slot_leaves(v)
    elif isinstance(tree, kvc.KVCache):
        yield from tree
    else:
        yield tree
