"""Disaggregated prefill / decode serving: two engine roles, one model.

The co-located `api.Session` time-slices prefill chunks and decode steps
through one batch on one pool, so a long prompt admitted mid-stream
stalls every decoder sharing the batch (TTFT and TPOT fight for the same
step budget).  Disaggregation splits the session into two *roles*:

* a **prefill role** (`PrefillSession`) that only processes prompts: its
  own slots, its own `PagedKV` pool and allocator, chunked prefill at the
  configured chunk.  The step it emits a request's first token, it *hands
  the request off*: the first token, the lifecycle record and the
  prompt's pages leave the role through the router's handoff queue.
* a **decode role** (`DecodeSession`) that only decodes: its slots fill
  from the handoff queue, never from the request queue.  Admission
  allocates fresh decode-pool pages, copies the prompt pages over
  (`disagg.migrate`: bf16 bit for bit, int8 codes and scales verbatim),
  writes the slot's page-table row and resumes at the handoff position.
  It *reserves* every page a request can ever need, so decoders are never
  preempted: pool pressure travels backwards as back-pressure on prefill
  admission (`DisaggRouter`) instead of forwards as recompute.

`DisaggSession` owns both roles and the router and drives them on a
shared tick: each tick runs at most one decode step and one prefill step.
Here both roles live on one card and share one set of (compressed)
weights; each step is the co-located session's own, so the roles launch
the same kernels (K1 for the compressed projections, K3 on the prefill
role's chunked steps, K2 on the decode role's steps).  Roles on disjoint
devices (``prefill_devices`` / ``decode_devices``) wait for the port of
the shard layer (ROADMAP queue 1 item 10).

Greedy tokens equal the co-located paged session's, as long as every
row's arithmetic is independent of its batch: on the CPU they are equal;
on the card the lm_head's f32 product and ``rms_norm``'s mean sum in
another order at another row count (the prefill role batches its own
slots' chunks), so a near-tie may flip there.  Sampling
(``temperature > 0``): each role holds its own CPU ``torch.Generator``
seeded by ``seed``; the prefill role's draws the first token of each
sampled request, the decode role's every later one, so a run repeats
with its seed.

Needs a paged KV cache on a family whose per-request state lives
entirely in KV pages (`sched.supports_chunked_prefill`): a recurrent
state (rwkv6, hymba's mamba branch) cannot ride a page migration.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kvstore as kvs
from repro_torch import obs as obs_mod
from repro_torch import resil as rsl
from repro_torch import sched as schd
from repro_torch.api.session import (ON_INCOMPLETE, Session,
                                      _unserved_record)
from repro_torch.api.spec import Request, Result
from repro_torch.disagg.migrate import Handoff, migrate_kv
from repro_torch.disagg.router import DisaggRouter


@dataclasses.dataclass
class DisaggConfig:
    """Two-role topology knobs.  Pool sizes default to the session's own
    sizing when None; ``max_backlog=None`` follows decode_slots (one queued
    handoff per decode slot before prefill admission stalls)."""
    prefill_slots: int = 2
    decode_slots: int = 4
    prefill_pool_pages: Optional[int] = None
    decode_pool_pages: Optional[int] = None
    max_backlog: Optional[int] = None
    prefill_devices: Optional[int] = None   # role meshes: the next slice
    decode_devices: Optional[int] = None

    def __post_init__(self):
        if self.prefill_slots < 1 or self.decode_slots < 1:
            raise ValueError("each role needs at least one batch slot")
        if (self.prefill_devices is None) != (self.decode_devices is None):
            raise ValueError("set prefill_devices and decode_devices "
                             "together (or neither)")

    @classmethod
    def coerce(cls, val) -> "DisaggConfig":
        if val is None or val is True:
            return cls()
        if isinstance(val, cls):
            return val
        if isinstance(val, dict):
            return cls(**val)
        raise TypeError(f"cannot make a DisaggConfig from {val!r}")


class PrefillSession(Session):
    """The prefill role: a Session whose scheduler is the shared router
    and whose requests leave through the handoff queue the moment they
    emit their first token.  A ``max_new == 1`` request never reaches the
    decode role: its one token completes here."""

    def __init__(self, *args, router: DisaggRouter,
                 on_handoff: Callable[[Handoff], None], **kw):
        kw["scheduler"] = router.cfg
        super().__init__(*args, **kw)
        if self.kv_cache != "paged" or \
                not schd.supports_chunked_prefill(self.cfg):
            raise ValueError(
                "disaggregated serving needs a paged KV cache on an arch "
                "whose per-request state is entirely KV pages "
                f"(family {self.cfg.family!r} keeps per-token recurrent "
                "state that cannot ride a page migration)")
        self.sched = router            # same cfg, shared queue + backlog
        if self.tracer.enabled:
            self._wire_obs()           # hooks onto the router
        self._on_handoff = on_handoff

    def _page_need(self, entry: schd.SchedEntry) -> int:
        # prompt-only residency: generated tokens land in the decode pool
        return schd.page_need(len(entry.req.prompt) + len(entry.out), 0,
                              self.max_len, self.page_size)

    def _emit(self, i: int, logits_i: np.ndarray, now: float):
        entry = self.slot_entry[i]
        super()._emit(i, logits_i, now)
        # every prefill-role emit IS a first token (the tick twin of the
        # record's first_token_step); a retried entry keeps its first
        # stamp (TTFT measures the first delivery)
        if entry.record.get("first_token_tick") is None:
            entry.record["first_token_tick"] = self.tick
        if self.slot_entry[i] is None:
            return                     # max_new == 1: finished at prefill
        # first token out: detach the slot and hand the request off.  The
        # prompt pages are pinned into the prefix cache first (the row is
        # about to be cleared), then the row's ownership moves to the
        # Handoff: the table is cleared WITHOUT freeing, and the
        # orchestrator frees the prefill-side refs once migration lands
        if self.prefix is not None:
            self._insert_slot_prefix(i, entry)
        pages = [int(p) for p in self.host_table[i]]
        self.host_table[i] = -1
        self.state["page_table"][i] = kvs.NO_PAGE
        self._detach_slot(i, release=False)
        rec = entry.record
        rec["prefill_done_time"] = now
        rec["prefill_done_tick"] = self.tick
        self._on_handoff(Handoff(entry=entry, pages=pages,
                                 pos=self.slot_pos[i], tick=self.tick))


class DecodeSession(Session):
    """The decode role: a Session that never takes from its own request
    queue (but for the resilience layer's fallback) — slots fill from
    handoffs, and admission reserves the whole worst-case page need, so
    running decoders are never preempted."""

    def __init__(self, *args, **kw):
        kw["scheduler"] = {"policy": "fifo", "chunk": 1}
        super().__init__(*args, **kw)
        assert self.kv_cache == "paged"
        self.stats.update({"handoffs": 0, "migrated_pages": 0,
                           "migrated_bytes": 0})

    def _fits(self, entry: schd.SchedEntry) -> bool:
        # the resilience layer's fallback admission (prefill on the decode
        # role) keeps the handoffs' reservation discipline, or a fallback
        # prompt could take pages an admitted decoder is owed
        return self._page_need(entry) <= \
            self.alloc.available - self._reserved_future()

    # ------------------------------------------------------- admission
    def _reserved_future(self) -> int:
        """Pages the active slots may still allocate, worst case.  Holes
        reclaimed by SWA only shrink the real number, so counting held
        pages from the table keeps this an overestimate."""
        res = 0
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            held = int((self.host_table[i] >= 0).sum())
            res += max(0, self._page_need(entry) - held)
        return res

    def fits_handoff(self, h: Handoff) -> bool:
        """Worst-case admission: the request's whole page need must fit
        what is free AFTER every admitted decoder's outstanding
        reservation, which is what makes decode preemption impossible."""
        return self._fits(h.entry)

    def admit_handoff(self, i: int, h: Handoff, src_state: dict,
                      now: Optional[float] = None, tick: int = 0) -> int:
        """Install handoff ``h`` into free slot ``i``: allocate decode
        pages, migrate the prompt's KV, write the slot's table row (host
        mirror and device table together, one host-to-device copy) and
        resume at ``h.pos``.  Returns the migrated bytes.  All or nothing:
        the allocation is atomic (`alloc_many`) and the row is written
        only after the copy."""
        assert self.slot_entry[i] is None
        entry = h.entry
        live = h.live()
        dst = self.alloc.alloc_many(len(live))
        self.state, moved = migrate_kv(src_state, self.state,
                                       [p for _, p in live], dst)
        self._reset_slot_state(i)      # clears the row, pos, slot leaves
        row = np.full(self.host_table.shape[1], kvs.NO_PAGE, np.int64)
        for (j, _), pid in zip(live, dst):
            row[j] = pid
        self.host_table[i] = row
        self.state["page_table"][i] = torch.from_numpy(
            row.astype(np.int32)).to(self.device)
        self.slot_pos[i] = h.pos
        self.state["pos"][i] = h.pos
        self.slot_entry[i] = entry
        self.slot_out[i] = list(entry.out)
        self.slot_pending[i] = []
        self.slot_cache_j[i] = 0
        entry.seq = self.sched._seq    # admission age (youngest)
        self.sched._seq += 1
        # admission runs between steps, after the last step's logits
        # reached the host, so the clock reads real time on the card too
        now = time.perf_counter() if now is None else now
        rec = entry.record
        rec["handoff_latency_s"] = now - rec["prefill_done_time"]
        rec["handoff_ticks"] = tick - rec["prefill_done_tick"]
        rec["migrated_pages"] = len(live)
        rec["migrated_bytes"] = moved
        self.stats["fills"] += 1
        self.stats["handoffs"] += 1
        self.stats["migrated_pages"] += len(live)
        self.stats["migrated_bytes"] += moved
        self.stats["page_allocs"] = self.alloc.total_allocs
        self.stats["pages_in_use"] = self.alloc.in_use
        self.stats["pages_peak"] = self.alloc.peak
        return moved


class DisaggSession:
    """Drives the two roles on a shared tick clock.

    The public surface is `api.Session`'s (`submit`, `run`,
    `run_workload`, `results`, `records`, `stats`, `failed`), so workloads
    and metrics drive either engine shape unchanged.  Arrival steps are
    read as ticks (the co-located session reads them as model calls: both
    are scheduling opportunities)."""

    def __init__(self, cfg, params, *, disagg, device, max_len: int = 256,
                 seed: int = 0, page_size: int = 16,
                 kv_dtype: Optional[str] = None, scheduler=None, resil=None,
                 obs=None, backend=None):
        d = DisaggConfig.coerce(disagg)
        if d.prefill_devices is not None:
            raise NotImplementedError(
                "roles on their own devices (prefill_devices / "
                "decode_devices) wait for the role meshes "
                "(launch.mesh.make_role_meshes), the next slice of the "
                "shard layer's port (ROADMAP queue 1 item 10); both roles "
                "share one device")
        self.dcfg = d
        backlog = d.max_backlog if d.max_backlog is not None \
            else d.decode_slots
        self.router = DisaggRouter(schd.SchedConfig.coerce(scheduler),
                                   max_backlog=backlog)
        # one ResilState for both roles and the orchestrator: counters meet
        # in one place and the fault plan is consulted once
        if resil is None or isinstance(resil, rsl.ResilState):
            self.resil = resil
        else:
            self.resil = rsl.ResilState(rsl.ResilConfig.coerce(resil))
        # one tracer: both roles and the orchestrator stamp one timeline
        self.tracer = obs if obs is not None else obs_mod.NULL
        common = dict(max_len=max_len, device=device, seed=seed,
                      kv_cache="paged", page_size=page_size,
                      kv_dtype=kv_dtype, resil=self.resil, obs=obs,
                      backend=backend)
        self.pre = PrefillSession(
            cfg, params, d.prefill_slots, kv_pool_pages=d.prefill_pool_pages,
            router=self.router, on_handoff=self._on_handoff, **common)
        # one model, two pools: the decode role shares the weights
        self.dec = DecodeSession(cfg, params, d.decode_slots,
                                 kv_pool_pages=d.decode_pool_pages, **common)
        self.pre.role = "prefill"
        self.dec.role = "decode"
        self._role_fail = {"prefill": 0, "decode": 0}  # fault streaks
        self.results: List[Result] = []   # merged at drain
        self.records = self.pre.records   # every request enters at prefill
        self.ticks = 0
        self.stats = {"ticks": 0, "prefill_busy_ticks": 0,
                      "decode_busy_ticks": 0, "handoffs": 0,
                      "migrated_bytes": 0}

    # ------------------------------------------------------------ public
    def submit(self, req: Request) -> None:
        self.pre.submit(req)
        # tick-denominated lifecycle, comparable with the co-located
        # session's step clock (metrics.summarize prefers these fields)
        self.records[-1]["submit_tick"] = self.ticks

    def run(self, max_steps: int = 10_000,
            on_incomplete: str = "raise") -> List[Result]:
        return self.run_workload([], max_steps=max_steps,
                                 on_incomplete=on_incomplete)

    def run_workload(self, arrivals: Sequence[Tuple[int, Request]],
                     max_steps: int = 10_000,
                     on_incomplete: str = "raise") -> List[Result]:
        """Drive both roles on the shared tick clock.  A terminal
        HealthError / OutOfPages dumps the flight recorder (when the
        tracer has one) before it is raised again."""
        if on_incomplete not in ON_INCOMPLETE:
            raise ValueError(f"on_incomplete={on_incomplete!r}; choose one "
                             f"of {ON_INCOMPLETE}")
        try:
            return self._run_loop(arrivals, max_steps, on_incomplete)
        except (rsl.HealthError, kvs.OutOfPages) as e:
            self.tracer.crash(type(e).__name__, tick=self.ticks,
                              error=str(e))
            raise

    @property
    def failed(self) -> List[rsl.RequestFailed]:
        """Structured failed-request results of both roles, rid order."""
        return sorted(self.pre.failed + self.dec.failed,
                      key=lambda f: f.rid)

    @property
    def margins(self) -> Dict[int, List[float]]:
        """Per request, the top-2 logit margin of every emitted token: the
        prefill role's (the first token) then the decode role's."""
        out: Dict[int, List[float]] = {}
        for sess in (self.pre, self.dec):
            for rid, m in sess.margins.items():
                out.setdefault(rid, []).extend(m)
        return out

    def resil_summary(self) -> Optional[dict]:
        return None if self.resil is None else self.resil.summary()

    def role_stats(self) -> dict:
        """Per-role counters in the shape sched.metrics.summarize folds
        into its ``"roles"`` record."""
        return {"prefill": {"steps": self.pre.stats["steps"],
                            "busy_ticks": self.stats["prefill_busy_ticks"]},
                "decode": {"steps": self.dec.stats["steps"],
                           "busy_ticks": self.stats["decode_busy_ticks"]},
                "_ticks": self.ticks}

    # --------------------------------------------------------- the loop
    def _run_loop(self, arrivals: Sequence[Tuple[int, Request]],
                  max_steps: int, on_incomplete: str) -> List[Result]:
        pending: Deque[Tuple[int, Request]] = collections.deque(
            sorted(arrivals, key=lambda a: a[0]))
        clock = self.ticks
        for _ in range(max_steps):
            self.pre.tick = self.dec.tick = self.ticks
            while pending and pending[0][0] <= clock:
                self.submit(pending.popleft()[1])
            if self.resil is not None:
                self._resil_tick()
            self._admit_handoffs()
            if self.dec.sched.queue:   # resil handoff-timeout fallback
                self.dec._fill_slots()
            dec_busy = any(e is not None for e in self.dec.slot_entry)
            dec_ran = dec_busy and self._step_role(self.dec, "decode")
            self.pre._fill_slots()
            pre_busy = any(e is not None for e in self.pre.slot_entry)
            pre_ran = pre_busy and self._step_role(self.pre, "prefill")
            self.ticks += 1
            self.stats["ticks"] = self.ticks
            self.stats["prefill_busy_ticks"] += int(pre_ran)
            self.stats["decode_busy_ticks"] += int(dec_ran)
            if not (pre_busy or dec_busy):
                if self.resil is not None and self._fault_waiting():
                    # the idleness is injected (a spike window, a handoff
                    # not yet redelivered): let the clock run it out
                    self.resil.count("wait_ticks")
                    clock += 1
                    continue
                self.ticks -= 1        # idle: that tick did no work
                self.stats["ticks"] = self.ticks
                if self.router.handoff:
                    self._oversized_handoff(on_incomplete)
                    continue
                if len(self.router) or self.dec.sched.queue:
                    self._incomplete(on_incomplete, blocked=True,
                                     pending=pending)
                    break
                if pending:            # idle until the next arrival
                    clock = pending[0][0]
                    continue
                break
            clock += 1
        else:
            self._incomplete(on_incomplete, blocked=False, pending=pending)
        self.stats["handoffs"] = self.router.stats["handoffs"]
        self.stats["migrated_bytes"] = self.dec.stats["migrated_bytes"]
        self.results = sorted(self.pre.results + self.dec.results,
                              key=lambda r: r.rid)
        return self.results

    def _oversized_handoff(self, on_incomplete: str) -> None:
        """Both roles idle yet the head handoff cannot land: the decode
        pool cannot hold even this one request.  Raise, or under "warn"
        fail it structurally (its prefill-side pages freed) and go on."""
        h = self.router.handoff[0]
        need = self.dec._page_need(h.entry)
        msg = (f"decode page pool too small: request {h.entry.req.rid} "
               f"needs {need} pages, pool has {self.dec.alloc.n_pages - 1} "
               "usable")
        if on_incomplete != "warn":
            raise kvs.OutOfPages(msg)
        self.router.handoff.popleft()
        self._free_prefill_pages(h)
        self.tracer.instant("handoff.oversized", tick=self.ticks,
                            role="decode", rid=h.entry.req.rid, need=need)
        self.pre._fail_entry(h.entry, "oversized")
        warnings.warn(msg, RuntimeWarning, stacklevel=4)

    def _free_prefill_pages(self, h: Handoff) -> None:
        """Drop the handoff's hold on its prefill-pool pages (a shared
        prefix page just loses one owner)."""
        self.pre.alloc.free(p for p in h.pages if p >= 0)
        self.pre.stats["pages_in_use"] = self.pre.alloc.in_use

    def _on_handoff(self, h: Handoff) -> None:
        """Router enqueue seam: the fault plan may drop the handoff
        (redelivered ``redeliver_after`` ticks later, at most the preset's
        ``max_drops`` times) or delay its visibility.  The whole delivery
        schedule is settled here, once: replay-deterministic whatever how
        often admission polls the queue."""
        plan = self.resil.plan if self.resil is not None else None
        if plan is not None:
            rid = h.entry.req.rid
            while plan.drop_handoff(rid, h.drops):
                h.drops += 1
                h.ready_tick = h.tick + h.drops * plan.redeliver_after
            delay = plan.handoff_delay(rid)
            if delay:
                h.ready_tick = max(h.ready_tick, h.tick + delay)
        self.router.push_handoff(h)
        self.tracer.instant(
            "handoff.enqueue", tick=self.ticks, role="prefill",
            rid=h.entry.req.rid, pages=sum(1 for p in h.pages if p >= 0),
            drops=h.drops, ready_tick=h.ready_tick,
            backlog=len(self.router.handoff))

    def _step_role(self, sess: Session, name: str) -> bool:
        """Advance one role one tick; an injected fault burns the tick (and
        feeds the wedge detector), a spike-throttled pool waits the window
        out.  Returns whether the step ran."""
        try:
            sess._advance()
            self._role_fail[name] = 0
            return True
        except rsl.InjectedFault:
            self._role_faulted(name)
            return False
        except kvs.OutOfPages:
            if sess._fault_waiting():
                self.resil.count("wait_ticks")
                return False
            raise

    def _fault_waiting(self) -> bool:
        """Idle because of an injected condition that time will clear."""
        if self.pre.alloc.holdback > 0 or self.dec.alloc.holdback > 0:
            return True
        # >= not >: self.ticks already counts this idle tick, and the next
        # loop's _admit_handoffs compares against the same value: a
        # handoff that just became ready is one loop from landing
        return any(h.ready_tick >= self.ticks for h in self.router.handoff)

    # ------------------------------------------------------ resil policy
    def _role_faulted(self, name: str) -> None:
        self.resil.count("fault_steps")
        self._role_fail[name] += 1
        r = self.resil
        if r.watchdog is None or self._role_fail[name] < r.cfg.wedge_ticks:
            return
        self._drain_role(name)
        self._role_fail[name] = 0

    def _drain_role(self, name: str) -> None:
        """Wedged-role recovery: every active slot goes back through the
        retry path (recompute at the prefill role: greedy decode makes the
        resumed stream the same tokens), at most ``max_retries`` times."""
        sess = self.pre if name == "prefill" else self.dec
        r = self.resil
        r.count("watchdog_recoveries")
        for i in reversed(range(sess.slots)):  # appendleft keeps order
            if sess.slot_entry[i] is None:
                continue
            e = sess._detach_slot(i)
            e.retries += 1
            if e.record is not None:
                e.record["retries"] = e.retries
            if e.retries > r.cfg.max_retries:
                sess._fail_entry(e, "retries_exhausted")
                continue
            r.count("retries")
            self.router.queue.appendleft(e)

    def _resil_tick(self) -> None:
        """The orchestrator's per-tick policy: each role's page holdback,
        deadline expiry wherever a request can wait (router queue, handoff
        queue, both roles' slots, the fallback queue), load shedding
        against the decode pool, the degradation ladder, handoff-timeout
        fallback, and the watchdog's audit."""
        r, t = self.resil, self.ticks
        if r.plan is not None:
            self.pre.alloc.holdback = r.plan.page_holdback(
                self.pre.alloc.n_pages - 1, t, role="prefill")
            self.dec.alloc.holdback = r.plan.page_holdback(
                self.dec.alloc.n_pages - 1, t, role="decode")
        self.pre._expire_queue_deadlines(t)    # router queue
        self.dec._expire_queue_deadlines(t)    # fallback queue
        self._expire_handoff_deadlines(t)
        self.pre._expire_slot_deadlines(t)
        self.dec._expire_slot_deadlines(t)
        if r.cfg.shed_watermark is not None:
            self._shed_load()
        if r.degrade is not None:
            usable = max(1, self.dec.alloc.n_pages - 1)
            if r.degrade.update(self.dec.alloc.available / usable) >= 1 \
                    and self.pre.prefix is not None:
                self.pre.prefix.release(self.pre.alloc, 1)
        if r.cfg.handoff_timeout is not None:
            self._handoff_timeouts(t)
        if r.watchdog is not None and r.watchdog.due(t):
            r.count("watchdog_audits")
            extra: Dict[int, int] = {}
            for h in self.router.handoff:
                for p in h.pages:
                    if p >= 0:
                        extra[p] = extra.get(p, 0) + 1
            r.watchdog.audit(self.pre, extra_refs=extra)
            r.watchdog.audit(self.dec)

    def _expire_handoff_deadlines(self, t: int) -> None:
        q = self.router.handoff
        keep: Deque[Handoff] = collections.deque()
        while q:
            h = q.popleft()
            e = h.entry
            if e.deadline_tick is not None and t > e.deadline_tick:
                self._free_prefill_pages(h)
                self.resil.count("deadline_miss")
                self.pre._fail_entry(e, "deadline")
            else:
                keep.append(h)
        q.extend(keep)

    def _shed_load(self) -> None:
        """Shed never-admitted queued prompts, youngest first, while the
        decode-pool demand (queued prompts and handoffs in flight, worst
        case) exceeds the watermark share of the decode pool."""
        r = self.resil
        limit = r.cfg.shed_watermark * max(1, self.dec.alloc.n_pages - 1)
        total = sum(self.dec._page_need(h.entry)
                    for h in self.router.handoff)
        total += sum(self.dec._page_need(e) for e in self.router.queue)
        while total > limit:
            e = self.router.shed_youngest()
            if e is None:
                break
            total -= self.dec._page_need(e)
            r.count("shed")
            self.pre._fail_entry(e, "shed")

    def _handoff_timeouts(self, t: int) -> None:
        """Graceful degradation: a handoff stuck past ``handoff_timeout``
        falls back to co-located prefill on the decode role: its
        prefill-side pages are freed and the entry re-enters through the
        decode role's own scheduler (recompute, reservation-checked
        admission, so decode still never preempts)."""
        timeout = self.resil.cfg.handoff_timeout
        q = self.router.handoff
        keep: Deque[Handoff] = collections.deque()
        while q:
            h = q.popleft()
            if t - h.tick > timeout:
                self._free_prefill_pages(h)
                e = h.entry
                if e.record is not None:
                    e.record["degraded"] = "colocated-prefill"
                self.resil.count("handoff_fallbacks")
                self.tracer.instant(
                    "handoff.fallback", tick=self.ticks, role="decode",
                    rid=e.req.rid, waited=t - h.tick)
                self.dec.sched.queue.append(e)
            else:
                keep.append(h)
        q.extend(keep)

    # -------------------------------------------------------- admission
    def _admit_handoffs(self) -> None:
        """Land queued handoffs FIFO into free decode slots; the first
        *ready* head that does not fit blocks (the order stays
        deterministic), fault-delayed ones are looked past.  The
        prefill-side refs are released only after the migration lands, so
        a handoff in flight can always be replayed."""
        q = self.router.handoff
        i = 0
        while i < len(q):
            h = q[i]
            if h.ready_tick > self.ticks:
                i += 1                 # dropped / delayed: not visible yet
                continue
            slot = next((s for s, e in enumerate(self.dec.slot_entry)
                         if e is None), None)
            if slot is None or not self.dec.fits_handoff(h):
                break
            del q[i]
            moved = self.dec.admit_handoff(slot, h, self.pre.state,
                                           tick=self.ticks)
            self._free_prefill_pages(h)
            rec = h.entry.record
            self.tracer.instant(
                "handoff.deliver", tick=self.ticks, role="decode",
                slot=slot, rid=h.entry.req.rid,
                waited=self.ticks - h.tick, drops=h.drops)
            self.tracer.instant(
                "handoff.migrate", tick=self.ticks, role="decode",
                slot=slot, rid=h.entry.req.rid,
                pages=rec["migrated_pages"], bytes=moved)

    def _incomplete(self, on_incomplete: str, blocked: bool,
                    pending: Sequence[Tuple[int, Request]] = ()) -> None:
        live = [e for e in self.pre.slot_entry if e is not None]
        live += [e for e in self.dec.slot_entry if e is not None]
        live += list(self.router.queue)
        live += list(self.dec.sched.queue)
        live += [h.entry for h in self.router.handoff]
        for e in live:
            if e.record is not None and e.record.get("state") == "queued":
                e.record["state"] = "unserved"
        for _, req in pending:
            self.records.append(_unserved_record(req))
        unfinished = [e.req.rid for e in live]
        unfinished += [req.rid for _, req in pending]
        if not unfinished or on_incomplete == "ignore":
            return
        why = ("prefill admission blocked (page pool too small for the "
               "head-of-line request's prompt)" if blocked
               else "max_steps exhausted")
        done = len(self.pre.results) + len(self.dec.results)
        msg = (f"DisaggSession.run stopped with {len(unfinished)} "
               f"unfinished request(s) {sorted(unfinished)}: {why}; "
               f"{done} completed")
        if on_incomplete == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=4)
            return
        raise kvs.OutOfPages(msg) if blocked else RuntimeError(msg)
