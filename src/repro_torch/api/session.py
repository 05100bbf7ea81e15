"""Serving session: continuous batching over a fixed-slot decode batch and
a paged KV pool (attention families) or the per-slot recurrent state
(rwkv6, which has nothing to page).

Requests occupy slots; a finished slot is refilled from the scheduler's
queue without stopping the batch.  The FIFO scheduler admits a request
only when its worst-case page need fits the pool, and under page pressure
the youngest slot is preempted back to the queue (recompute resume)
instead of letting ``OutOfPages`` crash the batch.  With ``chunk`` > 1 a
step that has prompt tokens pending runs the chunked-prefill step (up to
``chunk`` prompt tokens per prefilling slot, one token per decoding slot);
otherwise, and with chunk 1, prompts feed token by token through the
decode step.  Pages are allocated host-side the step a sequence crosses a
page boundary and freed the moment its request completes.  Where every
layer is windowed (h2o-danube, mixtral), a page that has slid wholly
behind the widest window is freed after each step (SWA reclamation), so a
sequence holds O(window) pages.

The rwkv6 family serves through ``RecurrentSession`` with its per-slot
state whatever ``kv_cache`` asks, as in the JAX package: no allocator and
no page table, chunk 1 (its time mix is recurrent), and a slot's state
zeroed when a request is admitted to it.  The full cache of attention
families, mesh, disaggregated roles, fault
injection, tracing and the prefix cache land with later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kvstore as kvs
from repro_torch import sched as schd
from repro_torch.api.spec import Request, Result
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

KV_CACHE_DEFAULT = "auto"
KV_DTYPE_DEFAULT = "bf16"


def resolve_kv_cache(kv_cache: Optional[str], cfg: ArchConfig) -> str:
    """None -> "auto"; "auto" -> paged wherever there is attention state."""
    kv = KV_CACHE_DEFAULT if kv_cache is None else kv_cache
    if kv == "auto":
        kv = "full" if cfg.family == "rwkv6" else "paged"
    return kv


class Session:
    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 4,
                 max_len: int = 256, *, device,
                 kv_cache: Optional[str] = None, page_size: int = 16,
                 kv_pool_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, scheduler=None):
        self.cfg, self.params = cfg, params
        self.device = torch.device(device)
        self.slots = batch_slots
        self.max_len = max_len
        self.page_size = page_size
        self.kv_dtype = kv_dtype or KV_DTYPE_DEFAULT
        self.sched = schd.Scheduler(schd.SchedConfig.coerce(scheduler))
        # chunked prefill needs attention-only token mixing; elsewhere
        # prompts feed token by token
        self.chunk = self.sched.cfg.chunk \
            if schd.supports_chunked_prefill(cfg) else 1
        self._init_state(resolve_kv_cache(kv_cache, cfg), kv_pool_pages)
        self.slot_pos = [0] * batch_slots
        self.slot_entry: List[Optional[schd.SchedEntry]] = \
            [None] * batch_slots
        self.slot_pending: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.results: List[Result] = []
        #: per request, the top-2 logit margin of every emitted token
        self.margins: Dict[int, List[float]] = {}
        self.stats = {"steps": 0, "prefill_steps": 0, "fills": 0,
                      "preemptions": 0, "chunk": self.chunk,
                      "page_allocs": 0, "pages_in_use": 0, "pages_peak": 0,
                      "pages_reclaimed_swa": 0, "nonfinite_logit_rows": 0}

    def _init_state(self, kv_cache: str, kv_pool_pages: Optional[int]):
        if kv_cache != "paged":
            raise NotImplementedError(
                f"kv_cache={kv_cache!r}: the port serves attention families "
                "from the paged cache; their full cache lands with a later "
                "slice")
        self.state = M.init_decode_state(
            self.cfg, self.slots, self.max_len, kv_cache="paged",
            page_size=self.page_size, kv_pool_pages=kv_pool_pages,
            kv_dtype=self.kv_dtype, device=self.device)
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

    # ------------------------------------------------------------ public
    def submit(self, req: Request) -> None:
        if req.temperature > 0:
            raise NotImplementedError("sampling (temperature > 0) lands "
                                      "with a later slice; decode is greedy")
        self.sched.submit(req)

    def run(self, max_steps: int = 10_000) -> List[Result]:
        """Drain the queue; returns all results in rid order.  Raises if
        ``max_steps`` runs out or admission deadlocks with work left."""
        for _ in range(max_steps):
            self._fill_slots()
            if all(e is None for e in self.slot_entry):
                if len(self.sched):
                    raise kvs.OutOfPages(
                        "admission blocked: the page pool is too small "
                        "for the head-of-line request's worst-case need")
                break
            self._advance()
        else:
            if len(self.sched) or any(e is not None
                                      for e in self.slot_entry):
                raise RuntimeError(f"Session.run: max_steps={max_steps} "
                                   "exhausted with requests unfinished")
        return sorted(self.results, key=lambda r: r.rid)

    # --------------------------------------------------------- admission
    def _page_need(self, entry: schd.SchedEntry) -> int:
        req = entry.req
        return schd.page_need(
            len(req.prompt) + len(entry.out), req.max_new - len(entry.out),
            self.max_len, self.page_size)

    def _fits(self, entry: schd.SchedEntry) -> bool:
        return self._page_need(entry) <= self.alloc.available

    def _fill_slots(self):
        for i in range(self.slots):
            if self.slot_entry[i] is not None:
                continue
            entry = self.sched.next_entry(self._fits)
            if entry is None:
                break
            self._admit(i, entry)

    def _admit(self, i: int, entry: schd.SchedEntry):
        self.slot_entry[i] = entry
        # recompute resume: a preempted request re-prefills its prompt
        # PLUS its generated-so-far tokens, then continues
        self.slot_pending[i] = list(entry.req.prompt) + list(entry.out)
        self.slot_out[i] = list(entry.out)
        self._reset_slot_state(i)
        self.stats["fills"] += 1

    def _reset_slot_state(self, i: int):
        """Release the slot's pages and rewind its position.  Stale page
        contents are harmless: the position mask never reaches unwritten
        slots and int8 scales reset on re-allocation."""
        self._release_slot_pages(i)
        self.state["pos"][i] = 0
        self.slot_pos[i] = 0

    # ------------------------------------------------------ paged KV admin
    def _release_slot_pages(self, i: int) -> None:
        pages = [int(p) for p in self.host_table[i] if p >= 0]
        if not pages:
            return
        self.alloc.free(pages)
        self.host_table[i] = -1
        self.state["page_table"][i] = kvs.NO_PAGE
        self.stats["pages_in_use"] = self.alloc.in_use

    def _preempt_slot(self, i: int) -> None:
        """Evict slot ``i`` back to the queue front: pages freed now,
        tokens regenerated on re-admission."""
        entry = self.slot_entry[i]
        entry.out = list(self.slot_out[i])
        self._release_slot_pages(i)
        self.slot_entry[i] = None
        self.slot_pending[i] = []
        self.slot_out[i] = []
        self.sched.requeue(entry)
        self.stats["preemptions"] += 1

    def _ensure_pages(self, counts: List[int]) -> None:
        """Before a step, make sure each active slot owns every page its
        next ``counts[i]`` tokens land in; fresh int8 pages get their
        scales cleared.  Transactional: on OutOfPages this round's grants
        are rolled back."""
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
        """Allocate; on OutOfPages preempt the youngest slot until the rest
        fits.  A pool too small for one request still raises."""
        while True:
            try:
                self._ensure_pages(counts)
                return
            except kvs.OutOfPages:
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

    # ------------------------------------------------------------ stepping
    def _advance(self):
        """A chunked step while any active slot still has prompt tokens
        pending, a decode step otherwise; then the SWA reclamation."""
        if self.chunk > 1 and any(self.slot_pending[i]
                                  for i, e in enumerate(self.slot_entry)
                                  if e is not None):
            self._advance_chunked()
        else:
            self._advance_decode()
        self._reclaim_swa_pages()

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
        with torch.no_grad():
            self.state, logits = M.decode_step(
                self.cfg, self.params, self.state,
                torch.as_tensor(tokens, device=self.device))
        self.stats["steps"] += 1
        for i, entry in enumerate(self.slot_entry):
            if entry is not None:
                self.slot_pos[i] += 1
        logits = logits[:, : self.cfg.vocab].cpu().numpy()
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            if self.slot_pending[i]:
                self.slot_pending[i].pop(0)
                if self.slot_pending[i]:
                    continue  # still prefilling
            self._emit(i, logits[i])

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
        with torch.no_grad():
            self.state, logits = schd.prefill_step(
                self.cfg, self.params, self.state,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(counts, dtype=torch.int32,
                                device=self.device))
        self.stats["steps"] += 1
        self.stats["prefill_steps"] += 1
        for i, entry in enumerate(self.slot_entry):
            if entry is not None:
                self.slot_pos[i] += counts[i]
        # only each slot's last fed position is sampled: bring just those
        # rows to the host
        last = torch.as_tensor([max(c - 1, 0) for c in counts],
                               device=self.device)
        logits = logits[torch.arange(self.slots, device=self.device), last,
                        : self.cfg.vocab].cpu().numpy()
        for i, entry in enumerate(self.slot_entry):
            if entry is None:
                continue
            if self.slot_pending[i]:
                del self.slot_pending[i][:counts[i]]
                if self.slot_pending[i]:
                    continue  # still prefilling
            self._emit(i, logits[i])

    def _emit(self, i: int, logits_i: np.ndarray):
        """Greedy next token for slot ``i``; finish the request at max_new
        and return its pages at once."""
        entry = self.slot_entry[i]
        req = entry.req
        nxt = int(logits_i.argmax())
        top2 = np.partition(logits_i, -2)[-2:]
        self.margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        if not np.isfinite(logits_i).all():
            self.stats["nonfinite_logit_rows"] += 1
        self.slot_out[i].append(nxt)
        if len(self.slot_out[i]) >= req.max_new:
            self.results.append(Result(req.rid, self.slot_out[i]))
            self.slot_entry[i] = None
            self._release_slot_pages(i)


class RecurrentSession(Session):
    """rwkv6: one recurrent state per slot, the same size at every length,
    so nothing to page whatever ``kv_cache`` asks: slots are pre-allocated,
    admission always fits and a slot's state is zeroed on admission."""

    def _init_state(self, kv_cache: str, kv_pool_pages: Optional[int]):
        self.state = M.init_decode_state(self.cfg, self.slots, self.max_len,
                                         device=self.device)
        self.alloc = None
        self._swa_window = None

    def _fits(self, entry: schd.SchedEntry) -> bool:
        return True

    def _reset_slot_state(self, i: int):
        for leaf in self.state["layers"].values():        # [L, B, ...]
            leaf[:, i] = 0
        self.state["pos"][i] = 0
        self.slot_pos[i] = 0

    def _release_slot_pages(self, i: int) -> None:
        pass

    def _ensure_pages(self, counts: List[int]) -> None:
        pass
