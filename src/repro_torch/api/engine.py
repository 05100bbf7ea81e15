"""`Engine` — the port's entry point to compress and serve a model::

    from repro_torch.api import Engine, Request, CompressionSpec
    from repro_torch.configs import get

    eng = Engine(get("llama3-8b"))                 # random init, on the card
    eng.compress(CompressionSpec(mode="aida", density=0.25))
    results = eng.serve([Request(prompt=[1, 2, 3], max_new=8)])
    table1 = eng.estimate(backend="cycle-sim", workload="table1")

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where every kernel takes its plain version).  A
session takes its decode step from the active backend (``backend=``:
`torch-dense` or `cuda`, picked from the compression when not pinned).
Both give `models.model.decode_step`, so the compression decides which
kernels run: compressed projections reach K1 / K4 / K5 through
`models.layers.dense` on either.  What the choice adds is the pin's
checks: a pinned backend refuses modes it cannot run in ``compress`` and
refuses to serve without batched decode.  ``estimate`` routes to a
cycle-accounting backend (`ap-emulator` on the engine's device,
`cycle-sim` on the host).
On the card, ``session`` first autotunes the launch plans of every kernel
the session will run (`kernels.tune`; ``REPRO_AUTOTUNE=0`` keeps today's
plans), as the reference's ``Engine._pretune`` does.
``serve(..., disagg=True)`` splits serving into a prefill role and a
decode role on the same device (`repro_torch.disagg`); ``resil=`` turns on
the resilience layer (`repro_torch.resil`).  ``session(mesh=...)`` serves
tensor-parallel over a mesh of ranks (`repro_torch.shard`), one process
per rank, each holding a band of every banded projection.

The benchmark surface returns JSON-ready dicts and writes no file:
``benchmark`` serves each compression mode and prices the cost-model
backends, and adds the ``kv_benchmark`` (full vs paged cache, the
attention / FC split of a decode step), ``serving_benchmark`` (chunked
prefill, traffic, prefix cache, preemption), ``disagg_benchmark``,
``resil_benchmark`` (the fault presets) and ``capacity_benchmark`` (the
smallest config meeting ``CAPACITY_SLO``, in ticks) sections where the
architecture has them.  Each section serves on this engine's device
through engines of its own on the same weights; on the card every
wall-clock window ends in a synchronise, and the attention / FC split is
the card's time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.api import compress as compress_mod
from repro_torch.api.registry import CapabilityError, Executor, get_backend
from repro_torch.api.session import Session
from repro_torch.api.spec import CompressionSpec, FCProblem, Request, Result
from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device


#: the declared SLO the ``capacity`` section gates against, in scheduler
#: ticks (deterministic): calibrated so that the burst preset separates an
#: under-provisioned config from an adequate one (2 slots queue to a TTFT
#: p99 of about 36 ticks, 4 slots reach about 3)
CAPACITY_SLO = "ttft_p99=20,tpot_p99=4,goodput=1.0"

#: the two-point sweep of the ``capacity`` section: an under-provisioned
#: config the SLO rejects and an adequate one
CAPACITY_SMOKE_SWEEP = (
    {"slots": 2, "kv_pool_pages": 16, "chunk": 4, "policy": "fifo"},
    {"slots": 4, "kv_pool_pages": 24, "chunk": 4, "policy": "fifo"},
)


def _spec_modes(spec: CompressionSpec) -> set:
    """Modes a spec actually executes ('skip' leaves leaves raw)."""
    return {spec.mode} | {m for m in spec.overrides.values() if m != "skip"}


class Engine:
    def __init__(self, cfg: Union[ArchConfig, str, None] = None,
                 params=None, *, backend: Optional[str] = None,
                 device=None, seed: int = 0):
        if isinstance(cfg, str):
            from repro_torch.configs import get
            cfg = get(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # raw f32 products (lm_head) in full f32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
        self._params = params
        self._backend_name = backend
        self._seed = seed
        self.compression: Optional[CompressionSpec] = None
        self.stats: Optional[dict] = None
        #: one entry a `_pretune` call: its seconds and new winners
        self.tune_log: List[dict] = []

    @property
    def params(self):
        """Model params (random-initialised from ``seed`` on first access
        if not given)."""
        if self._params is None:
            if self.cfg is None:
                raise ValueError("Engine has no cfg; pass params explicitly "
                                 "or construct with an ArchConfig")
            from repro_torch.models import model as M
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            self._params = M.init_params(self.cfg, gen)
        return self._params

    @property
    def backend(self) -> Executor:
        """Active decode backend: the explicit choice, else 'cuda' once
        compressed to a non-dense mode, else 'torch-dense'."""
        if self._backend_name:
            return get_backend(self._backend_name)
        if self.compression is not None \
                and _spec_modes(self.compression) - {"dense"}:
            return get_backend("cuda")
        return get_backend("torch-dense")

    def compress(self, spec: Union[CompressionSpec, str, None] = None,
                 *, verbose=None, **kw) -> "Engine":
        """Deep-Compression of every eligible projection per ``spec``
        (keyword shortcuts mode=, density=, k= also work).  Returns self;
        stats land in ``self.stats``."""
        spec = CompressionSpec.coerce(spec)
        if kw:
            spec = dataclasses.replace(spec, **kw)
        if self._backend_name:  # explicit pin: the backend must run the modes
            caps = self.backend.caps
            wanted = _spec_modes(spec)
            if len(wanted) > 1 and not caps.per_layer_override:
                raise CapabilityError(
                    f"backend {self._backend_name!r} does not support "
                    "per-layer mode overrides")
            missing = wanted - set(caps.modes)
            if missing:
                raise CapabilityError(
                    f"backend {self._backend_name!r} cannot execute modes "
                    f"{sorted(missing)}; its modes are {caps.modes} "
                    "(drop the explicit backend= pin to auto-route)")
        with torch.no_grad():
            self._params, self.stats = compress_mod.compress_params(
                self.params, spec, verbose=verbose)
        self.compression = spec
        return self

    # ------------------------------------------------------------- serve
    def _pretune(self, batch_slots: int, max_len: int, page_size: int,
                 kv_dtype: Optional[str], kv_cache: Optional[str],
                 plan, scheduler=None) -> None:
        """Autotune the kernels a session at this batch width will launch,
        on the card: compressed-FC geometries (a mesh rank's bands under
        a plan, the ranks agreeing on each winner) and the paged-attention
        range and chunk query tile.  Appends its seconds and new winners
        to ``tune_log``."""
        from repro_torch import sched as schd
        from repro_torch.api import session as sess_mod
        from repro_torch.kernels import tune
        if not tune.tunable(self.device):
            return
        t0, n0 = time.perf_counter(), len(tune.snapshot())
        tp = plan.tp if plan is not None else 1
        resolved_kv = sess_mod.resolve_kv_cache(kv_cache, self.cfg)
        chunk = schd.SchedConfig.coerce(scheduler).chunk
        chunked = chunk > 1 and resolved_kv == "paged" \
            and self.cfg.family != "rwkv6" \
            and schd.supports_chunked_prefill(self.cfg)
        reduce = None
        if tp > 1:                     # the ranks agree on every winner
            from repro_torch.shard import comm
            reduce = comm.max_over(plan.group, self.device)
        if self.backend.name == "cuda" and self.compression is not None:
            if tune.enabled():
                if tp > 1:
                    # the ranks launch their bands under the whole's key
                    from repro_torch import shard
                    shard.tune_local_views(self.params, plan, batch_slots,
                                           chunk if chunked else 1)
                else:
                    tune.tune_params(self.params, batch_slots,
                                     chunk if chunked else 1)
        # a mesh's paged kernels take the whole geometry's choice
        # (`split_hkv`), so the same global tune applies to its head bands
        if resolved_kv == "paged" and self.cfg.family != "rwkv6" \
                and tune.enabled():
            kvd = kv_dtype or sess_mod.KV_DTYPE_DEFAULT
            tune.tune_paged(self.cfg, batch_slots, max_len, page_size, kvd,
                            self.device, reduce=reduce)
            if chunk > 1 and schd.supports_chunked_prefill(self.cfg):
                tune.tune_paged_chunk(self.cfg, batch_slots, max_len,
                                      page_size, chunk, kvd, self.device,
                                      reduce=reduce)
        self.tune_log.append({"seconds": time.perf_counter() - t0,
                              "new_keys": len(tune.snapshot()) - n0})

    def session(self, batch_slots: int = 4, max_len: int = 256,
                seed: int = 0, kv_cache: Optional[str] = None,
                page_size: int = 16, kv_pool_pages: Optional[int] = None,
                kv_dtype: Optional[str] = None, scheduler=None,
                disagg=None, resil=None, obs=None, mesh=None):
        """A continuous-batching serving session on the engine's device.
        ``kv_cache``: None / "auto" (paged wherever there is attention),
        "paged" or "full" (the dense per-slot cache).  ``scheduler``: a
        `sched.SchedConfig` (or dict / policy name): policy, chunk, prefix
        cache.  ``seed`` seeds the sampling draws of
        requests with a temperature.  ``obs``: an `obs.Tracer` for the
        tick-clock event stream (None: untraced).

        ``disagg``: True / dict / `disagg.DisaggConfig` — a disaggregated
        prefill / decode pair instead (a `disagg.DisaggSession` with the
        same submit / run surface): two roles sharing this engine's
        weights, each with its own slots and page pool, joined by the page
        migration channel; ``batch_slots`` and ``kv_pool_pages`` give way
        to the per-role knobs.  Needs the paged cache on a family without
        recurrent state.

        ``resil``: a `resil.ResilConfig` (or dict / ``"preset:seed"``
        fault-plan string) — seeded fault injection, deadlines, bounded
        retry, load shedding and graceful degradation.  A live
        `resil.ResilState` carries the degradation ladder across
        sessions: once sustained page pressure has pushed it to level 2,
        this session's pool is int8.  ``resil=None`` is the path without
        the layer.  A pinned backend without batched decode raises
        `CapabilityError`.

        ``mesh``: a `launch.mesh.Mesh` (``make_host_mesh(n_model)`` in each
        rank's process) — this rank's share of a tensor-parallel serve
        under a `shard.ShardingPlan`: every rank calls this with the same
        engine and requests, holds a band of each banded projection and
        of the paged pool's KV heads, and runs the same host loop; under
        the default gather policy the tokens and logits equal the
        single-device serve's bit for bit."""
        if self.cfg is None:
            raise ValueError("serving needs an ArchConfig")
        backend = self.backend  # the session asks it for the decode step
        if resil is not None:
            from repro_torch import resil as rsl
            if isinstance(resil, rsl.ResilState):
                # the next-session boundary: a live session's pool dtype
                # is fixed, so level-2 demotion lands here
                kv_dtype = resil.next_kv_dtype(kv_dtype)
        if disagg is not None and disagg is not False:
            if mesh is not None:
                raise ValueError(
                    "mesh= and disagg= are mutually exclusive — give the "
                    "roles their own devices via DisaggConfig."
                    "prefill_devices/decode_devices")
            if kv_cache not in (None, "auto", "paged"):
                raise ValueError(
                    "disaggregated serving migrates KV pages; it cannot "
                    f"run on kv_cache={kv_cache!r}")
            from repro_torch.disagg import DisaggConfig, DisaggSession
            d = DisaggConfig.coerce(disagg)
            self._pretune(d.prefill_slots, max_len, page_size, kv_dtype,
                          "paged", None, scheduler=scheduler)
            if d.decode_slots != d.prefill_slots:
                self._pretune(d.decode_slots, max_len, page_size, kv_dtype,
                              "paged", None, scheduler=scheduler)
            return DisaggSession(
                self.cfg, self.params, disagg=disagg, device=self.device,
                max_len=max_len, seed=seed, page_size=page_size,
                kv_dtype=kv_dtype, scheduler=scheduler, resil=resil,
                obs=obs, backend=backend)
        plan = None
        if mesh is not None:
            from repro_torch import shard
            plan = shard.make_plan(mesh, self.cfg)
        self._pretune(batch_slots, max_len, page_size, kv_dtype, kv_cache,
                      plan, scheduler=scheduler)
        return Session(self.cfg, self.params, batch_slots=batch_slots,
                       max_len=max_len, device=self.device, seed=seed,
                       kv_cache=kv_cache, page_size=page_size,
                       kv_pool_pages=kv_pool_pages, kv_dtype=kv_dtype,
                       scheduler=scheduler, resil=resil, obs=obs,
                       backend=backend, plan=plan)

    def serve(self, requests: Sequence[Union[Request, List[int]]], *,
              batch_slots: int = 4, max_len: int = 256,
              max_steps: int = 10_000, seed: int = 0,
              kv_cache: Optional[str] = None, scheduler=None,
              disagg=None, resil=None, obs=None) -> List[Result]:
        """Serve a batch of requests to completion (continuous batching);
        results come back in rid order.  ``disagg`` serves through a
        disaggregated prefill / decode pair, ``resil`` turns on the
        resilience layer (see `session`)."""
        sess = self.session(batch_slots=batch_slots, max_len=max_len,
                            seed=seed, kv_cache=kv_cache,
                            scheduler=scheduler, disagg=disagg,
                            resil=resil, obs=obs)
        for rid, req in enumerate(requests):
            if not isinstance(req, Request):
                req = Request(prompt=list(req), rid=rid)
            sess.submit(req)
        return sess.run(max_steps=max_steps)

    def estimate(self, backend: str = "cycle-sim",
                 workload: Union[FCProblem, str, Sequence, None] = None,
                 **kw) -> dict:
        """Cycle / perf accounting through a cost-model backend.

        ``workload``: an FCProblem (a concrete FC instance: 'ap-emulator'
        runs it bit by bit on the engine's device, 'cycle-sim' prices it in
        closed form; the two agree exactly under the EMULATOR microcode),
        or a named network ('alexnet-fc', 'ctc-lstm', 'table1') for
        'cycle-sim'.
        """
        ex = get_backend(backend)
        if not ex.caps.cycle_accounting:
            raise CapabilityError(
                f"backend {backend!r} has no cycle accounting")
        if workload is None:
            workload = "alexnet-fc"
        return ex.estimate(workload, device=self.device, **kw)

    # --------------------------------------------------------- benchmark
    def _sync(self) -> None:
        """Wait for the card before a wall clock is read (a no-op on the
        CPU, whose work is done when the call returns)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inner(self, mode: str, density: float) -> "Engine":
        """A fresh engine on this engine's weights and device, compressed
        to ``mode`` (its own compressed copy; the raw weights are shared
        and left as they are)."""
        eng = Engine(self.cfg, params=self.params, device=self.device)
        if mode != "dense":
            eng.compress(CompressionSpec(mode=mode, density=density))
        return eng

    def kv_benchmark(self, mode: str = "aida", requests: int = 8,
                     max_new: int = 24, batch_slots: int = 2,
                     max_len: int = 64, page_size: int = 16,
                     density: float = 0.25) -> dict:
        """Paged-vs-dense KV cache comparison on one compressed mode:
        serve the same request mix through both cache kinds (int8 pages,
        so K2 runs over int8 pages on the card), record KV bytes / token,
        and time the attention-vs-FC split of a decode step (the share
        the paged subsystem exists to attack)."""
        from repro_torch import kvstore as kvs
        from repro_torch.kernels import tune
        cfg = self.cfg
        if cfg is None or cfg.family == "rwkv6":
            raise CapabilityError(
                "kv_benchmark needs an attention arch (rwkv6 has no KV "
                "cache to page)")
        eng = self._inner(mode, density)
        reqs = [Request(prompt=[1, 2 + i % 7, 3], max_new=max_new, rid=i)
                for i in range(requests)]
        out = {"mode": mode, "page_size": page_size, "max_len": max_len,
               "batch_slots": batch_slots}
        seen_tiles = set(tune.snapshot())
        # interleaved best-of rounds: the paged / full ratio holds only if
        # both sides see the same load, so alternate them and keep each
        # side's best pass
        for _ in range(3):
            for kind in ("full", "paged"):
                sess = eng.session(batch_slots=batch_slots,
                                   max_len=max_len, kv_cache=kind,
                                   page_size=page_size, kv_dtype="int8")
                sess.submit(Request(prompt=[1], max_new=1, rid=-1))
                sess.run()  # first launches (library loads, handles)
                sess.results.clear()
                for r in reqs:
                    sess.submit(r)
                self._sync()
                t0 = time.perf_counter()
                res = sess.run()
                self._sync()
                dt = time.perf_counter() - t0
                n_tok = sum(len(r.tokens) for r in res)
                if kind in out and out[kind]["tok_per_s"] >= n_tok / dt:
                    continue
                rec = {"tokens": n_tok, "seconds": round(dt, 4),
                       "tok_per_s": round(n_tok / dt, 2)}
                if kind == "paged":
                    rec["pages_peak"] = sess.stats["pages_peak"]
                    rec["page_allocs"] = sess.stats["page_allocs"]
                    snap = tune.snapshot()
                    rec["tiles"] = {k: v for k, v in snap.items()
                                    if k not in seen_tiles}
                out[kind] = rec
        del sess
        out["paged_over_full"] = round(
            out["paged"]["tok_per_s"] / out["full"]["tok_per_s"], 3)
        pbt = kvs.kv_bytes_per_token(cfg.n_kv, cfg.head_dim,
                                     page_size) * cfg.n_layers
        dbt = kvs.dense_kv_bytes_per_token(cfg.n_kv,
                                           cfg.head_dim) * cfg.n_layers
        out["kv_bytes_per_token"] = {
            "paged_int8": round(pbt, 1), "dense_bf16": round(dbt, 1),
            "ratio": round(pbt / dbt, 4)}
        out["attn_time_share"] = self._attn_fc_share(
            eng, batch_slots, max_len, page_size)
        return out

    def _attn_fc_share(self, eng: "Engine", batch: int, max_len: int,
                       page_size: int) -> dict:
        """Decomposition of a decode step at full cache occupancy: the
        attention term (cache update + attend, per layer x L; the full
        cache's plain ops, or K2 over int8 pages) against the FC term
        (every compressed projection's layer 0 at this batch width
        through K1 / K4 / K5, a raw one as an f32 product, x L).  Each
        piece is timed by `obs.timeit` (best of 5 samples of 3 calls):
        the card's time on the card, the wall clock on the CPU."""
        import functools

        import numpy as np

        from repro_torch import kvstore as kvs
        from repro_torch.core import sparse_fc as sfc
        from repro_torch.kernels import tune
        from repro_torch.models import attention as attn
        from repro_torch.models import kvcache as kvc
        from repro_torch.obs import timeit as _timeit
        from repro_torch.optim.adamw import leaves
        cfg, dev = self.cfg, self.device
        rng = np.random.default_rng(0)
        timeit = functools.partial(_timeit, reps=5, inner=3)

        def normal(*shape):
            return torch.as_tensor(rng.normal(size=shape),
                                   dtype=torch.float32).to(dev)

        hkv, h, dh = cfg.n_kv, cfg.n_heads, cfg.head_dim
        scale = dh ** -0.5
        q, k, v = normal(batch, h, 1, dh), normal(batch, hkv, 1, dh), \
            normal(batch, hkv, 1, dh)
        cur = torch.full((batch,), max_len - 1, dtype=torch.int32,
                         device=dev)
        cache = kvc.init_cache(batch, hkv, max_len, dh, device=dev)
        cache = cache._replace(pos=torch.arange(
            max_len, dtype=torch.int32, device=dev).expand(
                batch, max_len).contiguous())
        with torch.no_grad():
            t_full = timeit(
                lambda c, qq, kk, vv, p: attn.decode_attend(
                    c, qq, kk, vv, p, window=-1, scale=scale)[1],
                cache, q, k, v, cur)
            npp = -(-max_len // page_size)
            pool = kvs.init_pool(1 + batch * npp, hkv, page_size, dh,
                                 device=dev)

            def codes(shape):
                return torch.as_tensor(rng.integers(-127, 128, shape),
                                       dtype=torch.int8).to(dev)
            pool = pool._replace(
                k_scale=torch.ones_like(pool.k_scale),
                v_scale=torch.ones_like(pool.v_scale),
                k_pages=codes(tuple(pool.k_pages.shape)),
                v_pages=codes(tuple(pool.v_pages.shape)))
            table = torch.as_tensor(
                1 + np.arange(batch * npp).reshape(batch, npp),
                dtype=torch.int32).to(dev)
            t_paged = timeit(
                lambda pl, qq, kk, vv, p: attn.decode_attend_paged(
                    pl, table, qq, kk, vv, p, window=-1, scale=scale)[1],
                pool, q, k, v, cur)
            # FC term: every compressed projection leaf, layer-0 view x L
            t_fc = 0.0
            for leaf in leaves(eng.params["layers"]):
                if isinstance(leaf, sfc.CompressedFC):
                    lay = tune._layer0_view(leaf)
                    x = normal(batch, lay.shape[1])
                    t_fc += timeit(lambda xx: sfc.apply_fc(lay, xx), x) \
                        * cfg.n_layers
                elif isinstance(leaf, torch.Tensor) and leaf.ndim == 3:
                    w = leaf[0]                     # raw [L, d_in, d_out]
                    x = normal(batch, w.shape[0])
                    t_fc += timeit(torch.matmul, x, w) * cfg.n_layers
        a_full, a_paged = t_full * cfg.n_layers, t_paged * cfg.n_layers
        return {"attn_us_full": round(a_full * 1e6, 1),
                "attn_us_paged": round(a_paged * 1e6, 1),
                "fc_us": round(t_fc * 1e6, 1),
                "full": round(a_full / max(a_full + t_fc, 1e-12), 4),
                "paged": round(a_paged / max(a_paged + t_fc, 1e-12), 4)}

    def serving_benchmark(self, mode: str = "aida", density: float = 0.25,
                          chunk: int = 8, page_size: int = 8,
                          max_len: int = 64) -> dict:
        """What the scheduler buys, measured on one compressed mode, in
        four sub-benches (the step-count facts are deterministic; the
        wall-clock numbers are the host-noisy trajectory):

        * ``prefill`` — model calls to first token for one long prompt,
          chunked vs token by token (the ceil(P/C)+1 bound);
        * ``throughput`` — heterogeneous continuous batching (poisson
          arrivals, mixed lengths): tok/s, goodput, TTFT/TPOT p50-p99;
        * ``prefix`` — shared-prefix workload through the prefix cache:
          page hits and zero-leak drain;
        * ``preemption`` — a pool sized below the workload's worst case:
          completes by youngest-first preemption instead of OutOfPages.
        """
        import math

        from repro_torch import sched as schd
        from repro_torch.kernels import tune
        cfg = self.cfg
        if cfg is None or cfg.family == "rwkv6":
            raise CapabilityError(
                "serving_benchmark needs a paged-KV arch (rwkv6 is "
                "attention-free)")
        seen_tiles = set(tune.snapshot())
        eng = self._inner(mode, density)
        out = {"mode": mode, "chunk": chunk, "page_size": page_size,
               "policy": "fifo"}

        def run_session(arrivals, *, slots=4, pool=None, sched_cfg=None):
            sess = eng.session(batch_slots=slots, max_len=max_len,
                               kv_cache="paged", page_size=page_size,
                               kv_pool_pages=pool, scheduler=sched_cfg)
            self._sync()
            t0 = time.perf_counter()
            res = sess.run_workload(arrivals)
            self._sync()
            return sess, res, time.perf_counter() - t0

        # first launches at the prefill section's batch shape, so that the
        # recorded TTFT measures scheduling, not library loads
        run_session([(0, Request(prompt=[1] * (chunk + 1), max_new=1,
                                 rid=-1))],
                    slots=2, sched_cfg={"chunk": chunk})

        # --- chunked prefill: calls to first token, long prompt --------
        plen = 3 * chunk
        prompt = [1 + (i % (cfg.vocab - 1)) for i in range(plen)]
        pf = {"prompt_len": plen,
              "bound_calls": math.ceil(plen / chunk) + 1}
        for label, c in (("chunked", chunk), ("one_token", 1)):
            sess, _, _ = run_session(
                [(0, Request(prompt=list(prompt), max_new=4, rid=0))],
                slots=2, sched_cfg={"chunk": c})
            rec = sess.records[0]
            pf[label] = {
                "first_token_calls":
                    rec["first_token_step"] - rec["admit_step"],
                "ttft_s": round(rec["first_token_time"]
                                - rec["submit_time"], 4)}
        out["prefill"] = pf
        # the paged decode and chunk winners these sessions tuned
        snap = tune.snapshot()
        out["tiles"] = {k: v for k, v in snap.items()
                        if k not in seen_tiles}

        # --- heterogeneous continuous batching (best of 3) -------------
        wl = schd.WorkloadSpec.preset(
            "heterogeneous", n_requests=10, vocab=cfg.vocab, seed=0)
        best = None
        for _ in range(3):
            sess, _, dt = run_session(schd.generate(wl),
                                      sched_cfg={"chunk": chunk})
            summ = schd.summarize(sess.records, dt, sess.stats["steps"])
            if best is None or summ["tok_per_s"] > best["tok_per_s"]:
                best = summ
        out["throughput"] = best

        # --- shared-prefix page reuse ----------------------------------
        wl = schd.WorkloadSpec.preset(
            "shared-prefix", n_requests=6, vocab=cfg.vocab, seed=1)
        sess, res, _ = run_session(
            schd.generate(wl),
            sched_cfg={"chunk": chunk, "prefix_cache": True})
        cache = sess.prefix
        out["prefix"] = {
            "requests": len(res),
            "page_hits": sess.stats["prefix_pages_reused"],
            "cache": cache.stats(),
            "pages_leaked": sess.alloc.in_use - cache.pages,
        }
        cache.clear(sess.alloc)
        out["prefix"]["pages_leaked_after_clear"] = sess.alloc.in_use

        # --- preemption under page pressure ----------------------------
        reqs = [(0, Request(prompt=[2 + i] * page_size,
                            max_new=2 * page_size, rid=i))
                for i in range(6)]
        need = schd.page_need(page_size, 2 * page_size, max_len, page_size)
        sess, res, _ = run_session(reqs, slots=3, pool=1 + 3 * need - 2,
                                   sched_cfg={"chunk": chunk})
        out["preemption"] = {
            "requests": len(reqs), "completed": len(res),
            "preemptions": sess.stats["preemptions"],
            "pages_leaked": sess.alloc.in_use,
        }
        return out

    def disagg_benchmark(self, mode: str = "aida", density: float = 0.25,
                         chunk: int = 8, page_size: int = 8,
                         max_len: int = 64, n_requests: int = 12) -> dict:
        """Disaggregated prefill / decode against the co-located engine on
        the same ``burst`` workload (the arrival pattern disaggregation
        exists for: a burst of prompts stalls a co-located batch's
        decoders).  The deterministic facts: token parity between the two
        engine shapes, handoffs, zero pages leaked on any allocator; TTFT
        p99 and tok/s are the wall-clock trajectory."""
        from repro_torch import sched as schd
        cfg = self.cfg
        if cfg is None or not schd.supports_chunked_prefill(cfg):
            raise CapabilityError(
                "disagg_benchmark needs an arch whose per-request state "
                "is entirely KV pages (sched.supports_chunked_prefill)")
        eng = self._inner(mode, density)
        wl = schd.WorkloadSpec.preset("burst", n_requests=n_requests,
                                      vocab=cfg.vocab, seed=0)
        arrivals = schd.generate(wl)

        def replay():
            return [(t, Request(prompt=list(r.prompt), max_new=r.max_new,
                                rid=r.rid)) for t, r in arrivals]

        # matched slot widths: the comparison isolates role separation
        # itself (decoders never hold prompt-admission slots), not a
        # capacity difference
        sched_cfg = {"chunk": chunk}
        dcfg = {"prefill_slots": 4, "decode_slots": 4}
        out = {"mode": mode, "chunk": chunk, "workload": "burst",
               "requests": n_requests}
        # first launches of both engine shapes, so TTFT measures scheduling
        for dis in (None, dict(dcfg)):
            s = eng.session(max_len=max_len, kv_cache="paged",
                            page_size=page_size, scheduler=sched_cfg,
                            disagg=dis)
            s.submit(Request(prompt=[1] * (chunk + 1), max_new=2, rid=-1))
            s.run()
        for label, dis in (("colocated", None), ("disagg", dict(dcfg))):
            best = None
            for _ in range(3):
                sess = eng.session(batch_slots=4, max_len=max_len,
                                   kv_cache="paged", page_size=page_size,
                                   scheduler=sched_cfg, disagg=dis)
                self._sync()
                t0 = time.perf_counter()
                res = sess.run_workload(replay())
                self._sync()
                dt = time.perf_counter() - t0
                if dis is None:
                    summ = schd.summarize(sess.records, dt,
                                          sess.stats["steps"])
                    leaked = sess.alloc.in_use
                else:
                    summ = schd.summarize(
                        sess.records, dt,
                        sess.pre.stats["steps"] + sess.dec.stats["steps"],
                        roles=sess.role_stats())
                    leaked = sess.pre.alloc.in_use + sess.dec.alloc.in_use
                summ["pages_leaked"] = leaked
                summ["tokens_by_rid"] = {r.rid: r.tokens for r in res}
                if best is None or (summ["tok_per_s"] or 0) > \
                        (best["tok_per_s"] or 0):
                    best = summ
            out[label] = best
        out["token_parity"] = \
            out["colocated"].pop("tokens_by_rid") == \
            out["disagg"].pop("tokens_by_rid")
        return out

    def resil_benchmark(self, mode: str = "aida", density: float = 0.25,
                        chunk: int = 8, page_size: int = 8,
                        max_len: int = 64, n_requests: int = 8,
                        seed: int = 0) -> dict:
        """The burst workload through the disaggregated engine under every
        built-in FaultPlan preset, against a fault-free run.  The
        deterministic facts: every request completes, completed token
        streams equal the fault-free run's, zero pages leak on either
        role's allocator, and the shed / retry / deadline-miss / fault
        counters are identical across two replays of the same ``(seed,
        preset)``; the goodput ratio against the clean run is the
        wall-clock trajectory."""
        from repro_torch import sched as schd
        cfg = self.cfg
        if cfg is None or not schd.supports_chunked_prefill(cfg):
            raise CapabilityError(
                "resil_benchmark drives the disaggregated engine; it "
                "needs an arch whose per-request state is entirely KV "
                "pages (sched.supports_chunked_prefill)")
        eng = self._inner(mode, density)
        wl = schd.WorkloadSpec.preset("burst", n_requests=n_requests,
                                      vocab=cfg.vocab, seed=0)
        arrivals = schd.generate(wl)

        def replay():
            return [(t, Request(prompt=list(r.prompt), max_new=r.max_new,
                                rid=r.rid)) for t, r in arrivals]

        sched_cfg = {"chunk": chunk}
        dcfg = {"prefill_slots": 2, "decode_slots": 4}

        def run(resil):
            sess = eng.session(max_len=max_len, kv_cache="paged",
                               page_size=page_size, scheduler=sched_cfg,
                               disagg=dict(dcfg), resil=resil)
            self._sync()
            t0 = time.perf_counter()
            res = sess.run_workload(replay(), on_incomplete="warn")
            self._sync()
            dt = time.perf_counter() - t0
            n_tok = sum(len(r.tokens) for r in res)
            counters = None
            if resil is not None:
                s = sess.resil_summary()
                counters = {k: s.get(k, 0) for k in
                            ("deadline_miss", "shed", "retries", "failed",
                             "fault_steps", "handoff_fallbacks")}
                counters["faults"] = s.get("faults", {})
            return {"tokens_by_rid": {r.rid: r.tokens for r in res},
                    "completed": len(res),
                    "failed": sorted(f.rid for f in sess.failed),
                    "tok_per_s": round(n_tok / dt, 2) if dt > 0 else None,
                    "pages_leaked": sess.pre.alloc.in_use
                    + sess.dec.alloc.in_use,
                    "counters": counters}

        # first launches once, so wall-clock ratios measure scheduling
        # under faults
        warm = eng.session(max_len=max_len, kv_cache="paged",
                           page_size=page_size, scheduler=sched_cfg,
                           disagg=dict(dcfg))
        warm.submit(Request(prompt=[1] * (chunk + 1), max_new=2, rid=-1))
        warm.run()
        del warm
        clean = run(None)
        out = {"mode": mode, "workload": "burst", "requests": n_requests,
               "seed": seed,
               "clean": {"completed": clean["completed"],
                         "tok_per_s": clean["tok_per_s"],
                         "pages_leaked": clean["pages_leaked"]},
               "presets": {}}
        for preset in ("drop-handoff", "role-stall", "page-spike",
                       "straggler"):
            rcfg = {"fault_plan": f"{preset}:{seed}", "max_retries": 2,
                    "watchdog_every": 4}
            a = run(dict(rcfg))
            b = run(dict(rcfg))   # the replay: counters must be identical
            parity = all(clean["tokens_by_rid"].get(rid) == toks
                         for rid, toks in a["tokens_by_rid"].items())
            out["presets"][preset] = {
                "completed": a["completed"],
                "failed": a["failed"],
                "token_parity": parity,
                "pages_leaked": a["pages_leaked"],
                "deterministic": (a["counters"] == b["counters"]
                                  and a["tokens_by_rid"]
                                  == b["tokens_by_rid"]),
                "counters": a["counters"],
                "goodput_vs_clean": (
                    round(a["tok_per_s"] / clean["tok_per_s"], 3)
                    if a["tok_per_s"] and clean["tok_per_s"] else None),
            }
        return out

    def capacity_benchmark(self, workload="burst", n_requests: int = 8,
                           sweep: Optional[Sequence[dict]] = None,
                           slo=None, page_size: int = 8,
                           max_len: int = 64, max_steps: int = 4000,
                           seed: int = 0) -> dict:
        """Trace-driven capacity planning in single-engine form ("how
        many slots and pages serve this traffic at p99 < X?").

        Replays one workload (a preset name or a ``sched.WorkloadSpec``,
        e.g. ``WorkloadSpec.from_trace`` of a recorded serve) across a
        sweep of ``(slots, kv_pool_pages, chunk, policy)`` configs on
        this engine, folds each run's trace through `obs.analyze`, and
        names the smallest config meeting ``slo`` (smallest = first in
        ascending (slots, kv_pool_pages, chunk, policy) order).

        Everything in the section counts ticks, so it is deterministic:
        no wall-clock numbers, and the chosen config is run again to
        check that its ``TraceReport`` replays byte for byte."""
        import warnings

        from repro_torch import sched as schd
        from repro_torch.obs import Tracer
        from repro_torch.obs.analyze import PHASES, SLOSpec, analyze
        if slo is None:
            slo = CAPACITY_SLO
        if isinstance(slo, str):
            slo = SLOSpec.parse(slo)
        if isinstance(workload, schd.WorkloadSpec):
            wl, wl_name = workload, \
                ("trace" if workload.schedule is not None else "spec")
        else:
            wl_name = workload
            wl = schd.WorkloadSpec.preset(
                workload, n_requests=n_requests,
                vocab=self.cfg.vocab if self.cfg else 256, seed=seed)
        arrivals = schd.generate(wl)
        if sweep is None:
            sweep = [dict(c) for c in CAPACITY_SMOKE_SWEEP]

        def norm(c: dict) -> dict:
            return {"slots": int(c.get("slots", 4)),
                    "kv_pool_pages": c.get("kv_pool_pages"),
                    "chunk": int(c.get("chunk", 8)),
                    "policy": c.get("policy", "fifo")}

        def key(c: dict):
            # fewest slots, then smallest pool (None = the session's
            # default, the largest), then chunk, then policy name
            pool = c["kv_pool_pages"]
            return (c["slots"], pool if pool is not None else 10 ** 9,
                    c["chunk"], c["policy"])

        def label(c: dict) -> str:
            return (f"slots={c['slots']},pages={c['kv_pool_pages']},"
                    f"chunk={c['chunk']},policy={c['policy']}")

        def run(c: dict):
            tracer = Tracer()
            sess = self.session(
                batch_slots=c["slots"], max_len=max_len,
                kv_cache="paged", page_size=page_size,
                kv_pool_pages=c["kv_pool_pages"],
                scheduler={"chunk": c["chunk"], "policy": c["policy"]},
                obs=tracer)
            replay = [(t, Request(prompt=list(r.prompt),
                                  max_new=r.max_new, rid=r.rid))
                      for t, r in arrivals]
            with warnings.catch_warnings():
                # an under-provisioned point should fail its SLO, not
                # crash or warn: partial completion is data here
                warnings.simplefilter("ignore")
                sess.run_workload(replay, max_steps=max_steps,
                                  on_incomplete="warn")
            return analyze(tracer, slo=slo)

        configs = sorted((norm(c) for c in sweep), key=key)
        out = {"workload": wl_name, "requests": wl.n_requests,
               "seed": seed, "page_size": page_size,
               "slo": slo.describe(),
               "order": "ascending (slots, kv_pool_pages, chunk, policy)",
               "sweep": [], "chosen": None}
        reports = {}
        for c in configs:
            rep = run(c)
            lbl = label(c)
            reports[lbl] = (c, rep)
            completed = sum(1 for r in rep.requests.values()
                            if r["outcome"] == "completed")
            out["sweep"].append({
                "config": c, "label": lbl,
                "slo_pass": rep.slo["pass"],
                "metrics": rep.slo["metrics"],
                "requests": len(rep.requests), "completed": completed,
                "span_ticks": rep.ticks["span"],
                "critical_path_ticks": {
                    p: rep.critical_path[p]["ticks"] for p in PHASES},
                "segments_ok": rep.segments_consistent(),
            })
            if out["chosen"] is None and rep.slo["pass"]:
                out["chosen"] = lbl
        # the replay gate: the named config's report must be a pure
        # function of (workload, config) — run it again, compare the bytes
        probe = out["chosen"] or (out["sweep"][0]["label"]
                                  if out["sweep"] else None)
        if probe is not None:
            c, rep = reports[probe]
            out["deterministic_replay"] = \
                run(c).to_json() == rep.to_json()
        else:
            out["deterministic_replay"] = False
        return out

    def benchmark(self, modes: Sequence[str] = ("dense", "aida"),
                  requests: int = 4, max_new: int = 8,
                  batch_slots: int = 2, density: float = 0.25,
                  problem: Optional[FCProblem] = None,
                  kv_mode: Optional[str] = "aida") -> dict:
        """Serve each mode through the facade and price the cost-model
        backends on one FC instance; returns a JSON-ready dict.  On an
        attention arch it adds the ``kv`` and ``serving`` sections, and
        where chunked prefill is supported ``disagg``, ``resil`` and
        ``capacity``.  Every mode, section and estimate runs on this
        engine's device; each mode's engine is dropped when it is done,
        so one compressed copy is alive at a time."""
        import numpy as np

        from repro_torch import sched as schd
        from repro_torch.kernels import tune
        from repro_torch.obs import provenance
        out = {
            # the run's provenance rides at the top, so a report names the
            # setup that produced it (torch, CUDA, the card and its limit)
            "provenance": provenance(
                config=getattr(self.cfg, "name", None),
                mode=",".join(modes), seed=self._seed,
                backend=self.backend.name, device=self.device),
            "backends": {}, "modes": {}}
        reqs = [Request(prompt=[1, 2 + i % 7, 3], max_new=max_new, rid=i)
                for i in range(requests)]
        # winners already cached were tuned by earlier sessions, not by
        # this benchmark: attribute only new ones
        seen_tiles = set(tune.snapshot())
        for mode in modes:
            eng = self._inner(mode, density)
            sess = eng.session(batch_slots=batch_slots,
                               max_len=max_new + 8)
            sess.submit(Request(prompt=[1], max_new=1, rid=-1))
            sess.run()  # first launches (library loads, handles)
            sess.results.clear()
            # best of 3 passes: one load spike on a shared host can halve
            # a mode's tok/s; (dt, n_tok) travel as a pair, the fastest
            # pass's own token count
            dt, n_tok = float("inf"), 0
            for _ in range(3):
                for r in reqs:
                    sess.submit(r)
                self._sync()
                t0 = time.perf_counter()
                res = sess.run()
                self._sync()
                pass_dt = time.perf_counter() - t0
                pass_tok = sum(len(r.tokens) for r in res)
                sess.results.clear()
                if pass_tok / pass_dt > (n_tok / dt if n_tok else 0.0):
                    dt, n_tok = pass_dt, pass_tok
            # the winners the tuner picked for this mode's shapes, so the
            # trajectory is reproducible
            snap = tune.snapshot()
            tiles = {k: v for k, v in snap.items() if k not in seen_tiles}
            seen_tiles.update(snap)
            out["modes"][mode] = {
                "backend": eng.backend.name,
                "tokens": n_tok, "seconds": round(dt, 4),
                "tok_per_s": round(n_tok / dt, 2),
                "tiles": tiles,
                "compression_ratio": (round(eng.stats["ratio"], 2)
                                      if eng.stats else 1.0)}
            del eng, sess
        if kv_mode is not None and self.cfg.family != "rwkv6":
            out["kv"] = self.kv_benchmark(mode=kv_mode,
                                          batch_slots=batch_slots,
                                          density=density)
            out["serving"] = self.serving_benchmark(mode=kv_mode,
                                                    density=density)
            if schd.supports_chunked_prefill(self.cfg):
                out["disagg"] = self.disagg_benchmark(mode=kv_mode,
                                                      density=density)
                out["resil"] = self.resil_benchmark(mode=kv_mode,
                                                    density=density)
                # ticks depend only on scheduling, not on the kernels, so
                # the uncompressed engine (self) serves the sweep
                out["capacity"] = self.capacity_benchmark()
        if problem is None:
            rng = np.random.default_rng(0)
            w = rng.integers(-15, 16, size=(24, 32)) \
                * (rng.random((24, 32)) < 0.3)
            b = rng.integers(-15, 16, size=(32,)) * (rng.random(32) < 0.6)
            problem = FCProblem(w=w, b=b, m=4, n=4)
        emu = self.estimate(backend="ap-emulator", workload=problem)
        sim = self.estimate(backend="cycle-sim", workload=problem)
        alex = self.estimate(backend="cycle-sim", workload="alexnet-fc")
        eie = self.estimate(backend="cycle-sim", workload="alexnet-fc",
                            simulator="eie")
        out["backends"]["ap-emulator"] = {
            "fc_cycles": int(emu["cycles"]), "exact": emu["exact"]}
        out["backends"]["cycle-sim"] = {
            "fc_cycles": int(sim["cycles"]),
            "agrees_with_emulator": int(sim["cycles"]) == int(emu["cycles"]),
            "alexnet_fc_cycles": int(alex["cycles"]),
            "alexnet_fc_inf_per_s": round(alex["inf_per_s"], 1),
            "eie_alexnet_fc_cycles": int(eie["cycles"]),
            "eie_alexnet_fc_inf_per_s": round(eie["inf_per_s"], 1)}
        return out

