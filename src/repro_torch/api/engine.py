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
