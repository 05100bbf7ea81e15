"""`Engine` — the port's entry point to compress and serve a model::

    from repro_torch.api import Engine, Request, CompressionSpec
    from repro_torch.configs import get

    eng = Engine(get("llama3-8b"))                 # random init, on the card
    eng.compress(CompressionSpec(mode="aida", density=0.25))
    results = eng.serve([Request(prompt=[1, 2, 3], max_new=8)])

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where every kernel takes its plain version).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.api import compress as compress_mod
from repro_torch.api.session import Session
from repro_torch.api.spec import CompressionSpec, Request, Result
from repro_torch.configs.base import ArchConfig


def resolve_device(device) -> torch.device:
    """None -> the first card; raises when no card is visible (the port
    never falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run the plain versions")
        device = "cuda"
    return torch.device(device)


class Engine:
    def __init__(self, cfg: Union[ArchConfig, str, None] = None,
                 params=None, *, device=None, seed: int = 0):
        if isinstance(cfg, str):
            from repro_torch.configs import get
            cfg = get(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # raw f32 products (lm_head) in full f32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
        self._params = params
        self._seed = seed
        self.compression: Optional[CompressionSpec] = None
        self.stats: Optional[dict] = None

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

    def compress(self, spec: Union[CompressionSpec, str, None] = None,
                 *, verbose=None, **kw) -> "Engine":
        """Deep-Compression of every eligible projection per ``spec``
        (keyword shortcuts mode=, density=, k= also work).  Returns self;
        stats land in ``self.stats``."""
        spec = CompressionSpec.coerce(spec)
        if kw:
            spec = dataclasses.replace(spec, **kw)
        with torch.no_grad():
            self._params, self.stats = compress_mod.compress_params(
                self.params, spec, verbose=verbose)
        self.compression = spec
        return self

    def session(self, batch_slots: int = 4, max_len: int = 256,
                seed: int = 0, kv_cache: Optional[str] = None,
                page_size: int = 16, kv_pool_pages: Optional[int] = None,
                kv_dtype: Optional[str] = None, scheduler=None,
                obs=None) -> Session:
        """A continuous-batching serving session on the engine's device.
        ``kv_cache``: None / "auto" (paged wherever there is attention),
        "paged" or "full" (the dense per-slot cache).  ``scheduler``: a
        `sched.SchedConfig` (or dict / policy name): policy, chunk, prefix
        cache.  ``seed`` seeds the sampling draws of
        requests with a temperature.  ``obs``: an `obs.Tracer` for the
        tick-clock event stream (None: untraced)."""
        if self.cfg is None:
            raise ValueError("serving needs an ArchConfig")
        return Session(self.cfg, self.params, batch_slots=batch_slots,
                       max_len=max_len, device=self.device, seed=seed,
                       kv_cache=kv_cache, page_size=page_size,
                       kv_pool_pages=kv_pool_pages, kv_dtype=kv_dtype,
                       scheduler=scheduler, obs=obs)

    def serve(self, requests: Sequence[Union[Request, List[int]]], *,
              batch_slots: int = 4, max_len: int = 256,
              max_steps: int = 10_000, seed: int = 0,
              kv_cache: Optional[str] = None, scheduler=None,
              obs=None) -> List[Result]:
        """Serve a batch of requests to completion (continuous batching);
        results come back in rid order."""
        sess = self.session(batch_slots=batch_slots, max_len=max_len,
                            seed=seed, kv_cache=kv_cache,
                            scheduler=scheduler, obs=obs)
        for rid, req in enumerate(requests):
            if not isinstance(req, Request):
                req = Request(prompt=list(req), rid=rid)
            sess.submit(req)
        return sess.run(max_steps=max_steps)
