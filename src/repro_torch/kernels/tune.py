"""Per-geometry kernel autotuner — launch-plan search and winner cache for
K1–K5.

Decode shapes are few and static, so the right launch parameters can be
searched *once per geometry* on real timings and read back by the
launchers at every launch:

  acsr / aida   (sy, nsplit)   — K1's split of the slot axis
                                 (`acsr_spmv.split_plan`): threads of a
                                 row, and slot ranges summed apart
  int8 / lut    ksplit         — K4 / K5's split of K (`fc_tile.split_plan`)
  paged-attn    range          — keys of one range of K2 / K3's split plan
  paged-attn-chunk  qt         — K3's queries a block
  block_rows    — encode-time row-block height (searched at compress time
                  when REPRO_TUNE_BLOCK_ROWS=1; re-encodes per candidate)

`Engine.session()` calls :func:`tune_params` and :func:`tune_paged` (and
:func:`tune_paged_chunk` when it chunks) before it builds the session, on
the card, so every geometry the session launches has its winner before
the first step.  :func:`snapshot` gives the winners as JSON.

A key holds nothing that would make a row's bits depend on its batch: no
batch width, row count, chunk or table width enters K1's, K4 / K5's or
the paged range's key, so a column, a row or a query gets the same bits
alone, among others, at C = 1 and in a chunk.  (K3's ``qt`` changes no
query's bits and is keyed per chunk.)  A winner never changes once
recorded: :func:`record` on a key that has one raises.

The cache is process-global.  The tuner's own launches are counted in
:data:`launches` (by the kernels line's names) and taken back out of the
wrappers' counts, so a serve's exact launch counts do not see them.
Tuning runs only on the card: the plain versions have no launch
parameters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.api import env

Key = Tuple


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One point in a kernel's launch-parameter space."""
    impl: str = "cuda"
    tiles: Tuple[Tuple[str, int], ...] = ()
    us: float = float("nan")          # measured microseconds (best run)

    def tile(self, name: str, default: Optional[int] = None) -> Optional[int]:
        return dict(self.tiles).get(name, default)

    def to_json(self) -> dict:
        d = {"impl": self.impl, **dict(self.tiles)}
        if math.isfinite(self.us):
            d["us"] = round(self.us, 1)
        return d


_CACHE: Dict[Key, KernelChoice] = {}
#: the candidates under trial, innermost last, which the launchers take
#: over the cache while they run: (key, choice)
_TRIAL: List[Tuple[Key, KernelChoice]] = []
#: the tuner's own launches, by the kernels line's names
launches: Dict[str, int] = {}


def get(key: Key) -> Optional[KernelChoice]:
    return _CACHE.get(key)


def record(key: Key, choice: KernelChoice) -> None:
    """Cache ``choice`` as ``key``'s winner; a key's winner never changes,
    so recording one that has a winner raises (tests reset with
    :func:`clear`)."""
    if key in _CACHE:
        raise ValueError(f"tune key {key} already has a winner "
                         f"{_CACHE[key].to_json()}")
    _CACHE[key] = choice


def clear() -> None:
    _CACHE.clear()


def snapshot() -> dict:
    """JSON-ready view of every tuned winner (key -> impl/tiles/us)."""
    return {"/".join(str(p) for p in key): choice.to_json()
            for key, choice in sorted(_CACHE.items(),
                                      key=lambda kv: str(kv[0]))}


def enabled() -> bool:
    return env.AUTOTUNE


def tunable(device) -> bool:
    """Whether launches on ``device`` have plans to tune: the card's
    kernels do, the plain versions (CPU tensors) have none."""
    return torch.device(device).type == "cuda"


def _sms(device) -> int:
    from repro_torch.kernels import build
    return build.sm_count(device)


def lookup(key: Key) -> Optional[KernelChoice]:
    """The choice a launch of ``key``'s geometry takes: the candidate under
    trial for that key, else the recorded winner, else None (the
    launcher's own default plan)."""
    for k, choice in reversed(_TRIAL):
        if k == key:
            return choice
    return _CACHE.get(key)


# ------------------------------------------------------------------- keys
def acsr_key(nblocks: int, rmax: int, block_rows: int, k: int, coded: bool,
             sms: int) -> Key:
    return ("aida" if coded else "acsr", nblocks, rmax, block_rows, k, sms)


def fc_key(mode: str, n: int, k: int, sms: int) -> Key:
    """K4 (``mode`` "int8") / K5 ("codebook4") over n channels, K deep."""
    return (mode, n, k, sms)


def paged_key(hkv: int, group: int, d_head: int, page_size: int,
              quantized: bool, sms: int) -> Key:
    """K2 / K3's range: one per attention geometry, for both kernels."""
    return ("paged-attn", hkv, group, d_head, page_size,
            "q8" if quantized else "bf16", sms)


def paged_chunk_key(hkv: int, group: int, d_head: int, page_size: int,
                    chunk: int, quantized: bool, sms: int) -> Key:
    """K3's query tile at one chunk width."""
    return ("paged-attn-chunk", hkv, group, d_head, page_size, chunk,
            "q8" if quantized else "bf16", sms)


# ------------------------------------------------------------- candidates
def acsr_candidates(nblocks: int, rmax: int, block_rows: int,
                    sms: int) -> List[KernelChoice]:
    """K1's splits: today's `split_plan` first, then ranges aimed at 1 and
    4 blocks an SM beside its 2, each at today's threads a row (sy) and
    at half and twice it where a block keeps 32–512 threads."""
    from repro_torch.kernels import acsr_spmv as sp
    sy0 = sp.split_plan(nblocks, rmax, block_rows, sms)[0]
    cands: List[KernelChoice] = []
    for sy in (sy0, sy0 // 2, sy0 * 2):
        if sy < 1 or not 32 <= block_rows * sy <= 512:
            continue
        for per_sm in (sp.BLOCKS_PER_SM, 1, 4):
            aim = max(1, min(sp.cdiv(per_sm * sms, nblocks),
                             sp.cdiv(rmax, 4 * sy)))
            nsplit = sp.plan_of(rmax, sy, aim)[1]
            c = KernelChoice("cuda", (("sy", sy), ("nsplit", nsplit)))
            if c not in cands:
                cands.append(c)
    return cands


def fc_candidates(n: int, k: int, sms: int) -> List[KernelChoice]:
    """K4 / K5's K splits at 2 (today), 1 and 4 blocks an SM."""
    from repro_torch.kernels import fc_tile
    cands: List[KernelChoice] = []
    for per_sm in (fc_tile.BLOCKS_PER_SM, 1, 4):
        ksplit = len(fc_tile.aimed_plan(n, k, sms, per_sm))
        c = KernelChoice("cuda", (("ksplit", ksplit),))
        if c not in cands:
            cands.append(c)
    return cands


def _paged_module():
    # the module (the package exports its function of the same name)
    import importlib
    return importlib.import_module("repro_torch.kvstore.paged_attention")


def paged_candidates() -> List[KernelChoice]:
    """The keys of one range: 256 (today), 128 and 512."""
    pa = _paged_module()
    return [KernelChoice("cuda", (("range", r),)) for r in pa.RANGES]


def paged_chunk_candidates(chunk: int, group: int) -> List[KernelChoice]:
    """K3's query tiles: the divisors of the chunk with ``group * qt``
    query rows in a block, today's `query_tile` first."""
    pa = _paged_module()
    qt0 = pa.query_tile(chunk, group)
    qts = [qt0] + [q for q in range(1, chunk + 1) if chunk % q == 0
                   and q * group <= pa.MAX_ROWS and q != qt0]
    return [KernelChoice("cuda", (("qt", q),)) for q in qts]


# ---------------------------------------------------------------- search
def _counted():
    """The wrappers whose launches the tuner takes back out, by the
    kernels line's names."""
    from repro_torch.kernels.acsr_spmv import spmv_gather, spmv_wide
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.lut_matmul import lut_matmul
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    return {"acsr_spmv_gather": spmv_gather, "acsr_spmv_wide": spmv_wide,
            "int8_matmul": int8_matmul, "lut_matmul": lut_matmul,
            "paged_attention_decode": paged_attention,
            "paged_attention_chunk": paged_attention_chunk}


@contextlib.contextmanager
def counted_apart():
    """Launches inside the block count in :data:`launches`, not in the
    wrappers' own counts."""
    fns = _counted()
    before = {name: f.launches for name, f in fns.items()}
    try:
        yield
    finally:
        for name, f in fns.items():
            n = f.launches - before[name]
            if n:
                launches[name] = launches.get(name, 0) + n
                f.launches = before[name]


@contextlib.contextmanager
def trial(key: Key, choice: KernelChoice):
    """Launches of ``key``'s geometry inside the block take ``choice``
    (counted apart)."""
    _TRIAL.append((key, choice))
    try:
        with counted_apart():
            yield
    finally:
        _TRIAL.pop()


def autotune(key: Key, candidates: Sequence[KernelChoice],
             runner: Callable[[KernelChoice], object], *,
             reps: int = 3, inner: int = 3,
             reduce: Optional[Callable[[List[float]], List[float]]] = None
             ) -> KernelChoice:
    """Time each candidate (1 warmup, then ``reps`` samples of ``inner``
    back-to-back calls, best sample) and cache the winner under ``key``.
    Sub-ms kernels need the inner loop — single-call samples are noise on
    a busy host and a wrong pick taxes every decode step afterwards.
    Candidates that fail to run are skipped; an already-cached key returns
    immediately; when nothing ran a no-op marker (no tiles: the
    launcher's default) is recorded so the search is not repeated.
    ``reduce``: maps the candidates' seconds (inf where one failed) to the
    seconds the winner is picked by — a mesh's MAX over its ranks, so
    every rank records the same winner."""
    from repro_torch.obs import timeit
    cached = get(key)
    if cached is not None:
        return cached
    secs = []
    for cand in candidates:
        try:
            with trial(key, cand):
                secs.append(timeit(runner, cand, reps=reps, inner=inner))
        except Exception:
            secs.append(float("inf"))
    if reduce is not None:
        secs = list(reduce(secs))
    best: Optional[KernelChoice] = None
    for cand, t in zip(candidates, secs):
        if not math.isfinite(t):
            continue
        timed = dataclasses.replace(cand, us=t * 1e6)
        if best is None or timed.us < best.us:
            best = timed
    if best is None:  # nothing ran — record a no-op marker so we don't loop
        best = KernelChoice("cuda")
    record(key, best)
    return best


# ------------------------------------------------------- layer-level entry
def _weights(layer) -> torch.Tensor:
    """A compressed leaf's main array (its device and whether it is
    stacked show there)."""
    return {"dense": lambda c: c.dense, "int8": lambda c: c.qt.q,
            "codebook4": lambda c: c.codes_packed,
            "acsr": lambda c: c.blocked.values,
            "aida": lambda c: c.blocked.values}[layer.mode](layer)


def _layer0_view(layer):
    """A single-layer view of a (possibly [L, ...]-stacked) CompressedFC:
    layer 0 of the stack (every layer of a stack has one slot depth)."""
    ndims = {"dense": 2, "int8": 2, "codebook4": 2, "acsr": 3, "aida": 3}
    return layer.layer(0) if _weights(layer).dim() > ndims[layer.mode] \
        else layer


def _fc_key_of(lay, sms: int, split: Optional[int] = None) -> Key:
    """The key a launch of single-layer sparse, int8 or codebook4 leaf
    ``lay`` looks up (``split``: on a band, the whole's row blocks or
    channels)."""
    from repro_torch.core import sparse_fc as sfc
    if lay.mode in ("acsr", "aida"):
        b = lay.blocked
        return acsr_key(split or b.nblocks, b.rmax, b.block_rows, b.shape[1],
                        b.centroids is not None, sms)
    return fc_key(lay.mode, split or sfc.stored_rows(lay), lay.shape[1], sms)


def _fc_candidates_of(lay, key: Key, sms: int) -> List[KernelChoice]:
    if lay.mode in ("acsr", "aida"):
        return acsr_candidates(key[1], lay.blocked.rmax,
                               lay.blocked.block_rows, sms)
    return fc_candidates(key[1], lay.shape[1], sms)


def _fc_runner(lay, batch: int, chunk: int, split: Optional[int]):
    """Runs ``lay`` once at ``batch`` rows and, when the session chunks,
    once at ``batch * chunk`` (K1: its gather and its wide variant)."""
    from repro_torch.core import sparse_fc as sfc
    gen = torch.Generator(device=_weights(lay).device).manual_seed(0)
    widths = [batch] + ([batch * chunk] if chunk > 1 else [])
    xs = [torch.randn(w, lay.shape[1], generator=gen, device=gen.device)
          for w in widths]

    def run(_choice):
        return [sfc.apply_fc(lay, x, split=split) for x in xs]
    return run


def tune_layer(layer, batch: int, chunk: int = 1, *,
               split: Optional[int] = None,
               reduce=None) -> Optional[KernelChoice]:
    """Search the launch plan of one CompressedFC (stacked or single-layer)
    for a session of ``batch`` slots chunking ``chunk`` prompt tokens a
    step: each candidate is timed over one launch at ``batch`` rows and,
    when ``chunk`` > 1, one at ``batch * chunk``.  Returns the winner, or
    None for modes with nothing to tune and for a layer off the card.
    ``split``: for a mesh band, the whole's row geometry its launch
    follows, whose key it looks up (`shard.tune_local_views`); ``reduce``
    as in :func:`autotune`."""
    lay = _layer0_view(layer)
    dev = _weights(lay).device
    if not tunable(dev) or lay.mode == "dense":
        return None
    sms = _sms(dev)
    key = _fc_key_of(lay, sms, split)
    if get(key) is not None:
        return get(key)
    return autotune(key, _fc_candidates_of(lay, key, sms),
                    _fc_runner(lay, batch, chunk, split), reduce=reduce)


def _synthetic_pool(cfg, batch: int, max_len: int, page_size: int,
                    kv_dtype: str, device):
    """A fully-populated pool and its table: every table slot owns a page
    and every position is written — the steady-state gather of a long
    sequence, the worst case a step runs."""
    from repro_torch import kvstore as kvs
    hkv, dh = cfg.n_kv, cfg.head_dim
    npp = -(-max_len // page_size)
    gen = torch.Generator(device=device).manual_seed(0)
    pool = kvs.init_pool(1 + batch * npp, hkv, page_size, dh,
                         kv_dtype=kv_dtype, device=device)
    table = (1 + torch.arange(batch * npp, dtype=torch.int32,
                              device=device)).reshape(batch, npp)
    kv = [torch.randn(batch, hkv, max_len, dh, generator=gen, device=device)
          for _ in range(2)]
    pos = torch.arange(max_len, dtype=torch.int32,
                       device=device).expand(batch, max_len).contiguous()
    kvs.update_chunk(pool, table, kv[0], kv[1], pos)
    return pool, table, gen


def tune_paged(cfg, batch: int, max_len: int, page_size: int,
               kv_dtype: str, device, *,
               reduce=None) -> Optional[KernelChoice]:
    """Search K2 / K3's range for one attention geometry, timed on K2 over
    a synthetic fully-populated pool at ``batch`` rows, each at position
    ``max_len - 1``.  The key has no batch or table width: a query's split
    is its own."""
    from repro_torch import kvstore as kvs
    device = torch.device(device)
    if not tunable(device):
        return None
    sms = _sms(device)
    hkv, dh = cfg.n_kv, cfg.head_dim
    group = cfg.n_heads // hkv
    key = paged_key(hkv, group, dh, page_size, kv_dtype == "int8", sms)
    if get(key) is not None:
        return get(key)
    pool, table, gen = _synthetic_pool(cfg, batch, max_len, page_size,
                                       kv_dtype, device)
    q = torch.randn(batch, cfg.n_heads, dh, generator=gen, device=device)
    cur = torch.full((batch,), max_len - 1, dtype=torch.int32,
                     device=device)

    def run(_choice):
        return kvs.paged_attention(q, pool, table, cur, -1,
                                   scale=cfg.attn_scale,
                                   cap=cfg.attn_softcap)
    return autotune(key, paged_candidates(), run, reduce=reduce)


def tune_paged_chunk(cfg, batch: int, max_len: int, page_size: int,
                     chunk: int, kv_dtype: str, device, *,
                     reduce=None) -> Optional[KernelChoice]:
    """Search K3's query tile for one geometry and chunk width: a [batch,
    H, chunk, Dh] query block at the trailing chunk of ``max_len`` over a
    synthetic fully-populated pool, under the range :func:`tune_paged`
    recorded (or today's)."""
    from repro_torch import kvstore as kvs
    device = torch.device(device)
    if chunk <= 1 or not tunable(device):
        return None
    sms = _sms(device)
    hkv, dh = cfg.n_kv, cfg.head_dim
    group = cfg.n_heads // hkv
    key = paged_chunk_key(hkv, group, dh, page_size, chunk,
                          kv_dtype == "int8", sms)
    if get(key) is not None:
        return get(key)
    pool, table, gen = _synthetic_pool(cfg, batch, max_len, page_size,
                                       kv_dtype, device)
    q = torch.randn(batch, cfg.n_heads, chunk, dh, generator=gen,
                    device=device)
    q_pos = torch.arange(max_len - chunk, max_len, dtype=torch.int32,
                         device=device).expand(batch, chunk).contiguous()

    def run(_choice):
        return kvs.paged_attention_chunk(q, pool, table, q_pos, -1,
                                         scale=cfg.attn_scale,
                                         cap=cfg.attn_softcap)
    return autotune(key, paged_chunk_candidates(chunk, group), run,
                    reduce=reduce)


def _compressed_leaves(params):
    """Every CompressedFC of a params tree (dicts of leaves), in order."""
    from repro_torch.core import sparse_fc as sfc
    if isinstance(params, dict):
        for v in params.values():
            yield from _compressed_leaves(v)
    elif isinstance(params, sfc.CompressedFC):
        yield params


def tune_params(params, batch: int, chunk: int = 1) -> int:
    """Tune every compressed geometry found in a params tree for a session
    of ``batch`` slots chunking ``chunk`` tokens a step.  Returns the
    number of newly tuned cache entries."""
    before = len(_CACHE)
    # no (mode, shape)-level dedupe: same-shape projections can still
    # differ in geometry (rmax varies per weight matrix), and the cache
    # key is the real dedupe — tune_layer returns at once on a key hit
    for leaf in _compressed_leaves(params):
        if leaf.mode != "dense":
            tune_layer(leaf, batch, chunk)
    return len(_CACHE) - before


# --------------------------------------------------- encode-time block_rows
_BLOCK_ROWS_CACHE: Dict[Tuple, int] = {}


def _quantiles(nz: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """numpy's default (linear) quantiles of ``nz`` at ``qs``, by sort."""
    xs = torch.sort(nz.double()).values
    pos = qs.double() * (xs.numel() - 1)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=xs.numel() - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def choose_block_rows(w: torch.Tensor, mode: str, density: float,
                      default: int = 128, batch: int = 2,
                      candidates: Sequence[int] = (64, 128, 256)) -> int:
    """Encode-time search over the row-block height: re-encodes the pruned
    matrix ``w`` [n_out, n_in] per candidate and times `acsr_spmv` on the
    weights' device (K1 on the card, its plain version on the CPU).
    Cached by (shape, mode, density); only consulted when
    REPRO_TUNE_BLOCK_ROWS=1, since re-encoding per candidate is much
    slower than the launch-plan search."""
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.obs import timeit
    key = (tuple(w.shape), mode, density)
    if key in _BLOCK_ROWS_CACHE:
        return _BLOCK_ROWS_CACHE[key]
    gen = torch.Generator(device=w.device).manual_seed(0)
    x = torch.randn(w.shape[1], batch, generator=gen, device=w.device)
    best, best_t = default, float("inf")
    for br in candidates:
        try:
            if mode == "aida":
                # time the coded kernel the real decode will run
                nz = w[w != 0].float()
                cents = (torch.cat([nz.new_zeros(1), _quantiles(
                    nz, torch.linspace(0.02, 0.98, 15,
                                       dtype=torch.float64,
                                       device=w.device)).float()])
                         if nz.numel() else w.new_zeros(16))
                blocked = sp.block_encode_coded(w, cents, block_rows=br)
            else:
                blocked = sp.block_encode(w, block_rows=br)
            # best-of-3 samples of 3 calls (noise floor on a busy host)
            with counted_apart():
                dt = timeit(sp.acsr_spmv, blocked, x, reps=3, inner=3)
        except Exception:
            continue
        if dt < best_t:
            best, best_t = br, dt
    _BLOCK_ROWS_CACHE[key] = best
    return best
