"""The port's kernel autotuner (``repro_torch.kernels.tune``) on the CPU:
its search rules against the JAX package's ``repro.kernels.tune`` under
pinned timers in both packages; the call graph of ``Engine._pretune``
against the reference's; the launchers' lookups of recorded winners (and
today's plans without them); a mesh's ranks agreeing on every winner; and
the encode-time ``block_rows`` search against the reference's.  The
kernels themselves run on the card only: ``chip_smoke.py``'s tune phase
holds every candidate against its plain version there."""
import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
import repro.obs as jobs
import repro_torch.obs as tobs
from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import env as jenv
from repro.api import engine as jengine_mod
from repro.api.compress import compress_params as jcompress_params
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine
from repro_torch.api import engine as tengine_mod
from repro_torch.api import env as tenv
from repro_torch.api.compress import compress_params
from repro_torch.configs import get, reduced
from repro_torch.kernels import acsr_spmv as sp
from repro_torch.kernels import build, fc_tile
from repro_torch.kernels import tune
from repro_torch.shard import comm

pa = __import__("importlib").import_module(
    "repro_torch.kvstore.paged_attention")
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
SMS = 132


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both tuners start and end every test with their caches as they
    found them (the port's empty)."""
    saved = dict(jtune._CACHE)
    saved_br = dict(jtune._BLOCK_ROWS_CACHE)
    tune.clear()
    tune._BLOCK_ROWS_CACHE.clear()
    jtune.clear()
    yield
    tune.clear()
    tune._BLOCK_ROWS_CACHE.clear()
    jtune.clear()
    jtune._CACHE.update(saved)
    jtune._BLOCK_ROWS_CACHE.clear()
    jtune._BLOCK_ROWS_CACHE.update(saved_br)


# ------------------------------------------------------- autotune rules
def _pinned(times, ran):
    """A timer for both packages: runs the candidate once (so one that
    raises, raises) and returns its pinned seconds by its "t" tile."""
    def timer(fn, *a, **k):
        fn(*a)
        ran.append(a[0].tile("t"))
        return times[a[0].tile("t")]
    return timer


@pytest.mark.parametrize("times,fails,want", [
    ({0: 3e-6, 1: 1e-6, 2: 2e-6}, (), 1),
    ({0: 3e-6, 1: 1e-6, 2: 2e-6}, (1,), 2),
    ({0: 2e-6, 1: 2e-6, 2: 5e-6}, (), 0),        # a tie: the first wins
    ({0: 1e-6, 1: 1e-6, 2: 1e-6}, (0, 1, 2), None)])
def test_autotune_rules_match_the_reference(monkeypatch, times, fails, want):
    """The same candidates under the same pinned times in both packages:
    the same winner (a raising candidate skipped, a tie to the first),
    its µs, a cache hit on the second call (no candidate runs), and the
    no-op marker (no tiles) when every candidate raises; the snapshot's
    shape is the reference's."""
    jran, tran = [], []
    monkeypatch.setattr(jobs, "timeit", _pinned(times, jran))
    monkeypatch.setattr(tobs, "timeit", _pinned(times, tran))

    def runner(c):
        if c.tile("t") in fails:
            raise RuntimeError("this candidate does not run")
        return None
    key = ("acsr", 4, 40, 128, 64)
    jc = [jtune.KernelChoice("pallas", (("t", i),)) for i in times]
    tc = [tune.KernelChoice("cuda", (("t", i),)) for i in times]
    jw = jtune.autotune(key, jc, runner)
    tw = tune.autotune(key, tc, runner)
    assert tw.tiles == jw.tiles
    assert (tw.tile("t") if tw.tiles else None) == want
    assert np.isnan(tw.us) == np.isnan(jw.us)
    if want is not None:
        assert tw.us == pytest.approx(jw.us) == pytest.approx(
            times[want] * 1e6)
    n = (len(jran), len(tran))
    assert tune.autotune(key, tc, runner) is tw
    assert jtune.autotune(key, jc, runner) is jw
    assert (len(jran), len(tran)) == n          # cached: nothing ran
    js, ts = jtune.snapshot(), tune.snapshot()
    assert list(js) == list(ts) == ["/".join(map(str, key))]
    jj, tj = js[list(js)[0]], ts[list(ts)[0]]
    assert set(jj) == set(tj) and {k: v for k, v in jj.items()
                                   if k != "impl"} == \
        {k: v for k, v in tj.items() if k != "impl"}


def test_a_winner_never_changes():
    """record on a key that has a winner raises; clear() resets."""
    key = tune.acsr_key(32, 1024, 128, 4096, True, SMS)
    tune.record(key, tune.KernelChoice("cuda", (("sy", 4), ("nsplit", 9))))
    with pytest.raises(ValueError, match="already has a winner"):
        tune.record(key, tune.KernelChoice("cuda", (("sy", 2),
                                                    ("nsplit", 9))))
    tune.clear()
    tune.record(key, tune.KernelChoice("cuda", (("sy", 2), ("nsplit", 9))))
    assert tune.get(key).tile("sy") == 2


def test_tuner_launches_are_counted_apart():
    """Launches inside a trial leave the wrappers' counts as they were
    and land in tune.launches."""
    from repro_torch.kernels.acsr_spmv import spmv_gather
    before, tuned = spmv_gather.launches, tune.launches.get(
        "acsr_spmv_gather", 0)
    with tune.trial(("k",), tune.KernelChoice()):
        spmv_gather.launches += 3
    assert spmv_gather.launches == before
    assert tune.launches["acsr_spmv_gather"] == tuned + 3


# ------------------------------------------------------------ the plans
#: (model, [(n_out, n_in)], (H, Hkv, Dh) or None): each served projection
#: shape and paged-attention geometry
GEOMETRIES = [
    ("llama3-8b", [(4096, 4096), (1024, 4096), (14336, 4096),
                   (4096, 14336)], (32, 8, 128)),
    ("hymba-1.5b", [(1600, 1600), (320, 1600), (5504, 1600), (1600, 5504),
                    (3200, 1600)], (25, 5, 64)),
    ("rwkv6-7b", [(4096, 4096), (14336, 4096), (4096, 14336)], None)]


def _todays_k1(nb, rmax, br, sms):
    """K1's split as the launchers planned it before the tuner."""
    sy = max(1, 512 // br)
    nsplit = max(1, min(sp.cdiv(2 * sms, nb), sp.cdiv(rmax, 4 * sy)))
    per = max(1, sp.cdiv(rmax, nsplit))
    return sy, max(1, sp.cdiv(rmax, per)), per


def _todays_fc(n, k, sms):
    """K4 / K5's K ranges as the launcher planned them before the tuner."""
    steps = sp.cdiv(k, 128)
    ksplit = max(1, min(steps, 2 * sms // sp.cdiv(n, 64)))
    per = sp.cdiv(steps, ksplit) * 128
    return tuple((k0, min(k, k0 + per)) for k0 in range(0, k, per))


def _blocked(n_out, n_in, rmax, br=128, coded=True):
    """A shape-only BlockedACSR (meta tensors): what launch_plan reads."""
    nb = sp.cdiv(n_out, br)
    return sp.BlockedACSR(
        values=torch.empty((nb, rmax, br), device="meta"),
        col_idx=torch.empty((nb, rmax, br), dtype=torch.int16,
                            device="meta"),
        row_nnz=torch.empty((nb, br), dtype=torch.int32, device="meta"),
        shape=(n_out, n_in), block_rows=br, nnz=-1,
        centroids=torch.empty(16, device="meta") if coded else None,
        chunk_off=torch.empty((nb, 2, br), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("model,shapes,attn", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_untuned_plans_are_todays(model, shapes, attn):
    """With nothing recorded every launcher plans as before this tuner
    (the formulas restated here): K1's split (whole and band), K4 / K5's
    K ranges, K2 / K3 RANGE_KEYS and `query_tile`; each candidate list
    starts with that plan."""
    for n_out, n_in in shapes:
        for rmax in (8, sp.cdiv(int(0.3 * n_in), 8) * 8, n_in):
            b = _blocked(n_out, n_in, rmax)
            today = _todays_k1(b.nblocks, rmax, 128, SMS)
            assert sp.launch_plan(b, SMS) == today
            assert sp.split_plan(b.nblocks, rmax, 128, SMS) == today
            band = _blocked(n_out // 2, n_in, rmax)
            assert sp.launch_plan(band, SMS, split_nb=b.nblocks) == today
            first = tune.acsr_candidates(b.nblocks, rmax, 128, SMS)[0]
            assert sp.plan_of(rmax, first.tile("sy"),
                              first.tile("nsplit")) == today
        today = _todays_fc(n_out, n_in, SMS)
        for mode in ("int8", "codebook4"):
            assert fc_tile.launch_plan(n_out, n_in, SMS, mode=mode) == today
            assert fc_tile.launch_plan(n_out // 2, n_in, SMS, split_n=n_out,
                                       mode=mode) == today
        k0 = tune.fc_candidates(n_out, n_in, SMS)[0].tile("ksplit")
        assert fc_tile.plan_of(n_in, k0) == today
    if attn is not None:
        h, hkv, dh = attn
        for c in (1, 8):
            for quant in (False, True):
                assert pa.launch_plan(h, hkv, dh, c, 16, quant, SMS) == \
                    (pa.RANGE_KEYS, pa.query_tile(c, h // hkv))
        assert tune.paged_candidates()[0].tile("range") == pa.RANGE_KEYS
        assert tune.paged_chunk_candidates(8, h // hkv)[0].tile("qt") == \
            pa.query_tile(8, h // hkv)


def test_recorded_winners_are_what_every_launch_takes():
    """A recorded K1 winner is the plan of the whole and of a band cut
    from it (`split_nb`), at any x width (no width enters the plan); K4 /
    K5's of the whole and a band (`split_n`), for its mode only; the paged
    range of K2 and K3 alike and K3's query tile at its chunk width, for a
    head band too (`split_hkv`)."""
    assert "batch" not in str(tune.acsr_key.__code__.co_varnames)
    b = _blocked(4096, 4096, 1120)
    key = tune.acsr_key(b.nblocks, 1120, 128, 4096, True, SMS)
    tune.record(key, tune.KernelChoice("cuda", (("sy", 2), ("nsplit", 5))))
    want = sp.plan_of(1120, 2, 5)
    assert want != sp.split_plan(b.nblocks, 1120, 128, SMS)
    assert sp.launch_plan(b, SMS) == want
    assert sp.launch_plan(_blocked(2048, 4096, 1120), SMS,
                          split_nb=b.nblocks) == want
    acsr = _blocked(4096, 4096, 1120, coded=False)     # another mode
    assert sp.launch_plan(acsr, SMS) == sp.split_plan(b.nblocks, 1120, 128,
                                                      SMS)
    tune.record(tune.fc_key("int8", 1024, 4096, SMS),
                tune.KernelChoice("cuda", (("ksplit", 3),)))
    assert fc_tile.launch_plan(1024, 4096, SMS, mode="int8") == \
        fc_tile.plan_of(4096, 3)
    assert fc_tile.launch_plan(512, 4096, SMS, split_n=1024,
                               mode="int8") == fc_tile.plan_of(4096, 3)
    assert fc_tile.launch_plan(1024, 4096, SMS, mode="codebook4") == \
        fc_tile.split_plan(1024, 4096, SMS)
    tune.record(tune.paged_key(8, 4, 128, 16, False, SMS),
                tune.KernelChoice("cuda", (("range", 128),)))
    tune.record(tune.paged_chunk_key(8, 4, 128, 16, 8, False, SMS),
                tune.KernelChoice("cuda", (("qt", 2),)))
    assert pa.launch_plan(32, 8, 128, 1, 16, False, SMS) == (128, 1)
    assert pa.launch_plan(32, 8, 128, 8, 16, False, SMS) == (128, 2)
    assert pa.launch_plan(16, 4, 128, 8, 16, False, SMS, split_hkv=8) == \
        (128, 2)
    assert pa.launch_plan(32, 8, 128, 8, 16, True, SMS) == \
        (pa.RANGE_KEYS, pa.query_tile(8, 4))
    assert pa.ranges_of(16, 16, 128) == ((0, 128), (128, 256))


def test_candidates_fit_the_kernels():
    """Every candidate the tuner times is one the kernels take: K1's
    block of block_rows * sy threads within 32–512, K4 / K5's ranges whole
    stages of K, the ranges the CUDA source instantiates, and K3's tiles
    dividing the chunk with at most 32 query rows a block."""
    for nb, rmax, br in ((32, 1120, 128), (112, 1120, 128), (13, 2000, 128),
                         (4, 64, 64), (2, 8, 256)):
        cands = tune.acsr_candidates(nb, rmax, br, SMS)
        assert len(cands) == len(set(cands)) >= 2
        for c in cands:
            assert 32 <= br * c.tile("sy") <= 512
            sy, nsplit, per = sp.plan_of(rmax, c.tile("sy"),
                                         c.tile("nsplit"))
            assert nsplit == c.tile("nsplit") and (nsplit - 1) * per < rmax
    for n, k in ((4096, 4096), (1024, 4096), (4096, 14336), (320, 1600)):
        for c in tune.fc_candidates(n, k, SMS):
            plan = fc_tile.plan_of(k, c.tile("ksplit"))
            assert len(plan) == c.tile("ksplit") and plan[-1][1] == k
            assert all(k0 % fc_tile.BK == 0 for k0, _ in plan)
    src = (pathlib.Path(pa.__file__).resolve().parents[1] / "csrc" /
           "paged_attention.cu").read_text()
    assert sorted(build.PAGED_RANGES) == sorted(pa.RANGES)
    for r in pa.RANGES:          # a library a range, built from the source
        name = build.paged_library(r)
        assert name in build.SOURCES
        assert build._source(name) == (
            build.CSRC / "paged_attention.cu",
            () if r == pa.RANGE_KEYS else (f"-DPA_RANGE={r}",))
    assert re.search(r"static_assert\(PA_RANGE == 128 \|\| PA_RANGE == 256 "
                     r"\|\| PA_RANGE == 512", src)
    for chunk in (2, 4, 8, 16):
        for group in (1, 4, 5, 8):
            for c in tune.paged_chunk_candidates(chunk, group):
                assert chunk % c.tile("qt") == 0
                assert c.tile("qt") * group <= pa.MAX_ROWS


# ------------------------------------------------------ _pretune call graph
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
JRWKV = jreduced(jget("rwkv6-7b"), **SMALL)
RWKV = reduced(get("rwkv6-7b"), **SMALL)


@pytest.fixture(scope="module")
def engines():
    """(reference, port) engines per case: llama3-8b and rwkv6-7b aida
    0.25 from the same raw params, and an uncompressed llama3-8b."""
    out = {}
    for name, jcfg, cfg in (("llama", JCFG, CFG), ("rwkv6", JRWKV, RWKV)):
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        raw = bridge.from_reference(jax.tree.map(np.asarray, jp))
        out[name] = (JEngine(jcfg, params=jp).compress(
            JSpec(mode="aida", density=0.25), verbose=None),
            Engine(cfg, params=raw, device="cpu").compress(
                CompressionSpec(mode="aida", density=0.25), verbose=None))
        if name == "llama":
            out["dense"] = (JEngine(jcfg, params=jp),
                            Engine(cfg, params=raw, device="cpu"))
    return out


def _recorders(calls):
    """Stand-ins of the four tune entry points that record their call (the
    arguments both packages share) and tune nothing."""
    def rec(name, keep):
        def f(*a, **k):
            calls.append((name,) + tuple(a[i] for i in keep))
        return f
    return {"tune_params": rec("params", (1,)),
            "tune_paged": rec("paged", (1, 2, 3, 4)),
            "tune_paged_chunk": rec("chunk", (1, 2, 3, 4, 5))}


CALL_CASES = {
    "aida-chunk1": dict(eng="llama", kw=dict(scheduler={"chunk": 1})),
    "aida-chunk8": dict(eng="llama", kw=dict(scheduler={"chunk": 8})),
    "int8-pages": dict(eng="llama", kw=dict(kv_dtype="int8",
                                            scheduler={"chunk": 8})),
    "disagg-2-4": dict(eng="llama", kw=dict(
        disagg={"prefill_slots": 2, "decode_slots": 4},
        scheduler={"chunk": 8})),
    "disagg-4-4": dict(eng="llama", kw=dict(
        disagg={"prefill_slots": 4, "decode_slots": 4})),
    "rwkv6": dict(eng="rwkv6", kw=dict(scheduler={"chunk": 8})),
    "autotune-off": dict(eng="llama", kw=dict(scheduler={"chunk": 8}),
                         off=True),
    "dense": dict(eng="dense", kw=dict(scheduler={"chunk": 8})),
    "full-cache": dict(eng="llama", kw=dict(kv_cache="full"))}


@pytest.mark.parametrize("case", list(CALL_CASES))
def test_pretune_call_graph_matches_the_reference(monkeypatch, engines,
                                                  case):
    """Engine.session() pre-tunes in the same cases, in the same order and
    with the same batch, max_len, page size, chunk and kv dtype as the
    reference's `_pretune`: FC geometries on a compressed engine, the
    paged range on a paged cache (not for rwkv6), the chunk's query tile
    when it chunks, once per role of a disaggregated pair (both when
    their slots differ), nothing with REPRO_AUTOTUNE off.  The sessions
    themselves are not built; the port's device check says "card"."""
    spec = CALL_CASES[case]
    jeng, teng = engines[spec["eng"]]
    if spec.get("off"):
        monkeypatch.setattr(jenv, "AUTOTUNE", False)
        monkeypatch.setattr(tenv, "AUTOTUNE", False)
    jcalls, tcalls = [], []
    for name, f in _recorders(jcalls).items():
        monkeypatch.setattr(jtune, name, f)
    for name, f in _recorders(tcalls).items():
        monkeypatch.setattr(tune, name, f)
    monkeypatch.setattr(tune, "tunable", lambda device: True)
    import repro.disagg as jdisagg
    import repro_torch.disagg as tdisagg
    monkeypatch.setattr(jengine_mod, "Session", lambda *a, **k: None)
    monkeypatch.setattr(tengine_mod, "Session", lambda *a, **k: None)
    monkeypatch.setattr(jdisagg, "DisaggSession", lambda *a, **k: None)
    monkeypatch.setattr(tdisagg, "DisaggSession", lambda *a, **k: None)
    kw = dict(batch_slots=3, max_len=48, page_size=8, **spec["kw"])
    jeng.session(**kw)
    teng.session(**kw)
    assert tcalls == jcalls
    if case == "aida-chunk8":
        assert tcalls == [("params", 3), ("paged", 3, 48, 8, "bf16"),
                          ("chunk", 3, 48, 8, 8, "bf16")]
    if case in ("autotune-off",):
        assert tcalls == []


def test_pretune_on_the_cpu_tunes_nothing(engines):
    """A CPU engine's sessions record no winner (no launch plans)."""
    _, teng = engines["llama"]
    n = len(teng.tune_log)
    teng.session(batch_slots=2, max_len=16, scheduler={"chunk": 4})
    assert tune.snapshot() == {} and len(teng.tune_log) == n


# ------------------------------------------------------ mesh agreement
def rank_tunes(rank):
    """One of two gloo ranks on the CPU: a reduced llama3-8b aida mesh
    session pre-tuned under a timer that gives each rank other times (the
    device check and SM count pinned to a card's).  Returns the rank's
    winners."""
    from repro_torch.api import CompressionSpec, Engine
    from repro_torch.configs import get, reduced
    from repro_torch.kernels import tune
    from repro_torch.launch.mesh import make_host_mesh
    import repro_torch.obs as obs
    tune.tunable = lambda device: True
    tune._sms = lambda device: 132

    def timer(fn, cand, **kw):
        fn(cand)
        v = sum(val * 7 ** i for i, (_, val) in enumerate(cand.tiles))
        return (v if rank == 0 else 1000 - v) * 1e-6
    obs.timeit = timer
    mesh = make_host_mesh(2, backend="gloo", device="cpu")
    eng = Engine(reduced(get("llama3-8b"), **SMALL), device="cpu")
    eng.compress(CompressionSpec(mode="aida", density=0.25, block_rows=16),
                 verbose=None)
    eng.session(batch_slots=2, max_len=32, mesh=mesh,
                scheduler={"chunk": 4})
    return tune.snapshot()


def test_mesh_ranks_record_the_same_winners(tmp_path):
    """Two ranks whose timers disagree record identical winners under the
    whole geometry's keys, each the candidate whose slower rank is
    fastest (every winner's µs is the MAX over the ranks, >= 500 here)."""
    snaps = comm.spawn(2, rank_tunes, backend="gloo", timeout=300,
                       threads=1, workdir=str(tmp_path))
    assert snaps[0] == snaps[1] and snaps[0]
    assert any(k.startswith("aida/") for k in snaps[0])
    assert any(k.startswith("paged-attn/") for k in snaps[0])
    assert any(k.startswith("paged-attn-chunk/") for k in snaps[0])
    for choice in snaps[0].values():
        assert choice["us"] >= 500


# ---------------------------------------------------- block_rows search
def test_block_rows_search_matches_the_reference(monkeypatch):
    """With REPRO_TUNE_BLOCK_ROWS on and a pinned timer in both packages
    (256 fastest, then 64, then 128), the port chooses the reference's
    block_rows for every sparse leaf, and its compressed containers equal
    the bridged reference's (layout bit for bit, centroids within 1e-5)."""
    pinned = {64: 2e-6, 128: 3e-6, 256: 1e-6}

    def timer(fn, blocked, x, **kw):
        return pinned[blocked.block_rows]
    monkeypatch.setattr(jobs, "timeit", timer)
    monkeypatch.setattr(tobs, "timeit", timer)
    monkeypatch.setattr(jenv, "TUNE_BLOCK_ROWS", True)
    monkeypatch.setattr(tenv, "TUNE_BLOCK_ROWS", True)
    cfg = dataclasses.replace(JCFG, n_layers=1)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    spec = dict(mode="aida", density=0.25)
    jout, _ = jcompress_params(jp, JSpec(**spec), verbose=None)
    tout, _ = compress_params(
        bridge.from_reference(jax.tree.map(np.asarray, jp)),
        CompressionSpec(**spec), verbose=None)
    assert set(tune._BLOCK_ROWS_CACHE.values()) == {256}
    assert tune._BLOCK_ROWS_CACHE == {
        (k[0], k[1], k[2]): v for k, v in jtune._BLOCK_ROWS_CACHE.items()}
    n = 0
    for part in ("attn", "mlp"):
        for name, jleaf in jout["layers"][part].items():
            if type(jleaf).__name__ != "CompressedFC":
                continue
            rb = bridge.from_reference(jax.tree.map(np.asarray,
                                                    jleaf.blocked))
            tb = tout["layers"][part][name].blocked
            assert tb.block_rows == rb.block_rows == 256
            for f in ("col_idx", "row_nnz", "values"):
                assert torch.equal(getattr(rb, f), getattr(tb, f)), \
                    (part, name, f)
            np.testing.assert_allclose(tb.centroids.numpy(),
                                       rb.centroids.numpy(), atol=1e-5)
            n += 1
    assert n == 7


# ------------------------------------------------ the encoder's speed-ups
def _argmin_codes(x, cents):
    """The nearest-centroid codes by a distance to every centroid (the
    first wins a tie): what `codebook.assign` gave before its bracketing
    path."""
    flat = x.reshape(-1).float()
    return (flat[:, None] - cents.float()[None, :]).abs().argmin(dim=1) \
        .to(torch.uint8).reshape(x.shape)


@pytest.mark.parametrize("seed", range(4))
def test_assign_equals_the_argmin_bit_for_bit(seed):
    """The bracketing assign gives the argmin's codes on random data at
    several scales and codebook sizes, elements exactly on a centroid or
    halfway between two, and codebooks with a repeated centroid (which
    take the argmin path); kmeans_1d's centroids stay the reference's."""
    from repro_torch.core import codebook as tcb
    gen = torch.Generator().manual_seed(seed)
    for trial in range(40):
        n = int(torch.randint(1, 3000, (1,), generator=gen))
        scale = 10.0 ** float(torch.randint(-3, 3, (1,), generator=gen))
        x = torch.randn(n, generator=gen) * scale
        k = int(torch.randint(1, 17, (1,), generator=gen))
        cents = torch.sort(torch.randn(k, generator=gen) * scale).values
        if trial % 5 == 0:
            cents = torch.sort(torch.cat([cents, cents[:1]])).values
        if trial % 3 == 0 and k > 1:
            x = torch.cat([x, cents, (cents[1:] + cents[:-1]) / 2])
        assert torch.equal(tcb.assign(x, cents), _argmin_codes(x, cents))
    from repro.core import codebook as jcb
    import jax.numpy as jnp
    x = np.random.default_rng(seed).normal(size=5000).astype(np.float32)
    ref = np.asarray(jcb.kmeans_1d(jnp.asarray(x), k=15, iters=25))
    out = tcb.kmeans_1d(torch.from_numpy(x), k=15, iters=25).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_prune_threshold_is_kthvalues():
    """prune_topk's sort-based threshold keeps the entries kthvalue's
    did, ties at the threshold included."""
    from repro_torch.core import acsr as tacsr
    gen = torch.Generator().manual_seed(0)
    for shape, density in (((64, 48), 0.25), ((7, 13), 0.5), ((1, 9), 0.1)):
        w = torch.randn(shape, generator=gen)
        w[0, :3] = w[0, 3]                     # a tie
        k = max(1, int(round(density * w.numel())))
        thr = torch.kthvalue(w.abs().reshape(-1), w.numel() - k + 1).values
        assert torch.equal(tacsr.prune_topk(w, density),
                           w * (w.abs() >= thr))
