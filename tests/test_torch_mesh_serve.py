"""Tensor-parallel serving over a mesh of ranks (`Engine.session(mesh=)`),
held against the single-device serve, on the CPU over gloo.

Each group of ranks is spawned once (`repro_torch.shard.comm.spawn`, a
``file://`` rendezvous under the test's temporary directory, a timeout on
the group and on every collective) and runs all its cases inside, one
dict back per rank; the tests read that dict.  The model is the JAX
package's mesh smoke: a reduced llama3-8b or mixtral-8x7b (2 layers,
d_model 64, d_ff 128, vocab 256), compressed at block_rows 16 so every
rank gets real bands.

What is held: under the gather policy, the tokens and every emitted
logits row of a 4x1 mesh equal the single-device serve's bit for bit
(llama3 in acsr, aida, int8 and codebook4 at chunk 1 and 8, mixtral in
aida); banded raw leaves (the uncompressed model) to tokens wherever the
top-2 margin exceeds 1e-2 and logits within 1e-3; every rank serves the
same tokens; a rank holds about 1/tp of a banded leaf's bytes and 1/tp of
the KV heads; a width the mesh does not divide stays whole; int8's psum
policy within 1e-4 of the single-device kernel; a preempting serve under
page pressure with its allocator exact and nothing leaked; a 2x2 (model x
data) mesh; and a 4x1 serve on the reference's weights against the JAX
package's single-device serve, up to near-tie flips.

The ranks import this module, which loads neither JAX nor the JAX package
at import (the reference's serve runs in the test process only)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.shard import comm

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
ML, SLOTS = 48, 2
REQS = [Request(prompt=[1 + (j * 7 + i) % 200 for j in range(9)],
                max_new=6, rid=i) for i in range(3)]
#: (arch, mode) served at chunk 1 and 8 on the 4x1 mesh
CASES = [("llama3-8b", m) for m in ("dense", "acsr", "aida", "int8",
                                    "codebook4")] + [("mixtral-8x7b", "aida")]
#: near-tie bound: a greedy stream may first differ where the top-2 logit
#: margin is below it
TIE = 1e-2
#: seconds a group of ranks may take (a collective gives up after
#: comm.GROUP_TIMEOUT)
GROUP_SECONDS = 300


def smoke(arch):
    return reduced(get(arch), **SMALL)


def engine(arch, mode, params=None):
    eng = Engine(smoke(arch), params=params, device="cpu")
    if mode != "dense":
        eng.compress(CompressionSpec(mode=mode, density=0.25,
                                     block_rows=16), verbose=None)
    return eng


def serve(eng, reqs=REQS, mesh=None, chunk=1, slots=SLOTS, pool=None):
    """(session, {"tokens", "logits" by rid, "margins"}) of one serve;
    ``logits`` holds the row each token was drawn from."""
    sess = eng.session(batch_slots=slots, max_len=ML, mesh=mesh,
                       kv_pool_pages=pool, scheduler={"chunk": chunk})
    rows = {}
    emit = sess._emit

    def keep(i, logits_i, now):
        rows.setdefault(sess.slot_entry[i].req.rid, []).append(
            torch.from_numpy(logits_i.copy()))
        emit(i, logits_i, now)
    sess._emit = keep
    for r in reqs:
        sess.submit(dataclasses.replace(r))
    res = sess.run()
    return sess, {"tokens": [r.tokens for r in res],
                  "logits": {k: torch.stack(v) for k, v in rows.items()},
                  "margins": dict(sess.margins)}


def alloc_reqs():
    return [Request(prompt=[2 + i] * 8, max_new=16, rid=i) for i in range(6)]


def alloc_pool():
    """A pool under the 3-slot worst case, so preemption kicks in."""
    from repro_torch.sched.scheduler import page_need
    return 1 + 3 * page_need(8, 16, ML, 16) - 2


def alloc_view(sess):
    a = sess.alloc
    return {"preempted": sess.stats["preemptions"] > 0,
            "free_list_unique": len(set(a._free)) == len(a._free),
            "free_used_disjoint": not (set(a._free) & a._used),
            "partition_exact": len(a._free) + a.in_use == a.n_pages - 1,
            "pages_leaked": a.in_use}


# ------------------------------------------------------------ the ranks
def rank_4x1(rank, ref_params):
    """Every case of the 4x1 group, on this rank."""
    from repro_torch import shard
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.shard import partition
    mesh = make_host_mesh(4, backend="gloo", device="cpu")
    out = {"cases": {}}
    for arch, mode in CASES:
        eng = engine(arch, mode)
        for chunk in (1, 8):
            sess, got = serve(eng, mesh=mesh, chunk=chunk)
            out["cases"][(arch, mode, chunk)] = got
        if (arch, mode) == ("llama3-8b", "aida"):
            whole = eng.params["layers"]["attn"]["wq"]
            band = sess.params["layers"]["attn"]["wq"]
            out["band_bytes"] = (partition.band_bytes(band),
                                 partition.band_bytes(whole))
            kv = sess.state["layers"]["kv"]
            out["kv_heads"] = (kv.k_pages.shape[-3], eng.cfg.n_kv)
    # a width the mesh does not divide stays whole
    plan = shard.make_plan(mesh)
    odd = torch.zeros((2, 64, 30))
    out["fit_fallback"] = plan.fit(("model", None), (7, 4)) == (None, None) \
        and shard.prepare_params(plan, None, {"layers": {"mlp": {
            "up": odd}}})["layers"]["mlp"]["up"] is odd
    # the int8 psum policy against the single-device kernel
    rng = np.random.default_rng(0)
    leaf = partition.pad_leaf(sfc.compress(
        torch.from_numpy(rng.normal(size=(30, 32))), mode="int8"), 4)
    x = torch.from_numpy(rng.normal(size=(2, 32))).float()
    b = torch.from_numpy(rng.normal(size=(30,))).float()
    ref = sfc.apply_fc(leaf, x, bias=b, activation="relu")
    plan_p = shard.make_plan(mesh, policy={"int8": "psum"})
    got = shard.apply_fc_sharded(plan_p, leaf, x, bias=b, activation="relu")
    out["psum"] = (tuple(got.shape) == tuple(ref.shape),
                   float((got - ref).abs().max()))
    # preemption under page pressure
    sess, got = serve(engine("llama3-8b", "acsr"), alloc_reqs(), mesh=mesh,
                      chunk=4, slots=3, pool=alloc_pool())
    out["alloc"] = dict(alloc_view(sess), tokens=got["tokens"])
    # the reference's weights, served tensor-parallel
    _, got = serve(engine("llama3-8b", "aida", params=ref_params),
                   mesh=mesh, chunk=8)
    out["reference_weights"] = got
    return out


def rank_2x2(rank):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2, backend="gloo", device="cpu")
    return {"coords": mesh.coords, "tp": mesh.shape[1],
            "aida8": serve(engine("llama3-8b", "aida"), mesh=mesh,
                           chunk=8)[1]["tokens"],
            "acsr1": serve(engine("llama3-8b", "acsr"), mesh=mesh,
                           chunk=1)[1]["tokens"]}


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU products: one intra-op thread serves them as fast
    and keeps a parallel test run's processes from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    import jax
    from repro.configs import get as jget
    from repro.configs import reduced as jreduced
    from repro.models import model as JM
    return JM.init_params(jreduced(jget("llama3-8b"), **SMALL),
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref_params(jparams):
    import jax
    from repro_torch import bridge
    return bridge.from_reference(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_params):
    return comm.spawn(4, rank_4x1, (ref_params,), backend="gloo",
                      timeout=GROUP_SECONDS, threads=1,
                      workdir=str(tmp_path_factory.mktemp("mesh4x1")))


@pytest.fixture(scope="module")
def single():
    """The single-device serves of every case, in this process."""
    return {(arch, mode, chunk): serve(engine(arch, mode), chunk=chunk)[1]
            for arch, mode in CASES for chunk in (1, 8)}


def tokens_agree(ref, got, margins):
    """Greedy streams agree, or first differ where ``margins`` (top-2 logit
    margins of the stream they are drawn from) is below TIE."""
    assert len(ref) == len(got)
    for rid, (a, b) in enumerate(zip(ref, got)):
        assert len(a) == len(b)
        j = next((j for j, (s, t) in enumerate(zip(a, b)) if s != t), None)
        if j is not None:
            assert margins[rid][j] < TIE, (rid, j, margins[rid][j])


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("arch,mode", [c for c in CASES if c[1] != "dense"])
def test_gather_policy_is_bit_identical(ranks, single, arch, mode, chunk):
    want = single[(arch, mode, chunk)]
    got = ranks[0]["cases"][(arch, mode, chunk)]
    assert got["tokens"] == want["tokens"]
    assert got["logits"].keys() == want["logits"].keys()
    for rid in want["logits"]:
        assert torch.equal(got["logits"][rid], want["logits"][rid]), rid


@pytest.mark.parametrize("chunk", [1, 8])
def test_banded_raw_leaves(ranks, single, chunk):
    """The uncompressed model: raw matrices banded by output columns."""
    want = single[("llama3-8b", "dense", chunk)]
    got = ranks[0]["cases"][("llama3-8b", "dense", chunk)]
    tokens_agree(want["tokens"], got["tokens"], want["margins"])
    for rid in want["logits"]:
        n = min(len(got["logits"][rid]), len(want["logits"][rid]))
        torch.testing.assert_close(got["logits"][rid][:n],
                                   want["logits"][rid][:n], rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("arch,mode", CASES)
def test_ranks_agree(ranks, arch, mode, chunk):
    toks = [r["cases"][(arch, mode, chunk)]["tokens"] for r in ranks]
    assert all(t == toks[0] for t in toks[1:])
    logits = [r["cases"][(arch, mode, chunk)]["logits"] for r in ranks]
    for rid in logits[0]:
        assert all(torch.equal(lg[rid], logits[0][rid]) for lg in logits)


def test_sharding_is_real(ranks):
    for r in ranks:
        band, whole = r["band_bytes"]
        assert 0.2 <= band / whole <= 0.3, (band, whole)
        local, n_kv = r["kv_heads"]
        assert local * 4 == n_kv


def test_non_divisible_width_stays_whole(ranks):
    assert all(r["fit_fallback"] for r in ranks)


def test_int8_psum_policy(ranks):
    for r in ranks:
        shape_ok, err = r["psum"]
        assert shape_ok and err < 1e-4, err


def test_preempting_serve_under_page_pressure(ranks):
    sess, want = serve(engine("llama3-8b", "acsr"), alloc_reqs(), chunk=4,
                       slots=3, pool=alloc_pool())
    assert sess.stats["preemptions"] > 0
    for r in ranks:
        a = r["alloc"]
        assert a["tokens"] == want["tokens"] and len(a["tokens"]) == 6
        assert a["preempted"] and a["free_list_unique"]
        assert a["free_used_disjoint"] and a["partition_exact"]
        assert a["pages_leaked"] == 0


def test_reference_single_device_serve(ranks, jparams):
    """The mesh on the reference's weights against the JAX package's own
    single-device serve (aida, chunk 8): tokens equal up to near-tie
    flips of its jitted step."""
    from repro.api import CompressionSpec as JSpec
    from repro.api import Engine as JEngine
    from repro.api.session import Request as JRequest
    from repro.configs import get as jget
    from repro.configs import reduced as jreduced
    jeng = JEngine(jreduced(jget("llama3-8b"), **SMALL), params=jparams)
    jeng.compress(JSpec(mode="aida", density=0.25, block_rows=16),
                  verbose=None)
    jsess = jeng.session(batch_slots=SLOTS, max_len=ML,
                         scheduler={"chunk": 8})
    for r in REQS:
        jsess.submit(JRequest(prompt=list(r.prompt), max_new=r.max_new,
                              rid=r.rid))
    want = [r.tokens for r in jsess.run()]
    got = ranks[0]["reference_weights"]
    tokens_agree(want, got["tokens"], got["margins"])


def test_2x2_mesh(tmp_path):
    """Two data rows of two model ranks: each row serves the requests on
    its own, and every rank's tokens are the single-device serve's."""
    outs = comm.spawn(4, rank_2x2, backend="gloo", timeout=GROUP_SECONDS,
                      threads=1, workdir=str(tmp_path))
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want8 = serve(engine("llama3-8b", "aida"), chunk=8)[1]["tokens"]
    want1 = serve(engine("llama3-8b", "acsr"), chunk=1)[1]["tokens"]
    for o in outs:
        assert o["tp"] == 2
        assert o["aida8"] == want8 and o["acsr1"] == want1


def test_a_failed_rank_fails_the_serve(tmp_path):
    with pytest.raises(RuntimeError, match=r"(?s)mesh rank 1 failed.*"
                                           r"ValueError: planted"):
        comm.spawn(2, rank_fails, backend="gloo", timeout=GROUP_SECONDS,
                   threads=1, workdir=str(tmp_path))


def rank_fails(rank):
    """Rank 1 fails while rank 0 waits in a collective for it."""
    if rank == 1:
        raise ValueError("planted")
    comm.all_gather_cat(torch.zeros(1), None)


def test_launcher_mesh(tmp_path):
    """``python -m repro_torch.launch.serve --mesh 2 --device cpu``: two
    ranks over gloo, rank 0 alone reporting, the ranks' tokens checked
    equal; its served counts are the single-device launcher's."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    from repro_torch.launch import serve as launcher
    root = pathlib.Path(__file__).resolve().parents[1]
    args = ["--arch", "llama3-8b", "--device", "cpu", "--compress", "aida",
            "--density", "0.25", "--requests", "3", "--max-new", "5"]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--mesh", "2", "--json", str(tmp_path / "mesh.json")], cwd=root,
        env=env, capture_output=True, text=True, timeout=GROUP_SECONDS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "[serve] mesh: {'data': 1, 'model': 2} over gloo" in out
    assert "the 2 ranks served the same tokens" in out
    assert out.count("[serve] 3/3 requests") == 1      # rank 0 alone
    assert launcher.main([*args, "--json", str(tmp_path / "one.json")]) == 0
    mesh = json.loads((tmp_path / "mesh.json").read_text())
    one = json.loads((tmp_path / "one.json").read_text())
    assert mesh["provenance"]["mesh"] == {
        "shape": {"data": 1, "model": 2}, "backend": "gloo"}
    for key in ("completed", "tokens", "steps", "preemptions"):
        assert mesh["metrics"][key] == one["metrics"][key], key
    assert mesh["pages"]["leaked"] == 0


def test_launcher_mesh_refusals(capsys):
    from repro_torch.launch import serve as launcher
    base = ["--arch", "llama3-8b", "--device", "cpu"]
    for extra, msg in ((["--mesh", "2", "--disagg"], "mutually exclusive"),
                       (["--mesh", "2x"], "MODEL or MODELxDATA"),
                       (["--mesh", "2", "--mesh-backend", "nccl"],
                        "needs the card")):
        with pytest.raises(SystemExit):
            launcher.main(base + extra)
        assert msg in capsys.readouterr().err
