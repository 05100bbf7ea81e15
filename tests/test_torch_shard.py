"""The port's shard layer in one process (`repro_torch.shard`,
`repro_torch.launch.mesh`) against the JAX package's `repro.shard`: plan
basics and host-mesh validation, per-shard padding and local views of the
five modes (field for field against the reference's on the bridged
leaf), `CompressionSpec.shards` and the encode-time padding, a rank's
bands of the params and of the paged pool, the bands of every mode
concatenated equal to the whole leaf's plain version, and the global
split that K1 / K4 / K5 take on a band.  The multi-rank serves are in
`tests/test_torch_mesh_serve.py`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from repro.api import CompressionSpec as JSpec
from repro.core import sparse_fc as jsfc
from repro.launch import mesh as jmesh
from repro.shard import partition as jpart
from repro.shard import plan as jplan
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine
from repro_torch.api import compress as tcompress
from repro_torch.configs import get, reduced
from repro_torch.core import sparse_fc as sfc
from repro_torch.kernels import acsr_spmv as sp
from repro_torch.kernels import fc_tile
from repro_torch.launch import mesh as tmesh
from repro_torch.shard import partition as part
from repro_torch.shard import plan as tplan

MODES = ("dense", "int8", "codebook4", "acsr", "aida")
CFG = reduced(get("llama3-8b"), n_layers=2, d_model=64, d_ff=128, vocab=256)
#: an H100's SM count, for the pure-Python split plans
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU products: one intra-op thread runs them as fast, and
    keeps a parallel test run's processes from contending for the
    cores.  The count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(tp: int, rank: int = 0, n_data: int = 1) -> tmesh.Mesh:
    """A mesh of ``tp`` model ranks seen from ``rank``, without a process
    group: enough for placement, which never communicates."""
    return tmesh.Mesh(shape=(n_data, tp), rank=rank,
                      device=torch.device("cpu"))


def leaves(mode, n_out=30, n_in=32, seed=0):
    """A reference leaf of ``mode`` (block_rows 16) and its bridge."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_out, n_in)).astype(np.float32)
    ref = jsfc.compress(w, mode=mode, density=0.3, block_rows=16)
    return ref, bridge.from_reference(jax.tree.map(np.asarray, ref))


def arrays(leaf):
    """The container's arrays by name (a BlockedACSR's less chunk_off,
    which the reference does not keep)."""
    out = {"dense": leaf.dense, "codes_packed": leaf.codes_packed,
           "centroids": leaf.centroids}
    if leaf.qt is not None:
        out.update(q=leaf.qt.q, scale=leaf.qt.scale)
    if leaf.blocked is not None:
        b = leaf.blocked
        out.update(values=b.values, col_idx=b.col_idx, row_nnz=b.row_nnz,
                   bcent=b.centroids)
    return {k: v for k, v in out.items() if v is not None}


def assert_same_leaf(got, ref_leaf):
    want = bridge.from_reference(jax.tree.map(np.asarray, ref_leaf))
    assert got.mode == want.mode and tuple(got.shape) == tuple(want.shape)
    a, b = arrays(got), arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if got.blocked is not None:
        assert tuple(got.blocked.shape) == tuple(want.blocked.shape)
        assert torch.equal(got.blocked.chunk_off, sp.chunk_offsets(
            got.blocked.col_idx, got.blocked.row_nnz, got.shape[1]))


# ------------------------------------------------------------ plan, mesh
def test_plan_basics_single_device():
    mesh = tmesh.make_host_mesh(device="cpu")
    plan = tplan.make_plan(mesh)
    ref = jplan.make_plan(jax.make_mesh((1, 1), ("data", "model")))
    assert (plan.tp, plan.dp) == (ref.tp, ref.dp) == (1, 1)
    for mode in MODES:
        assert plan.policy_for(mode) == ref.policy_for(mode) == "gather"
    assert plan.policy == ref.policy == tplan.DEFAULT_POLICY
    with pytest.raises(ValueError, match="'model' axis"):
        tplan.make_plan(dataclasses.replace(mesh, shape=(1,),
                                            axis_names=("data",)))
    assert tplan.make_plan(mesh, policy={"int8": "psum"}).policy_for(
        "int8") == "psum"
    with pytest.raises(ValueError, match="'gather' or 'psum'"):
        tplan.make_plan(mesh, policy={"int8": "sum"})


def test_make_host_mesh_validation():
    """A host without a process group is one rank: the reference's mesh
    of one device, its degrees' checks and their messages."""
    mesh = tmesh.make_host_mesh(device="cpu")
    assert tmesh.mesh_shape_dict(mesh) == {"data": 1, "model": 1} == \
        jmesh.mesh_shape_dict(jmesh.make_host_mesh())
    assert (mesh.rank, mesh.coords, mesh.size, mesh.backend) == \
        (0, (0, 0), 1, None)
    assert tmesh.dp_axes(mesh) == ("data",) and tmesh.dp_size(mesh) == 1
    for kw in ({"n_model": 0, "n_data": 1}, {"n_model": 2},
               {"n_data": 2}):
        with pytest.raises(ValueError) as got:
            tmesh.make_host_mesh(device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jmesh.make_host_mesh(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"mesh 2x1 \(data x model\) needs "
                                         r"2 devices"):
        tmesh.make_host_mesh(n_model=1, n_data=2, device="cpu")


def test_tp_without_a_process_group_raises():
    """A mesh wider than one rank needs the ranks and their group: no
    silent single-device run."""
    with pytest.raises(ValueError, match="start one process per rank"):
        tmesh.make_host_mesh(n_model=4, n_data=1, backend="gloo",
                             device="cpu")


def test_fit_drops_axes_that_do_not_divide():
    plan = tplan.make_plan(fake_mesh(4))
    assert plan.fit(("model", None), (7, 4)) == (None, None)
    assert plan.fit(("model", None), (8, 4)) == ("model", None)
    assert plan.fit(None, (8, 4)) == (None, None)
    one = tplan.make_plan(fake_mesh(1))
    ref = jplan.make_plan(jax.make_mesh((1, 1), ("data", "model")))
    for shape in ((7, 4), (8, 4)):
        assert one.fit(("model", None), shape) == tuple(ref.fit(
            jax.sharding.PartitionSpec("model", None), shape))


def test_band_of_an_axis():
    for rank in range(4):
        plan = tplan.make_plan(fake_mesh(4, rank))
        assert plan.band(64) == slice(16 * rank, 16 * (rank + 1))
        assert plan.rank == rank and plan.tp == 4
    plan = tplan.make_plan(fake_mesh(2, rank=3, n_data=2))
    assert (plan.rank, plan.tp, plan.dp) == (1, 2, 2)


# ------------------------------------------------------------ partition
@pytest.mark.parametrize("tp", [2, 4, 3])
@pytest.mark.parametrize("mode", MODES)
def test_pad_leaf_matches_reference(mode, tp):
    ref, leaf = leaves(mode)
    assert part.row_axis_len(leaf) == jpart.row_axis_len(ref)
    assert part.shardable(leaf, tp) == jpart.shardable(ref, tp)
    padded = part.pad_leaf(leaf, tp)
    assert_same_leaf(padded, jpart.pad_leaf(ref, tp))
    assert part.row_axis_len(padded) % tp == 0
    assert tuple(padded.shape) == tuple(leaf.shape)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_local_view_matches_reference(mode, tp):
    ref, leaf = leaves(mode)
    for shard in range(tp):
        assert_same_leaf(part.local_view(leaf, tp, shard),
                         jpart.local_view(ref, tp, shard))


@pytest.mark.parametrize("mode", MODES)
def test_local_view_of_a_stack_is_the_stack_of_views(mode):
    per = [leaves(mode, seed=s)[1] for s in range(3)]
    stack = tcompress._stack_compressed(per)
    for shard in range(4):
        band = part.local_view(stack, 4, shard)
        for i in range(3):
            one = part.local_view(stack.layer(i), 4, shard)
            a, b = arrays(band.layer(i)), arrays(one)
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k


def test_pad_params_for_plan_pads_every_compressed_leaf():
    eng = Engine(CFG, device="cpu").compress(
        CompressionSpec(mode="aida", density=0.3, block_rows=48))
    plan = tplan.make_plan(fake_mesh(4))
    padded = part.pad_params_for_plan(plan, eng.params)
    for blk, names in tplan.BANDED.items():
        for name in names:
            leaf = padded["layers"][blk][name]
            assert part.row_axis_len(leaf) % 4 == 0
            assert tuple(leaf.shape) == tuple(
                eng.params["layers"][blk][name].shape)
    assert padded["embed"]["table"] is eng.params["embed"]["table"]


# ---------------------------------------------------------- spec shards
@pytest.mark.parametrize("shards", [0, -1, 1.5, "2", True, 1, 4])
def test_compression_spec_shards_validation(shards):
    try:
        JSpec(shards=shards)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            CompressionSpec(shards=shards)
        assert str(got.value) == str(e)
    else:
        assert CompressionSpec(shards=shards).shards == shards


@pytest.mark.parametrize("mode", ["acsr", "aida", "int8", "codebook4"])
def test_encode_time_padding(mode):
    """``shards=4`` pads every packed container at compress time (ACSR: 6
    and 3 blocks of 16 become 8 and 4; 36 channels become 40); the padded
    rows are inert, so every projection applies as unpadded."""
    gen = torch.Generator().manual_seed(0)
    params = {"layers": {"attn": {
        "wq": torch.randn((2, 64, 96), generator=gen),
        "wk": torch.randn((2, 64, 36), generator=gen)}}}
    spec = dict(mode=mode, density=0.3, block_rows=16)
    plain, _ = tcompress.compress_params(params, CompressionSpec(**spec),
                                         verbose=None)
    shard4, _ = tcompress.compress_params(
        params, CompressionSpec(shards=4, **spec), verbose=None)
    x = torch.randn(3, 64, generator=gen)
    for name in ("wq", "wk"):
        a, b = plain["layers"]["attn"][name], shard4["layers"]["attn"][name]
        assert part.row_axis_len(b) == -(-part.row_axis_len(a) // 4) * 4
        assert tuple(b.shape) == tuple(a.shape)
        bias = torch.randn(a.shape[0], generator=gen)
        assert torch.equal(sfc.apply_fc(a.layer(1), x, bias=bias),
                           sfc.apply_fc(b.layer(1), x, bias=bias))


# -------------------------------------------------------- a rank's share
def _served_engine(mode):
    eng = Engine(CFG, device="cpu")
    if mode != "dense":
        eng.compress(CompressionSpec(mode=mode, density=0.3,
                                     block_rows=16))
    return eng


@pytest.mark.parametrize("mode", MODES)
def test_prepare_params_bands(mode):
    """Every banded projection is a Band of about 1/tp of the whole's
    bytes; the embedding, norms and the lm_head stay shared."""
    eng = _served_engine(mode)
    tp = 4
    shares = [part.prepare_params(tplan.make_plan(fake_mesh(tp, r)), CFG,
                                  eng.params) for r in range(tp)]
    for blk, names in tplan.BANDED.items():
        for name in names:
            whole = eng.params["layers"][blk][name]
            for r, share in enumerate(shares):
                band = share["layers"][blk][name]
                assert isinstance(band, part.Band)
                n_out = whole.shape[-1] if isinstance(whole, torch.Tensor) \
                    else whole.shape[0]
                assert band.n_out == n_out
                ratio = part.band_bytes(band) / part.band_bytes(whole)
                assert 0.2 <= ratio <= 0.3, (name, ratio)
    for share in shares:
        assert share["embed"]["table"] is eng.params["embed"]["table"]
        assert share["final_norm"]["scale"] is \
            eng.params["final_norm"]["scale"]
        # the head stays whole: cuBLAS sums a vocab band of it in another
        # order than the whole at 32 rows (plan.BANDED)
        assert share["lm_head"] is eng.params["lm_head"]
    if mode == "dense":               # raw matrices: bands of d_out
        joined = torch.cat([s["layers"]["mlp"]["up"].local
                            for s in shares], dim=-1)
        assert torch.equal(joined, eng.params["layers"]["mlp"]["up"])


def test_prepare_params_keeps_what_does_not_divide():
    eng = _served_engine("dense")
    plan = tplan.make_plan(fake_mesh(3))
    share = part.prepare_params(plan, CFG, eng.params)
    # 64 / 3 does not divide: the raw matrix stays whole on every rank
    assert share["layers"]["attn"]["wq"] is eng.params["layers"]["attn"]["wq"]
    assert part.prepare_params(tplan.make_plan(fake_mesh(1)), CFG,
                               eng.params) is eng.params


def test_place_state_bands_kv_heads():
    from repro_torch.models import model as M
    for kv_dtype in ("bf16", "int8"):
        state = M.init_decode_state(CFG, 2, 48, kv_cache="paged",
                                    page_size=16, kv_dtype=kv_dtype)
        kv = state["layers"]["kv"]
        for tp, banded in ((4, True), (2, True), (3, False)):
            plan = tplan.make_plan(fake_mesh(tp, tp - 1))
            local = part.place_state(plan, state, CFG.n_kv)["layers"]["kv"]
            hkv = local.k_pages.shape[-3]
            assert hkv * (tp if banded else 1) == CFG.n_kv
            if kv_dtype == "int8":
                assert local.k_scale.shape[-1] == hkv
        full = M.init_decode_state(CFG, 2, 48, kv_cache="full")
        assert part.place_state(tplan.make_plan(fake_mesh(4)), full,
                                CFG.n_kv) is full
        assert kv.k_pages.shape[-3] == CFG.n_kv


# ---------------------------------------- bands vs the whole, plain versions
@pytest.mark.parametrize("n_out", [64, 60])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_band_concatenation_equals_the_whole(mode, tp, bias, n_out):
    """Each rank's band through its plain version, given the whole's split,
    concatenated and cut to n_out: the whole leaf's apply_fc, bit for bit
    (rows the mesh padded included), at a decode step's rows and a chunked
    step's.  K1's plain version sums each row alone, so its bands match at
    any width; K4 / K5's and dense's are one CPU ``torch.matmul``, whose
    blocking over a ragged output width (60) sums the last channels in
    another order than bands of 16 do: there the bands agree within
    1e-5, exactly at whole 16-channel widths (the CUDA kernels give a band
    the whole's bits at every width, which the card checks)."""
    _, leaf = leaves(mode, n_out=n_out, n_in=64)
    split = part.row_axis_len(leaf)
    gen = torch.Generator().manual_seed(tp)
    b = torch.randn(n_out, generator=gen) if bias else None
    exact = mode in ("acsr", "aida") or n_out % 16 == 0
    for rows in (1, 4, 32):
        x = torch.randn(rows, 64, generator=gen)
        whole = sfc.apply_fc(leaf, x, bias=b)
        outs = []
        for r in range(tp):
            band = part.local_view(leaf, tp, r)
            n = sfc.stored_rows(band)
            bb = None if b is None else torch.nn.functional.pad(
                b, (0, n * tp - n_out))[r * n:(r + 1) * n]
            outs.append(sfc.apply_fc(band, x, bias=bb, split=split))
        joined = torch.cat(outs, dim=1)[:, :n_out]
        if exact:
            assert torch.equal(joined, whole)
        else:
            torch.testing.assert_close(joined, whole, rtol=0, atol=1e-5)


# ------------------------------------------------------- the global split
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n_out,n_in,rmax", [
    (4096, 4096, 1040), (1024, 4096, 1040), (14336, 4096, 1040),
    (4096, 14336, 3616)])
def test_k1_band_takes_the_wholes_split(n_out, n_in, rmax, tp):
    """A band of nb / tp row blocks (and the whole's rmax) launched with
    split_nb = nb runs the whole's (sy, nsplit, per): each of its rows
    adds the same slot ranges in the same order."""
    br = 128
    nb = n_out // br

    def blocked(blocks):
        return sp.BlockedACSR(
            values=torch.empty((blocks, rmax, br), dtype=torch.uint8),
            col_idx=torch.empty((blocks, rmax, br), dtype=torch.int16),
            row_nnz=torch.zeros((blocks, br), dtype=torch.int32),
            shape=(blocks * br, n_in), block_rows=br, nnz=0,
            chunk_off=torch.zeros((blocks, 2, br), dtype=torch.int32))
    whole = sp.launch_plan(blocked(nb), SMS)
    band = blocked(nb // tp)
    assert sp.launch_plan(band, SMS, split_nb=nb) == whole
    sy, nsplit, per = whole
    ranges = [(r * per, min((r + 1) * per, rmax)) for r in range(nsplit)]
    assert ranges[-1][1] == rmax and all(a < b for a, b in ranges)
    if nb < 2 * SMS:      # few row blocks: a band alone would cut more
        assert sp.launch_plan(band, SMS)[1] >= nsplit
    with pytest.raises(ValueError, match="below the band"):
        sp.launch_plan(blocked(nb), SMS, split_nb=nb - 1)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n,k", [(4096, 4096), (1024, 4096), (14336, 4096),
                                 (4096, 14336)])
def test_fc_band_takes_the_wholes_split(n, k, tp):
    """K4 / K5 on a band of n / tp channels with split_n = n: the whole's
    K ranges, which a band alone would not always take."""
    whole = fc_tile.launch_plan(n, k, SMS)
    assert fc_tile.launch_plan(n // tp, k, SMS, split_n=n) == whole
    assert whole == fc_tile.split_plan(n, k, SMS)
    with pytest.raises(ValueError, match="below the band"):
        fc_tile.launch_plan(n, k, SMS, split_n=n - 1)


def test_a_band_alone_would_split_otherwise():
    """Why the geometry is passed: llama3-8b's wk (1024 channels) splits K
    in 16 ranges whole, 32 as a band of 256."""
    assert len(fc_tile.split_plan(1024, 4096, SMS)) == 16
    assert len(fc_tile.split_plan(256, 4096, SMS)) == 32


# --------------------------------------------------------- the entry point
def test_mesh_and_disagg_are_exclusive():
    """The reference's refusal, word for word; a mesh of one serves as the
    plain session does; role meshes wait for the next slice."""
    eng = Engine(CFG, device="cpu")
    mesh = tmesh.make_host_mesh(device="cpu")
    with pytest.raises(ValueError) as got:
        eng.session(mesh=mesh, disagg=True)
    assert str(got.value) == (
        "mesh= and disagg= are mutually exclusive — give the roles their "
        "own devices via DisaggConfig.prefill_devices/decode_devices")
    with pytest.raises(NotImplementedError, match="make_role_meshes"):
        eng.session(disagg={"prefill_devices": 1, "decode_devices": 1})


def test_mesh_of_one_serves_as_the_plain_session():
    from repro_torch.api import Request
    eng = Engine(CFG, device="cpu").compress(
        CompressionSpec(mode="aida", density=0.3, block_rows=16))
    reqs = [Request(prompt=[3, 1, 4, 1, 5], max_new=4, rid=i)
            for i in range(2)]
    out = []
    for mesh in (None, tmesh.make_host_mesh(device="cpu")):
        sess = eng.session(batch_slots=2, max_len=32, mesh=mesh,
                           scheduler={"chunk": 4})
        assert (sess.plan is None) == (mesh is None)
        for r in reqs:
            sess.submit(r)
        out.append([r.tokens for r in sess.run()])
    assert out[0] == out[1]


def test_session_refuses_a_mesh_on_another_device():
    from repro_torch.api.session import Session
    plan = tplan.make_plan(dataclasses.replace(
        tmesh.make_host_mesh(device="cpu"), device=torch.device("meta")))
    with pytest.raises(ValueError, match="the mesh's rank runs on meta"):
        Session(CFG, Engine(CFG, device="cpu").params, device="cpu",
                plan=plan)


def test_a_band_needs_its_plan():
    from repro_torch.models import layers as L
    eng = _served_engine("aida")
    share = part.prepare_params(tplan.make_plan(fake_mesh(4)), CFG,
                                eng.params)
    band = share["layers"]["attn"]["wq"].layer(0)
    with pytest.raises(ValueError, match="pass the session's plan"):
        L.dense(torch.zeros(1, CFG.d_model), band)


def test_a_collective_without_its_group_raises():
    """A plan wider than one rank with no process group fails at its first
    collective: a band never runs as if it were the whole."""
    from repro_torch.shard import apply_fc_sharded
    _, leaf = leaves("acsr", n_out=64, n_in=64)
    with pytest.raises((RuntimeError, ValueError)):
        apply_fc_sharded(tplan.make_plan(fake_mesh(4)), leaf,
                         torch.zeros(2, 64))
