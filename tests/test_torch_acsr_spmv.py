"""Port parity: blocked-ACSR encoding, pruning, k-means and the K1 SpMV
wrapper (CPU path = its plain version) against the JAX package, on the
same numpy inputs.  The JAX kernel runs in Pallas interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro.core import acsr as jacsr
from repro.core import codebook as jcb
from repro.core import sparse_fc as jsfc
from repro.kernels import acsr_spmv as jsp
from repro_torch import bridge
from repro_torch.core import acsr as tacsr
from repro_torch.core import codebook as tcb
from repro_torch.core import sparse_fc as tsfc
from repro_torch.kernels import acsr_spmv as tsp


def _pruned(rng, shape, density=0.25):
    w = rng.normal(size=shape).astype(np.float32)
    return jacsr.prune_topk(w, density)


def _same_blocked(jb, tb):
    ref = bridge.from_reference(jax.tree.map(np.asarray, jb))
    for name in ("values", "col_idx", "row_nnz", "centroids"):
        a, b = getattr(ref, name), getattr(tb, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert (ref.shape, ref.block_rows, ref.nnz) == \
        (tb.shape, tb.block_rows, tb.nnz)


@pytest.mark.parametrize("shape,block_rows", [((200, 96), 128),
                                              ((64, 40000), 32),
                                              ((130, 7), 64)])
def test_block_encode_identical(shape, block_rows):
    rng = np.random.default_rng(0)
    w = _pruned(rng, shape, 0.1 if shape[1] > 1000 else 0.3)
    jb = jsp.block_encode(w, block_rows)
    tb = tsp.block_encode(torch.from_numpy(w), block_rows)
    _same_blocked(jb, tb)
    if shape[1] > 2 ** 15:
        assert tb.col_idx.dtype == torch.int32
    jb16 = jsp.block_encode(w, block_rows, value_dtype="bf16")
    tb16 = tsp.block_encode(torch.from_numpy(w), block_rows,
                            value_dtype="bf16")
    _same_blocked(jb16, tb16)


def test_block_encode_coded_identical():
    rng = np.random.default_rng(1)
    w = _pruned(rng, (150, 80))
    cents = np.concatenate([[0.0], np.sort(rng.normal(size=15))]
                           ).astype(np.float32)
    # a live nonzero sitting on centroid 0 keeps code 0, masked by row_nnz
    w[3, 5] = 1e-6
    jb = jsp.block_encode_coded(w, cents)
    tb = tsp.block_encode_coded(torch.from_numpy(w), torch.from_numpy(cents))
    _same_blocked(jb, tb)


@pytest.mark.parametrize("density", [0.05, 0.25, 0.5])
def test_prune_topk_masks_identical(density):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(97, 61)).astype(np.float32)
    w[0, :4] = w[1, :4]                      # ties at the threshold scale
    ref = jacsr.prune_topk(w, density)
    out = tacsr.prune_topk(torch.from_numpy(w), density).numpy()
    np.testing.assert_array_equal(ref != 0, out != 0)
    np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize("k", [4, 15])
def test_kmeans_1d_matches(k):
    rng = np.random.default_rng(3)
    x = rng.normal(size=5000).astype(np.float32)
    ref = np.asarray(jcb.kmeans_1d(jnp.asarray(x), k=k, iters=25))
    out = tcb.kmeans_1d(torch.from_numpy(x), k=k, iters=25).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


CASES = [  # (n_rows, n_cols, coded, activation, bias, batch)
    (200, 96, True, None, False, 1),
    (200, 96, True, "silu", False, 4),
    (130, 64, False, "relu", True, 4),
    (64, 300, False, "gelu", False, 1),
    (256, 48, True, "gelu", True, 4),
]


@pytest.mark.parametrize("n_rows,n_cols,coded,act,has_bias,batch", CASES)
def test_acsr_spmv_matches_pallas(n_rows, n_cols, coded, act, has_bias,
                                  batch):
    """Same slot layout, same x: the port's wrapper (plain version on the
    CPU) agrees with the Pallas kernel to f32 sum-order error."""
    rng = np.random.default_rng(4)
    w = _pruned(rng, (n_rows, n_cols))
    if coded:
        layer = jsfc.compress(w, mode="aida", density=1.0, kmeans_iters=5)
    else:
        layer = jsfc.compress(w, mode="acsr", density=1.0)
    jb = layer.blocked
    x = rng.normal(size=(n_cols, batch)).astype(np.float32)
    bias = rng.normal(size=n_rows).astype(np.float32) if has_bias else None
    ref = np.asarray(jsp.acsr_spmv(
        jb, jnp.asarray(x), bias=None if bias is None else jnp.asarray(bias),
        activation=act, interpret=True))
    tb = bridge.from_reference(jax.tree.map(np.asarray, jb))
    out = tsp.acsr_spmv(tb, torch.from_numpy(x),
                        bias=None if bias is None else torch.from_numpy(bias),
                        activation=act).numpy()
    assert out.shape == (n_rows, batch)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    if batch == 1:
        vec = tsp.acsr_spmv(tb, torch.from_numpy(x[:, 0]),
                            bias=None if bias is None
                            else torch.from_numpy(bias),
                            activation=act).numpy()
        np.testing.assert_allclose(vec, ref[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["acsr", "aida"])
def test_compress_matches_reference(mode):
    """The whole offline pipeline (prune -> k-means -> encode) gives the
    reference's container: identical layout, centroids within 1e-5 and
    the same dense equivalent."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(160, 72)).astype(np.float32)
    ref = jsfc.compress(w, mode=mode, density=0.25)
    out = tsfc.compress(torch.from_numpy(w), mode=mode, density=0.25)
    rb = bridge.from_reference(jax.tree.map(np.asarray, ref.blocked))
    for name in ("col_idx", "row_nnz", "values"):
        assert torch.equal(getattr(rb, name), getattr(out.blocked, name))
    if mode == "aida":
        np.testing.assert_allclose(out.blocked.centroids.numpy(),
                                   rb.centroids.numpy(), atol=1e-5)
    np.testing.assert_allclose(tsfc.dense_equivalent(out).numpy(),
                               jsfc.dense_equivalent(ref), atol=1e-5)



# ------------------------------------------------ the CUDA kernel's plan
def _ascending(b):
    """Every row's live slots hold strictly ascending columns."""
    cols = b.col_idx.long()
    live = torch.arange(b.rmax)[None, :, None] < b.row_nnz[:, None, :]
    step = cols[:, 1:] - cols[:, :-1]
    both = live[:, 1:] & live[:, :-1]
    return bool((step[both] > 0).all())


def _chunk_recount(b, n_cols):
    """chunk_off recounted in numpy, slot by slot."""
    cols, nnz = b.col_idx.numpy(), b.row_nnz.numpy()
    nb, _, br = cols.shape
    nck = max(1, -(-n_cols // tsp.CHUNK_COLS))
    out = np.zeros((nb, nck + 1, br), np.int64)
    for blk in range(nb):
        for lane in range(br):
            live = cols[blk, : nnz[blk, lane], lane].astype(np.int64)
            for c in range(nck + 1):
                out[blk, c, lane] = int((live < c * tsp.CHUNK_COLS).sum())
    return out


@pytest.mark.parametrize("shape,block_rows,density", [
    ((200, 96), 128, 0.3), ((130, 700), 64, 0.25), ((64, 40000), 32, 0.02),
    ((33, 513), 32, 0.9), ((96, 256), 32, 1.0)])
def test_rows_ascend_and_chunk_offsets_recount(shape, block_rows, density):
    """The kernel walks a row through K tile by tile, so each row's live
    slots must hold ascending columns: in the port's two encoders and in a
    container bridged from the reference's encoder.  chunk_off, derived
    when each container is made, equals a slot-by-slot recount."""
    rng = np.random.default_rng(7)
    w = _pruned(rng, shape, density)
    w[::5] = 0.0                                   # rows with no slot
    cents = np.concatenate([[0.0], np.sort(rng.normal(size=15))]
                           ).astype(np.float32)
    made = [tsp.block_encode(torch.from_numpy(w), block_rows),
            tsp.block_encode(torch.from_numpy(w), block_rows,
                             value_dtype="bf16"),
            tsp.block_encode_coded(torch.from_numpy(w),
                                   torch.from_numpy(cents), block_rows),
            bridge.from_reference(jax.tree.map(
                np.asarray, jsp.block_encode(w, block_rows)))]
    want = _chunk_recount(made[0], shape[1])
    for b in made:
        assert _ascending(b)
        assert b.chunk_off.dtype == torch.int32
        np.testing.assert_array_equal(b.chunk_off.numpy(), want)
        np.testing.assert_array_equal(b.chunk_off[:, -1].numpy(),
                                      b.row_nnz.numpy())


def test_chunk_offsets_follow_stacks_views_and_moves():
    """A stacked container (uniform slot depth across layers) carries each
    layer's chunk_off; a layer view and a move to another device keep
    it."""
    from repro_torch.api.compress import _stack_compressed
    rng = np.random.default_rng(8)
    layers = [tsfc.compress(torch.from_numpy(_pruned(rng, (160, 600), d)),
                            mode="aida", density=d, kmeans_iters=3)
              for d in (0.1, 0.3)]
    stack = _stack_compressed(layers).blocked
    assert stack.chunk_off.shape == (2, *layers[0].blocked.chunk_off.shape)
    for i, c in enumerate(layers):
        view = stack.layer(i)
        assert torch.equal(view.chunk_off, c.blocked.chunk_off)
        assert torch.equal(view.chunk_off,
                           tsp.chunk_offsets(view.col_idx, view.row_nnz,
                                             view.shape[1]))
    moved = bridge.to_device(stack, "cpu")
    assert torch.equal(moved.chunk_off, stack.chunk_off)


@pytest.mark.parametrize("nrows,nck", [(4096, 16), (1024, 16), (14336, 16),
                                       (4096, 56), (1024, 157), (64, 1),
                                       (100000, 3)])
def test_split_plan_covers_every_chunk_once(nrows, nck):
    """The slot axis splits into nsplit ranges of `per` slots that cover
    slots [0, rmax) once each, none empty, at the geometry of nrows rows in
    blocks of 128 with 16 slots (a density of 0.25) per 64-column chunk."""
    rmax = 16 * nck
    sy, nsplit, per = tsp.split_plan(tsp.cdiv(nrows, 128), rmax, 128, 132)
    assert sy == 4 and 1 <= nsplit <= rmax and per >= 1
    assert (nsplit - 1) * per < rmax <= nsplit * per


@pytest.mark.parametrize("br", [32, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("nb,rmax", [(1, 8), (8, 1104), (32, 3600),
                                     (112, 1104), (300, 40), (3, 1)])
def test_split_plan_takes_no_width_and_covers_every_slot_once(br, nb, rmax):
    """Both K1 variants take their split from one plan, a function of the
    matrix geometry and the SM count and not of x's width, so a column is
    summed in one order at every width: its parts cover every slot of a
    range once, its ranges every slot once, and a block fits 512
    threads."""
    import inspect
    assert list(inspect.signature(tsp.split_plan).parameters) == \
        ["nb", "rmax", "br", "sms"]
    sy, nsplit, per = tsp.split_plan(nb, rmax, br, 132)
    assert 1 <= sy and br * sy <= 512
    assert (nsplit - 1) * per < rmax <= nsplit * per
    covered = sorted(s0 + t + i * sy for s0 in range(0, nsplit * per, per)
                     for t in range(sy)
                     for i in range(-(-(min(s0 + per, rmax) - s0 - t) // sy)))
    assert covered == list(range(rmax))


def test_launch_rejects_what_the_kernel_does_not_take():
    """The CUDA launcher's checks run before any library is loaded: a slot
    stream that is not 16-byte aligned (the kernel copies it in 16-byte
    pieces), blocks of rows that are not a multiple of 32 (a warp's lanes
    are rows) and a chunk_off of the wrong shape are refused."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(_pruned(rng, (128, 300)))
    b = tsp.block_encode(w, 64, value_dtype="bf16")
    x = torch.zeros((300, 4))
    shifted = torch.zeros(b.values.numel() + 1, dtype=torch.bfloat16)
    shifted[1:] = b.values.reshape(-1)
    bad = dataclasses.replace(b, values=shifted[1:].view(b.values.shape),
                              chunk_off=b.chunk_off)
    with pytest.raises(ValueError, match="16-byte"):
        tsp._launch(bad, x, None, None)
    with pytest.raises(ValueError, match="multiple of 32"):
        tsp._launch(tsp.block_encode(w, 48, value_dtype="bf16"), x, None,
                    None)
    bad = dataclasses.replace(b, chunk_off=b.chunk_off[:, :-1].contiguous())
    with pytest.raises(TypeError, match="chunk_off"):
        tsp._launch(bad, x, None, None)


@pytest.mark.parametrize("batch,kernel", [(1, "spmv_gather"),
                                          (8, "spmv_gather"),
                                          (9, "spmv_wide"), (32, "spmv_wide"),
                                          (40, "spmv_wide")])
def test_launch_picks_the_variant_by_width(monkeypatch, batch, kernel):
    """x of at most GATHER_COLS columns (a decode step) takes the gather
    kernel, wider x (a chunked step) the wide kernel; CPU tensors reach
    neither launcher's counter."""
    rng = np.random.default_rng(10)
    b = tsp.block_encode(torch.from_numpy(_pruned(rng, (96, 200))), 32)
    x = torch.zeros((200, batch))
    before = (tsp.spmv_gather.launches, tsp.spmv_wide.launches)
    tsp.acsr_spmv(b, x)
    assert (tsp.spmv_gather.launches, tsp.spmv_wide.launches) == before
    called = []
    for name in ("spmv_gather", "spmv_wide"):
        monkeypatch.setattr(tsp, name, lambda *a, name=name: called.append(
            name))
    tsp._launch(b, x, None, None)
    assert called == [kernel]


@pytest.mark.parametrize("mode,vdt", [("aida", "f32"), ("acsr", "f32"),
                                      ("acsr", "bf16")])
def test_plain_version_gives_a_column_the_same_bits_at_every_width(mode,
                                                                   vdt):
    """The plain version, like the kernels, sums a column the same way
    whatever x's width: column j of a 32- or 40-column product equals the
    same column computed alone and among 4."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(_pruned(rng, (200, 700)))
    layer = tsfc.compress(w, mode=mode, density=0.25, dtype=vdt,
                          kmeans_iters=3)
    b = layer.blocked
    x = torch.from_numpy(rng.normal(size=(700, 40)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    for width in (32, 40):
        wide = tsp.acsr_spmv(b, x[:, :width].contiguous(), bias=bias,
                             activation="silu")
        for j in range(width):
            alone = tsp.acsr_spmv(b, x[:, j].contiguous(), bias=bias,
                                  activation="silu")
            assert torch.equal(wide[:, j], alone)
            j4 = min(j, width - 4)
            four = tsp.acsr_spmv(b, x[:, j4:j4 + 4].contiguous(), bias=bias,
                                 activation="silu")
            assert torch.equal(wide[:, j], four[:, j - j4])
