"""Port parity: blocked-ACSR encoding, pruning, k-means and the K1 SpMV
wrapper (CPU path = its plain version) against the JAX package, on the
same numpy inputs.  The JAX kernel runs in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_later_modes_raise():
    w = torch.zeros(8, 8)
    for mode in ("int8", "codebook4"):
        with pytest.raises(NotImplementedError, match="later slice"):
            tsfc.compress(w, mode=mode)
