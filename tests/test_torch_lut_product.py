"""Port parity for the fully-coded FC (K6's plain version, the one CPU
tensors take): out[b, n] = Σ_k lut[w[n, k], x[b, k]] against the JAX
package's ``lut_product_matmul`` (Pallas, interpret mode) and its oracle,
on the same numpy codes and tables."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro.kernels.lut_matmul import lut_product_matmul as jlut_product
from repro_torch.kernels import lut_matmul as tlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _codes(rng, b, n, k, nc):
    w = rng.integers(0, nc, size=(n, k)).astype(np.uint8)
    packed = w[:, 0::2] | (w[:, 1::2] << 4)
    x = rng.integers(0, nc, size=(b, k)).astype(np.uint8)
    return x, packed


def _luts(rng, nc):
    """The two tables of the reference's own test: the rank-1 product of a
    sorted codebook, and a non-multiplicative one."""
    cents = np.sort(rng.normal(size=nc)).astype(np.float32)
    lut = np.outer(cents, cents).astype(np.float32)
    return {"outer": lut,
            "tanh": (np.tanh(lut) + 0.1 * np.sign(lut)).astype(np.float32)}


# (B, N, K, nc): the reference test's shape; B not a multiple of 8; N not
# a multiple of bn = 128; K not a multiple of bk = 128 (the reference pads
# K and subtracts lut[0, 0] per padded column); nc < 16; K = 2
CASES = [(8, 128, 256, 16), (5, 128, 256, 16), (8, 200, 256, 16),
         (8, 128, 200, 16), (3, 77, 90, 9), (1, 1, 2, 4)]


@pytest.mark.parametrize("table", ["outer", "tanh"])
@pytest.mark.parametrize("b,n,k,nc", CASES)
def test_matches_reference(rng, b, n, k, nc, table):
    """Against the reference's oracle (an f32 sum over exactly K codes) at
    rtol = atol = 1e-4, the reference's own kernel tolerance: the port
    adds each weight byte's two products in f32, runs of four byte sums in
    f32, and the runs exactly (int64 fixed point).  Against an exact f64
    sum within 2e-5 (the pair and run sums' and the final f32 rounding;
    measured 9.5e-6 at most).  Against the reference's Pallas kernel
    at 1e-4 too, except that where K is no multiple of its tile bk the
    kernel adds (kp - k) * lut[0, 0] into its f32 sum and takes it off
    afterwards, which costs it a few ulps of that larger sum (2.1e-4 from
    the exact sum at K = 200, where the port is under 1e-5 from it): there
    the tolerance grows by 4 ulps of (kp - k) * |lut[0, 0]| + max |out|."""
    x, packed = _codes(rng, b, n, k, nc)
    lut = _luts(rng, nc)[table]
    want = np.asarray(jlut_product(jnp.asarray(x), jnp.asarray(packed),
                                   jnp.asarray(lut), bm=8, bn=128, bk=128,
                                   interpret=True))
    oracle = np.asarray(jref.lut_product_matmul_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lut), n))
    w = np.stack([packed & 15, packed >> 4], -1).reshape(n, k)
    exact = lut.astype(np.float64)[w[None].astype(int),
                                   x[:, None, :].astype(int)].sum(-1)
    out = tops.lut_product_matmul(torch.from_numpy(x),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(lut))
    assert out.dtype == torch.float32 and out.shape == (b, n)
    np.testing.assert_allclose(out.numpy(), oracle, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), exact, rtol=0, atol=2e-5)
    bk = min(128, k) + min(128, k) % 2        # the reference's tiling
    pad = -(-k // bk) * bk - k
    tol = 1e-4 + 4 * float(np.spacing(np.float32(
        pad * abs(lut[0, 0]) + np.abs(want).max())) if pad else 0.0)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=tol)
    assert tlm.lut_product_matmul.launches == 0   # CPU tensors launch nothing


def test_integer_table_is_exact(rng):
    """With an integer-valued table every partial sum is an integer below
    2^24, so the port equals the reference's oracle exactly, whatever the
    order of the sums."""
    x, packed = _codes(rng, 6, 150, 330, 16)
    c = np.arange(16, dtype=np.float32) - 8
    lut = np.outer(c, c)
    want = np.asarray(jref.lut_product_matmul_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lut), 150))
    out = tops.lut_product_matmul(torch.from_numpy(x),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(lut))
    np.testing.assert_array_equal(out.numpy(), want)


def test_slicing_n_changes_nothing(rng, monkeypatch):
    """The plain version takes N in slices to bound its index tensor; a
    slice of one row gives the same bits as one slice of all."""
    x, packed = _codes(rng, 4, 37, 96, 16)
    lut = torch.from_numpy(_luts(rng, 16)["tanh"])
    args = (torch.from_numpy(x), torch.from_numpy(packed), lut)
    whole = tref.lut_product_matmul_ref(*args)
    monkeypatch.setattr(tref, "LUT_SLICE", 1)
    assert torch.equal(tref.lut_product_matmul_ref(*args), whole)


@pytest.mark.parametrize("bad", ["x_dtype", "k_mismatch", "nc", "lut_shape"])
def test_rejects_what_does_not_fit(rng, bad):
    x, packed = _codes(rng, 2, 8, 16, 16)
    x, packed = torch.from_numpy(x), torch.from_numpy(packed)
    lut = torch.ones((16, 16))
    if bad == "x_dtype":
        x = x.to(torch.int32)
    elif bad == "k_mismatch":
        packed = packed[:, :-1]
    elif bad == "nc":
        lut = torch.ones((17, 17))
    else:
        lut = torch.ones((16, 8))
    with pytest.raises(ValueError, match="do not fit"):
        tops.lut_product_matmul(x, packed, lut)
