"""K6's arithmetic on the CPU (the fully-coded product's pair tables, f32
runs and exact int64 sums): a pair table built the kernel's way holds, bit
for bit, the plain version's f32 pair sum for every weight byte and x code
pair; the source's geometry is the wrapper's; the split plan covers K once
in order; an emulation of the kernel's accumulation (runs summed in another
order, split by the plan, x rows grouped) equals the plain version bit for
bit, is within 1e-4 of the JAX reference's oracle, and is exact on an
integer table."""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import fc_tile
from repro_torch.kernels import lut_matmul as tlm
from repro_torch.kernels import ref as tref

CSRC = pathlib.Path(tlm.__file__).resolve().parents[1] / "csrc"
PROJECTIONS = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _lut(rng, nc, kind):
    c = np.sort(rng.normal(size=nc)).astype(np.float32)
    lut = np.outer(c, c).astype(np.float32)
    if kind == "tanh":
        lut = (np.tanh(lut) + 0.1 * np.sign(lut)).astype(np.float32)
    elif kind == "int":
        i = np.arange(nc, dtype=np.float32) - nc // 2
        lut = np.outer(i, i).astype(np.float32)
    return lut


def _scale(lut):
    """s as the kernel computes it: 29 - e, max |lut| = f 2^e (frexpf)."""
    return 29 - math.frexp(float(np.abs(lut).max()))[1]


def test_source_geometry_matches_the_wrapper():
    """Rows a block (warps x rows a warp), bytes a step and x rows a block
    are the wrapper's; four tables of 256 byte values x 32 lanes."""
    text = (CSRC / "lut_product.cu").read_text()
    threads, rows = _const(text, "THREADS"), _const(text, "ROWS")
    assert threads // 32 * rows == tlm.K6_ROWS
    assert _const(text, "STEP") == tlm.K6_STEP
    assert _const(text, "XROWS") == tlm.K6_XROWS
    assert "constexpr int TABLE = 4 * 256 * 32 * 4;" in text


@pytest.mark.parametrize("nc", [16, 9, 4, 1])
@pytest.mark.parametrize("kind", ["outer", "tanh", "int"])
def test_pair_table_is_the_plain_pair_sum(rng, nc, kind):
    """Entry [byte v] of the table of x codes (x0, x1), built as the kernel
    builds it (lut' transposed, a[lo] = lut'[lo, x0] plus b[hi] =
    lut'[hi, x1]), equals the plain version's pair lut'[v & 15, x0] +
    lut'[v >> 4, x1] bit for bit, for every byte whose codes are below nc
    and every x pair; the scale is the plain version's."""
    lut = _lut(rng, nc, kind)
    s = _scale(lut)
    assert s == tref.lut_product_scale(torch.from_numpy(lut))
    scaled = (lut.astype(np.float64) * 2.0 ** s).astype(np.float32)
    assert np.all(np.abs(scaled) < 2.0 ** 29)
    lut_t = np.zeros((16, 16), np.float32)          # [x code][w code]
    lut_t[:nc, :nc] = scaled.T
    table = torch.from_numpy(scaled)
    codes = np.arange(nc)
    for x0 in range(nc):
        for x1 in range(nc):
            a, b = lut_t[x0], lut_t[x1]
            v = (codes[None, :] * 16 + codes[:, None]).reshape(-1)   # lo, hi
            kernel = (a[v & 15] + b[v >> 4]).astype(np.float32)
            w = torch.from_numpy(v)
            plain = (table[w & 15, x0] + table[w >> 4, x1]).numpy()
            np.testing.assert_array_equal(kernel.view(np.int32),
                                          plain.view(np.int32))


@pytest.mark.parametrize("sms", [132, 114, 7, 1])
@pytest.mark.parametrize("b", [1, 4, 32, 33])
@pytest.mark.parametrize("n,k", PROJECTIONS + [(1000, 4090), (1, 2)])
def test_split_plan_covers_k_once(n, k, b, sms):
    """Splits of whole steps cover the K / 2 weight bytes once, in order,
    none empty; the grid stays within one block an SM unless the row tiles
    alone exceed it."""
    ksplit, per = tlm.lut_product_plan(b, n, k, sms)
    steps = fc_tile.cdiv(k // 2, tlm.K6_STEP)
    assert ksplit >= 1 and per >= 1
    assert (ksplit - 1) * per < steps <= ksplit * per
    blocks = fc_tile.cdiv(n, tlm.K6_ROWS) * fc_tile.cdiv(b, tlm.K6_XROWS)
    assert ksplit * blocks <= max(sms, blocks)


def _emulate(x, packed, lut, sms):
    """K6's accumulation: the pair sums and f32 runs of four bytes as the
    kernel forms them, each run rounded to an int64, and the runs added
    the kernel's way: by the plan's splits in reverse, each split's runs
    from the last, a lane's runs (every G-th run of a step, G = 32 / BP)
    before the next lane's."""
    b, k = x.shape
    n, kb = packed.shape
    s = _scale(lut)
    table = (lut.astype(np.float64) * 2.0 ** s).astype(np.float32)
    w = packed.astype(np.int64)
    pairs = (table[(w & 15)[None], x[:, 0::2].astype(np.int64)[:, None]] +
             table[(w >> 4)[None], x[:, 1::2].astype(np.int64)[:, None]]
             ).astype(np.float32)                       # [B, N, K/2]
    pad = -kb % 4
    pairs = np.pad(pairs, ((0, 0), (0, 0), (0, pad)))
    p = pairs.reshape(b, n, -1, 4)
    run = ((p[..., 0] + p[..., 1]).astype(np.float32) + p[..., 2])
    run = (run.astype(np.float32) + p[..., 3]).astype(np.float32)
    ints = np.rint(run).astype(np.int64)                # ties to even
    ksplit, per = tlm.lut_product_plan(b, n, k, sms)
    runs_per_step = tlm.K6_STEP // 4
    bp = 4 if b <= 4 else 8 if b <= 8 else 16 if b <= 16 else 32
    g = 32 // bp
    total = np.zeros((b, n), np.int64)
    for sp in reversed(range(ksplit)):
        lo = sp * per * runs_per_step
        hi = min(ints.shape[-1], (sp + 1) * per * runs_per_step)
        idx = np.arange(lo, hi)
        for lane in range(g):
            for q in reversed(idx[(idx % runs_per_step) % g == lane]):
                total += ints[:, :, q]
    return (total.astype(np.float64).astype(np.float32).astype(np.float64)
            * 2.0 ** -s).astype(np.float32)


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("kind", ["outer", "tanh", "int"])
@pytest.mark.parametrize("b,n,k,nc", [(5, 130, 256, 16), (32, 40, 330, 16),
                                      (3, 77, 90, 9), (1, 1, 2, 4)])
def test_emulated_sums_match_plain_and_reference(rng, b, n, k, nc, kind,
                                                 sms):
    """The emulation equals the plain version bit for bit (exact integer
    sums in any order), is within 1e-4 of the JAX reference's oracle (an
    f32 sum over exactly K codes), and with an integer table equals the
    oracle exactly."""
    w = rng.integers(0, nc, size=(n, k)).astype(np.uint8)
    packed = w[:, 0::2] | (w[:, 1::2] << 4)
    x = rng.integers(0, nc, size=(b, k)).astype(np.uint8)
    lut = _lut(rng, nc, kind)
    got = _emulate(x, packed, lut, sms)
    plain = tref.lut_product_matmul_ref(torch.from_numpy(x),
                                        torch.from_numpy(packed),
                                        torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    oracle = np.asarray(jref.lut_product_matmul_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lut), n))
    if kind == "int":
        np.testing.assert_array_equal(got, oracle)
    else:
        np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
