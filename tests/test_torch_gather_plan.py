"""K1's gather variant (x of at most 8 columns, a decode step) on the CPU:
its source constants match the wrapper's, its scratch and counters follow
`split_plan` at every projection of llama3-8b and rwkv6-7b, and an
emulation of its arithmetic (one f32 chain a part in ascending slots,
parts then ranges added in order from 0, then the bias, then the
activation, the ranges merged by the row block's last block) is within
1e-4 of the plain version and of the JAX reference, and gives a column the
same bits at every width."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acsr as jacsr
from repro.kernels import acsr_spmv as jsp
from repro_torch.kernels import acsr_spmv as tsp
from repro_torch.kernels import ref as tref

CSRC = pathlib.Path(tsp.__file__).resolve().parents[1] / "csrc"
# (n_out, n_in) of every projection the decode step runs: llama3-8b's seven
# and rwkv6-7b's eight (both d 4096, d_ff 14336)
PROJECTIONS = sorted({(4096, 4096), (1024, 4096), (14336, 4096),
                      (4096, 14336)})
SMS = 132                       # H100 SXM
SMEM_PER_SM = 228 * 1024        # H100: shared memory an SM


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_source_constants_match_the_wrapper():
    """The gather variant's column bound and the chunk_off step are the
    wrapper's; the gather variant takes 3 blocks of 512 threads an SM
    (__launch_bounds__), and the source has one launch a call: no
    spmv_finalize after the gather kernel."""
    text = (CSRC / "acsr_spmv.cu").read_text()
    assert _const(text, "MAXB") == tsp.GATHER_COLS
    assert _const(text, "CHUNK") == tsp.CHUNK_COLS
    assert "__launch_bounds__(512, 3)\n    spmv_gather" in text
    start = text.index("int launch_gather(")
    launcher = text[start:text.index("template", start)]
    assert launcher.count("<<<") == 1 and "finalize" not in launcher


def _rmax(n_in, density=0.25, slack=1.1, pad=8):
    """A row's slot count at aida density 0.25: the mean plus the spread
    the chip runs show (rmax 1112-1136 at 4096 columns, 3760-3776 at
    14336), padded as block_encode pads."""
    return -(-int(n_in * density * slack) // pad) * pad


@pytest.mark.parametrize("n_out,n_in", PROJECTIONS)
@pytest.mark.parametrize("br", [128, 64, 32])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_plan_scratch_and_counters(n_out, n_in, br, batch):
    """What the wrapper hands the launcher is what the launcher accepts:
    the ranges cover the slots once ((nsplit - 1) * per < rmax <= nsplit
    * per), a block is 512 threads, the parts' sums fit the 48 KB of
    shared memory a launch takes without an opt-in, three blocks fit an
    SM, so the grid runs in one wave; the counters are one a row block,
    inside the kept-zero buffer's first 1024."""
    nb, rmax = n_out // br, _rmax(n_in)
    sy, nsplit, per = tsp.split_plan(nb, rmax, br, SMS)
    assert sy * br == 512
    assert (nsplit - 1) * per < rmax <= nsplit * per
    red = sy * br * batch * 4
    assert red <= 48 * 1024 and 3 * (red + 1024) <= SMEM_PER_SM
    assert nb <= 1024
    if br == 128:   # the engine's block_rows: one wave at three blocks
        assert nb * nsplit <= 3 * SMS


def _emulate(values, col_idx, row_nnz, cents, x, bias, act, sms):
    """The gather kernel's arithmetic in numpy f32, vectorised over rows
    and columns: part t of range s sums slots s0 + t, s0 + t + sy, ...
    below min(s0 + per, rmax, row_nnz) from 0 (a multiply rounded, then an
    add rounded: the card fuses them, which the tolerance covers); a
    range's sum is 0 + its parts in order; with one range it is the
    output, else 0 + the ranges in order; then the bias, then the
    activation."""
    nb, rmax, br = values.shape
    sy, nsplit, per = tsp.split_plan(nb, rmax, br, sms)
    w = cents[values] if cents is not None else values.astype(np.float32)
    nnz = row_nnz[:, None, :]                                # [nb, 1, br]
    ranges = []
    for s in range(nsplit):
        s0 = s * per
        top = min(s0 + per, rmax)
        v = np.zeros((nb, br, x.shape[1]), np.float32)
        for t in range(sy):
            acc = np.zeros_like(v)
            for slot in range(s0 + t, top, sy):
                live = (slot < nnz[:, 0, :])[..., None]
                prod = (w[:, slot, :, None] *
                        x[col_idx[:, slot, :].astype(np.int64)]
                        ).astype(np.float32)
                acc = np.where(live, (acc + prod).astype(np.float32), acc)
            v = (v + acc).astype(np.float32)
        ranges.append(v)
    if nsplit == 1:
        y = ranges[0]
    else:
        y = np.zeros_like(ranges[0])
        for v in ranges:
            y = (y + v).astype(np.float32)
    y = y.reshape(nb * br, -1)
    if bias is not None:
        y = (y + bias[:, None]).astype(np.float32)
    return tref.apply_activation(act, torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_emulated_merge_matches_plain_and_reference(rng, sms, act):
    """A coded 300 x 200 layer (3 row blocks, int16 ids, some empty rows):
    the emulation within 1e-4 of the plain version and of the JAX
    reference's oracle at widths 1, 4 and 8, and every column of every
    width bit-identical to the same column run alone."""
    dense = rng.normal(size=(300, 200)).astype(np.float32)
    dense[::7] = 0.0
    w = jacsr.prune_topk(dense, 0.3)
    cents = np.sort(rng.normal(size=16)).astype(np.float32)
    b = tsp.block_encode_coded(torch.from_numpy(w), torch.from_numpy(cents))
    vals, cols, nnz = (t.numpy() for t in (b.values, b.col_idx, b.row_nnz))
    rows = b.nblocks * b.block_rows
    bias = np.zeros(rows, np.float32)
    bias[:300] = rng.normal(size=300).astype(np.float32)
    xs = rng.normal(size=(200, 8)).astype(np.float32)
    alone = np.concatenate([_emulate(vals, cols, nnz, cents, xs[:, j:j + 1],
                                     bias, act, sms) for j in range(8)], 1)
    jb = jsp.block_encode_coded(w, jnp.asarray(cents), b.block_rows)
    for width in (1, 4, 8):
        x = xs[:, :width]
        got = _emulate(vals, cols, nnz, cents, x, bias, act, sms)
        np.testing.assert_array_equal(got, alone[:, :width])
        plain = tref.blocked_acsr_spmv_ref(
            b.values, b.col_idx, b.row_nnz, torch.from_numpy(x),
            b.centroids, torch.from_numpy(bias), act).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
        want = np.asarray(jsp.acsr_spmv(jb, jnp.asarray(x),
                                        bias=jnp.asarray(bias[:300]),
                                        activation=act, interpret=True))
        np.testing.assert_allclose(got[:300], want, rtol=1e-4, atol=1e-4)
