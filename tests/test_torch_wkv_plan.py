"""K9 (the rwkv6 WKV scan) on the CPU: its launch plan, read from
``csrc/linear_scan.cu``, fits the card for every head size it takes, and a
plain torch emulation of its register tile (row groups of DKP / RG rows,
each summing its rows' r . S from 0 in ascending rows) and of its deferred
output sum (the RG partials added in row-group order, then the bonus v_t
* (r_t . (u * k_t))) is within 1e-4 of the plain version and of the JAX
package's Pallas kernel, run in interpret mode, on inputs made with numpy
from a seed; decays near 0 stay exact."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import rwkv6_fwd as jrwkv6_fwd
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import ref as tref

SOURCE = (pathlib.Path(tls.__file__).resolve().parents[1] / "csrc"
          / "linear_scan.cu").read_text()
SMEM_PER_BLOCK = 232448         # H100: shared memory a block can take


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


RG, CW, NCOL, PD = (_const(n) for n in ("RG", "CW", "NCOL", "PD"))
DKPS = (16, 32, 64, 128)        # the launcher's padded head sizes


def _steps(dkp):
    """Time steps a pass (pass_steps in the source)."""
    return 8 if dkp > 64 else 16


def _dkp(dk):
    return next(p for p in DKPS if dk <= p)


def _layout(dkp, elem):
    """The source's Layout<TIn, DKP>, every offset and its bytes, by
    evaluating the struct's own expressions in order (sizeof and C's
    ``a ? b : c`` rewritten for Python); elem is sizeof(TIn)."""
    body = SOURCE[SOURCE.index("struct Layout {"):]
    body = body[:body.index("};")]
    env = {"DKP": dkp, "NCOL": NCOL, "RG": RG, "PD": PD,
           "pass_steps": _steps, "RAW": elem != 4}
    for name, expr in re.findall(
            r"static constexpr (?:int|size_t) (\w+) =\s*([^;]+);", body):
        expr = expr.replace("sizeof(float)", "4").replace("sizeof(TIn)",
                                                          str(elem))
        expr = re.sub(r"\((\w+) \? (.+) : (.+)\)", r"((\2) if \1 else (\3))",
                      expr)
        env[name] = eval(expr, {}, env)
    return env


def test_source_plan_is_the_documented_one():
    """The launcher's dispatch covers Dk 1-128 with the padded sizes above,
    a block is RG row groups by NCOL / CW column groups, one barrier a
    round, no shuffle in the step loop, and the layout the test sizes is
    the source's."""
    assert "constexpr int THREADS = RG * NCOL / CW;" in SOURCE
    assert _const("MAX_SMEM") == SMEM_PER_BLOCK
    for dkp in DKPS:
        assert f"launch_t<TIn, {dkp}>" in SOURCE
    assert "return dkp > 64 ? 8 : 16;" in SOURCE
    for dkp in DKPS:
        lay = _layout(dkp, 2)
        offsets = [lay[n] for n in ("u", "r", "k", "w", "v", "p", "c", "raw")]
        assert offsets == sorted(offsets) and offsets[0] == 0
        assert lay["CT"] == _steps(dkp)
    kernel = SOURCE[SOURCE.index("rwkv6_kernel(const"):
                    SOURCE.index("template <typename TIn, int DKP>\nint "
                                 "launch_t")]
    loop = kernel[kernel.index("for (int kk = 0;"):]
    assert loop.count("__syncthreads()") == 1
    scan = loop[loop.index("for (int t = 0; t < n; ++t)"):]
    assert "__shfl" not in scan[:scan.index("if (kk + 1 < nch)")]


@pytest.mark.parametrize("dk", [8, 16, 24, 32, 64, 100, 128])
@pytest.mark.parametrize("dv", [8, 64, 100, 256])
@pytest.mark.parametrize("elem", [2, 4])
def test_launch_plan_fits(dk, dv, elem):
    """Every head the kernel takes (Dk 8-128, Dv up to 256, bf16 or f32 r /
    k / v): a block of whole warps within 1024 threads, R = DKP / RG rows
    a thread, shared memory within the block's 227 KB, and the column
    tiles cover Dv."""
    dkp = _dkp(dk)
    threads = RG * NCOL // CW
    assert threads % 32 == 0 and threads <= 1024
    assert dkp % RG == 0 and dkp // RG >= 1
    assert NCOL % 4 == 0            # the output sum: 4 columns a thread
    assert _layout(dkp, elem)["bytes"] <= SMEM_PER_BLOCK
    tiles = -(-dv // NCOL)
    assert (tiles - 1) * NCOL < dv <= tiles * NCOL


def _emulate(r, k, v, w, u):
    """K9's arithmetic in torch f32: thread tile rows in row groups of
    DKP / RG, each group's r . S summed from 0 over its rows in order (a
    multiply rounded, then an add: the card fuses them, which the
    tolerance covers), the groups added in order from 0, then the bonus
    v * c with c = r . (u * k) (summed in row order here; the card's warp
    sum differs by rounding); S = w * S + k * v, k * v rounded first."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    rr = _dkp(dk) // RG
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    s = torch.zeros((b, h, dk, dv))
    out = []
    for i in range(t):
        ri, ki, vi, wi = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]
        o = torch.zeros((b, h, dv))
        for g0 in range(0, dk, rr):
            part = torch.zeros((b, h, dv))
            for row in range(g0, min(g0 + rr, dk)):
                part = part + ri[:, :, row, None] * s[:, :, row]
            o = o + part
        c = torch.zeros((b, h))
        for row in range(dk):
            c = c + ri[:, :, row] * (u[None, :, row] * ki[:, :, row])
        out.append(o + vi * c[..., None])
        s = wi[..., None] * s + ki[..., None] * vi[:, :, None, :]
    return torch.stack(out, dim=2)


def _inputs(rng, b, h, t, dk, dv):
    r = rng.normal(size=(b, h, t, dk)).astype(np.float32) * .5
    k = rng.normal(size=(b, h, t, dk)).astype(np.float32) * .5
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.normal(size=(b, h, t, dk)))).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    return r, k, v, w, u


# the reference's own kernel test shapes, a head of 64 (rwkv6-7b's) whose
# row groups hold 4 rows, and Dk 128 (8 rows a group)
@pytest.mark.parametrize("t,chunk,dk,dv", [(128, 32, 16, 16),
                                           (64, 64, 32, 64),
                                           (96, 16, 8, 8),
                                           (32, 32, 64, 64),
                                           (16, 16, 128, 24)])
def test_tile_emulation_matches_plain_and_reference(rng, t, chunk, dk, dv):
    """rtol = atol = 1e-4 against the plain version and the JAX package's
    Pallas kernel (interpret mode), the limits chip_smoke holds K9 to."""
    args = _inputs(rng, 2, 2, t, dk, dv)
    got = _emulate(*map(torch.from_numpy, args)).numpy()
    plain = tref.rwkv6_ref(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jrwkv6_fwd(*map(jnp.asarray, args), chunk=chunk,
                                 interpret=True))
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tile_emulation_tiny_decay_stays_exact():
    """The reference's tiny-decay case (r = k = 0.1, v = 1, w = 1e-9, u =
    0) within its 1e-5 / 1e-6: the tile keeps the exact recurrence."""
    b, h, t, d = 1, 1, 64, 8
    full = lambda val: np.full((b, h, t, d), val, np.float32)
    args = (full(0.1), full(0.1), full(1.0), full(1e-9),
            np.zeros((h, d), np.float32))
    got = _emulate(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jrwkv6_fwd(*map(jnp.asarray, args), chunk=16,
                                 interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    plain = tref.rwkv6_ref(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
