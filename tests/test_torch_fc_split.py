"""The int8 (K4) and codebook4 (K5) FC kernels' split plan and arithmetic,
on the CPU: the plan takes no row count and covers K once, in order; the
CUDA sources' constants match it; an emulation of the kernels' arithmetic
(bf16 hi / lo parts, f32 sums of the tensor cores' 16-term steps, warps
and splits added in order) is within the card's tolerance of the plain
versions and of the Pallas kernels, and a hi-only emulation is not; K5's
table of bf16 pairs maps each code byte back to its two centroids."""
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as jint8
from repro.kernels import lut_matmul as jlut
from repro_torch.core import codebook as tcb
from repro_torch.core import sparse_fc as tsfc
from repro_torch.kernels import fc_tile
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import lut_matmul as tlut

CSRC = pathlib.Path(fc_tile.__file__).resolve().parents[1] / "csrc"
PROJECTIONS = [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
               (14336, 4096), (14336, 4096), (4096, 14336)]   # llama3-8b
# the card's tolerance of K4 / K5 against their plain versions
RTOL = ATOL = 1e-4


def test_split_plan_takes_no_row_count():
    """A row's sum order, and bits, depend on the weights' shape and the
    card only: never on how many rows share the call."""
    assert list(inspect.signature(fc_tile.split_plan).parameters) == \
        ["n", "k", "sms"]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("n,k", sorted(set(PROJECTIONS)) +
                         [(4096, 4000), (130, 200), (33, 18), (64, 4096)])
def test_split_plan_covers_k_once_in_order(n, k, sms):
    """Ranges start at k 0, follow one another with no gap or overlap, end
    at K, start on a stage, hold equal whole stages but the last, none is
    empty, and the grid stays within BLOCKS_PER_SM blocks an SM (one wave)
    unless the channel tiles alone exceed it."""
    plan = fc_tile.split_plan(n, k, sms)
    assert plan[0][0] == 0 and plan[-1][1] == k
    per = plan[0][1] - plan[0][0]
    for i, (k0, k1) in enumerate(plan):
        assert k0 < k1 and k0 % fc_tile.BK == 0
        if i + 1 < len(plan):
            assert plan[i + 1][0] == k1
            assert k1 - k0 == per and per % fc_tile.BK == 0
    tiles = fc_tile.cdiv(n, fc_tile.BN)
    assert len(plan) * tiles <= max(fc_tile.BLOCKS_PER_SM * sms, tiles)


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_source_constants_match_the_plan():
    """The kernels tile with the plan's BN and BK, take tile_rows(M) rows
    a block (8, then 32), and read BK k of a row a stage: 128 int8 bytes,
    or 64 bytes of two codes each."""
    tile = (CSRC / "fc_tile.cuh").read_text()
    assert _const(tile, "BN") == fc_tile.BN
    assert _const(tile, "BK") == fc_tile.BK
    small, big = map(int, re.search(
        r"if \(M <= (\d+)\)\s*return launch_mt<1, 1>.*?"
        r"return launch_mt<(\d+), CG4>",
        tile, re.S).groups())
    assert [fc_tile.tile_rows(m) for m in (1, small, small + 1, 32)] == \
        [8, 8, 8 * big, 8 * big] and small == 8
    for src, kpb, row in (("int8_matmul.cu", 1, "fc::BK"),
                          ("lut_matmul.cu", 2, "fc::BK / 2")):
        text = (CSRC / src).read_text()
        assert f"static constexpr int ROW = {row};" in text
        assert f"static constexpr int KPB = {kpb};" in text


# ------------------------------------------------------------ emulation
def _split(t):
    """f32 -> (hi, lo) bf16 parts, as float64 (mma_tile.cuh's split)."""
    hi = t.to(torch.bfloat16)
    lo = (t - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def _emulate(terms, plan, k):
    """The kernels' sum of x [M, K] against W [N, K] given as its tensor-core
    products ``terms`` [(x part, w part), ...] in the order the kernel
    issues them: within a stage of BK, warp w's step j sums the 16 k
    32w + 8c + 4j + e (c, e < 4) exactly into its f32 accumulator; the
    four warps are added in order, then the splits of ``plan``."""
    m, n = terms[0][0].shape[0], terms[0][1].shape[0]
    bk = fc_tile.BK
    steps = []
    for xp, wp in terms:
        pad = fc_tile.cdiv(k, bk) * bk - k
        xr = torch.nn.functional.pad(xp, (0, pad)).reshape(m, -1, 4, 4, 2, 4)
        wr = torch.nn.functional.pad(wp, (0, pad)).reshape(n, -1, 4, 4, 2, 4)
        steps.append(torch.einsum("aswcje,bswcje->abswj", xr, wr))
    out = None
    for k0, k1 in plan:
        acc = torch.zeros((m, n, 4), dtype=torch.float32)
        for st in range(k0 // bk, fc_tile.cdiv(k1, bk)):
            for j in range(2):
                for s in steps:
                    acc = (acc.double() + s[:, :, st, :, j]).float()
        v = acc[..., 0]
        for w in range(1, 4):
            v = v + acc[..., w]
        out = v if out is None else out + v
    return out


def _pair_table(cents):
    """Codes4::build_table (lut_matmul.cu): byte b -> bf16 pairs (hi, lo)
    of (c[b & 15], c[b >> 4]), the even k (low nibble) in the low half;
    returned as [256, 2] float64 values of each half."""
    b = torch.arange(256)
    hi, lo = _split(cents.float())
    pairs = lambda part: torch.stack([part[b & 15], part[b >> 4]], dim=1)
    return pairs(hi), pairs(lo)


def _k5_parts(codes_packed, cents):
    """W's hi and lo parts [N, K] decoded through the pair table: byte j
    of a row gives k 2j (its low half) and 2j + 1 (its high half)."""
    thi, tlo = _pair_table(cents)
    idx = codes_packed.long()
    part = lambda t: t[idx].reshape(codes_packed.shape[0], -1)
    return part(thi), part(tlo)


def _operands(mode, m, n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) * k ** -0.5).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    return torch.from_numpy(x), tsfc.compress(torch.from_numpy(w), mode=mode)


def _kernel_emulation(mode, x, layer, plan, hi_only=False):
    k = x.shape[1]
    xh, xl = _split(x)
    if mode == "int8":
        q = layer.qt.q.double()
        terms = [(xh, q)] if hi_only else [(xh, q), (xl, q)]
        return _emulate(terms, plan, k) * layer.qt.scale.reshape(1, -1)
    ch, cl = _k5_parts(layer.codes_packed, layer.centroids)
    terms = [(xh, ch)] if hi_only else [(xh, ch), (xl, ch), (xh, cl)]
    return _emulate(terms, plan, k)


def _plain(mode, x, layer):
    if mode == "int8":
        return tint8.int8_matmul_ref(x, layer.qt.q, layer.qt.scale)
    return tlut.lut_matmul_ref(x, layer.codes_packed, layer.centroids)


@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("mode", ["int8", "codebook4"])
@pytest.mark.parametrize("m,sms", [(4, 132), (32, 8)])
def test_emulation_is_within_the_tolerance(mode, k, m, sms):
    """bf16 hi + lo parts on f32 tensor-core sums, in the kernel's order,
    stay within rtol / atol 1e-4 of the f32 plain version."""
    x, layer = _operands(mode, m, 64, k, seed=k + m)
    got = _kernel_emulation(mode, x, layer, fc_tile.split_plan(64, k, sms))
    assert torch.allclose(got, _plain(mode, x, layer), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("mode", ["int8", "codebook4"])
def test_hi_only_emulation_misses_the_tolerance(mode, k):
    """Without the lo parts the error is ~1e-3: the tolerance tells the
    kernel's arithmetic from one that drops them."""
    x, layer = _operands(mode, 4, 64, k, seed=k)
    got = _kernel_emulation(mode, x, layer, fc_tile.split_plan(64, k, 132),
                            hi_only=True)
    assert not torch.allclose(got, _plain(mode, x, layer), rtol=RTOL,
                              atol=ATOL)


@pytest.mark.parametrize("mode", ["int8", "codebook4"])
def test_emulation_matches_pallas(mode):
    """The emulated kernel against the reference's Pallas kernel
    (interpret mode) on the same inputs, with bias and silu."""
    x, layer = _operands(mode, 4, 96, 4096, seed=7)
    bias = torch.from_numpy(np.random.default_rng(8).normal(
        size=96).astype(np.float32))
    got = torch.nn.functional.silu(
        _kernel_emulation(mode, x, layer, fc_tile.split_plan(96, 4096, 132))
        + bias)
    xj, bj = jnp.asarray(x.numpy()), jnp.asarray(bias.numpy())
    if mode == "int8":
        ref = jint8.int8_matmul(xj, jnp.asarray(layer.qt.q.numpy()),
                                jnp.asarray(layer.qt.scale.numpy()),
                                bias=bj, activation="silu")
    else:
        ref = jlut.lut_matmul(xj, jnp.asarray(layer.codes_packed.numpy()),
                              jnp.asarray(layer.centroids.numpy()),
                              bias=bj, activation="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_pair_table_maps_each_byte_back():
    """Every byte's entry gives (c[low nibble], c[high nibble]) as hi + lo
    within 2^-16 of each centroid, the low nibble (even k) in the low
    half, and the kernel builds it that way."""
    cents = torch.from_numpy(np.sort(np.random.default_rng(9).normal(
        size=16)).astype(np.float32))
    thi, tlo = _pair_table(cents)
    b = torch.arange(256, dtype=torch.uint8)
    want = cents.double()[tcb.unpack4(b[:, None]).long()]   # [256, 2]
    got = thi + tlo
    assert torch.all((got - want).abs() <= want.abs() * 2.0 ** -16)
    assert torch.equal(thi, want.float().to(torch.bfloat16).double())
    src = (CSRC / "lut_matmul.cu").read_text()
    assert "ev = mt::split(cents[b & 15])" in src
    assert "od = mt::split(cents[b >> 4])" in src
    assert "make_uint2(mt::pack(ev.hi, od.hi), mt::pack(ev.lo, od.lo))" \
        in src


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes y:x (x the low four)."""
    b = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> 4 * i) & 7] for i in range(4)),
                          "little")


def _bf16x2(word):
    """The two bf16 halves of a 32-bit word as floats (low half first)."""
    h = torch.tensor([word & 0xFFFF, word >> 16], dtype=torch.int32)
    return (h << 16).view(torch.float32).tolist()


def test_int8_decode_is_exact():
    """The int8 -> bf16 decode of int8_matmul.cu, emulated from its own
    masks and byte selectors over every byte in every position: the
    difference of the two bf16 pairs is the int8 value, exactly."""
    src = (CSRC / "int8_matmul.cu").read_text()
    body = src[src.index("void i8x4_bf16"):src.index("struct Int8Rows")]
    masks = [int(h, 16) for h in re.findall(r"w & (0x[0-9a-f]+)u", body)]
    perms = re.findall(r"__byte_perm\((\w), (0x[0-9a-f]+)u, (0x[0-9a-f]+)\)",
                       body)
    assert masks == [0x7F7F7F7F, 0x80808080] and len(perms) == 4
    for v in range(256):
        for pos in range(4):
            w = v << (8 * pos) | (0x5A << (8 * ((pos + 1) % 4)))
            parts = {"l": w & masks[0], "s": w & masks[1]}
            a, b, c, d = (_bf16x2(_byte_perm(parts[x], int(y, 16),
                                             int(sel, 16)))
                          for x, y, sel in perms)
            got = [a[0] - b[0], a[1] - b[1], c[0] - d[0], c[1] - d[1]]
            want = [int.from_bytes(w.to_bytes(4, "little")[i:i + 1],
                                   "little", signed=True) for i in range(4)]
            assert got == want, (hex(w), got, want)
