"""Port parity for the paper's own model: the associative processor's
primitives, the ACSR format, and the Fig. 3 FC layer in bit-serial and
coded mode, against the JAX package on the same numpy inputs (its
emulator is host numpy; the port's runs here on CPU tensors).  Every
comparison is exact: outputs, cycles, rounds, all eight counters, the TAG
and the final CAM image."""
import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro.api import FCProblem as JFCProblem
from repro.core import acsr as jacsr
from repro.core import aida_fc as jfc
from repro.core import associative as jassoc
from repro_torch.core import acsr as tacsr
from repro_torch.core import aida_fc as tfc
from repro_torch.core import associative as tassoc

SEEDS = (0, 1, 2, 3)


def _same_ap(ref, port, what=""):
    np.testing.assert_array_equal(port.image(), ref.cam, err_msg=what)
    np.testing.assert_array_equal(port.tag.numpy(), ref.tag, err_msg=what)
    assert port.counters == ref.counters, what


def _ap_pair(rng, rows, bits):
    ref = jassoc.AP(rows, bits)
    port = tassoc.AP(rows, bits, device="cpu")
    image = rng.integers(0, 2, size=(rows, bits)).astype(np.uint8)
    ref.cam[:] = image
    port.cam.copy_(torch.from_numpy(image.T.copy()))
    return ref, port


@pytest.mark.parametrize("seed", SEEDS)
def test_ap_primitives_match_reference(seed):
    """Random sequences of compare (empty masks included), write,
    compare+write, move, if_match and set_tag: after every primitive the
    TAG, the CAM image and the counters equal the reference's."""
    rng = np.random.default_rng(seed)
    rows, bits = int(rng.integers(1, 60)), int(rng.integers(1, 14))
    ref, port = _ap_pair(rng, rows, bits)
    for step in range(120):
        op = rng.integers(0, 6)
        cols = rng.choice(bits, size=int(rng.integers(0, bits + 1)),
                          replace=False)
        key = rng.integers(0, 2, size=cols.size).astype(np.uint8)
        if op == 0:
            fuse = bool(rng.integers(0, 2))
            ref.compare(cols, key, fuse_write=fuse)
            port.compare(cols, key, fuse_write=fuse)
        elif op == 1:
            ref.write(cols, key)
            port.write(cols, key)
        elif op == 2:
            wcols = rng.choice(bits, size=int(rng.integers(0, bits + 1)),
                               replace=False)
            wbits = rng.integers(0, 2, size=wcols.size).astype(np.uint8)
            ref.compare_write(cols, key, wcols, wbits)
            port.compare_write(cols, key, wcols, wbits)
        elif op == 3:
            direction = ("up", "down")[rng.integers(0, 2)]
            stp = (1, 16)[rng.integers(0, 2)]
            ref.move(direction, stp)
            port.move(direction, stp)
        elif op == 4:
            assert ref.if_match() == port.if_match()
        else:
            tag = rng.random(rows) < 0.5
            ref.set_tag(tag)
            port.set_tag(tag)
        _same_ap(ref, port, f"seed {seed} step {step} op {op}")


@pytest.mark.parametrize("dist", range(41))
def test_move_by_matches_reference(dist):
    rng = np.random.default_rng(dist)
    for direction in ("up", "down"):
        ref, port = _ap_pair(rng, 37, 3)
        tag = rng.random(37) < 0.5
        ref.set_tag(tag)
        port.set_tag(tag)
        got, want = port.move_by(direction, dist), ref.move_by(direction, dist)
        assert got == want == tassoc.move_cycles(dist)
        _same_ap(ref, port, f"{direction} {dist}")


def test_move_rejects_other_steps_and_directions():
    ap = tassoc.AP(8, 2, device="cpu")
    with pytest.raises(ValueError):
        ap.move("up", 2)
    with pytest.raises(ValueError):
        ap.move("left", 1)


@pytest.mark.parametrize("signed", (False, True))
def test_field_load_and_read_match_reference(signed):
    """The vectorised load / read the FC driver uses, over all rows and
    one row, against the reference's per-bit loops (negative values load
    as two's complement, signed reads sign-extend)."""
    rng = np.random.default_rng(5)
    ref = jassoc.AP(9, 20)
    port = tassoc.AP(9, 20, device="cpu")
    f = jassoc.Field(3, 7)
    g = tassoc.Field(3, 7)
    vals = rng.integers(-64, 128, size=9)
    for r, v in enumerate(vals):
        ref.load_field(r, f, int(v))
    port.load_fields(g, torch.from_numpy(vals))
    np.testing.assert_array_equal(port.image(), ref.cam)
    got = port.read_fields(g, torch.arange(9), signed=signed)
    want = [ref.read_field(r, f, signed=signed) for r in range(9)]
    assert got.tolist() == want
    assert [int(port.read_fields(g, r, signed=signed))
            for r in range(9)] == want
    ref.load_field(4, f, 5, width=2)
    port.load_fields(g, torch.tensor([5]), slice(4, 5), width=2)
    np.testing.assert_array_equal(port.image(), ref.cam)
    np.testing.assert_array_equal(port.cam[4].numpy(), ref.read_column(4))


# ----------------------------------------------------------------- ACSR
def _dense(seed, n, k, density):
    rng = np.random.default_rng(seed)
    w = rng.integers(-9, 10, size=(n, k)) * (rng.random((n, k)) < density)
    return w.astype(np.float64)


ACSR_CASES = [  # (n, k, density, block)
    (7, 11, 0.4, 1), (7, 11, 0.4, 4), (16, 5, 0.6, 128), (1, 1, 1.0, 1),
    (6, 9, 0.0, 1), (6, 9, 0.0, 128), (10, 3, 0.2, 1), (12, 12, 1.0, 8)]


@pytest.mark.parametrize("n,k,density,block", ACSR_CASES)
def test_acsr_encode_decode_match_reference(n, k, density, block):
    """The stream (values, column indices, flags, seg ids, padding) equals
    the reference's, empty rows and all-zero matrices included; decode
    and seg_id_from_flags give the reference's arrays."""
    w = _dense(n * 100 + k, n, k, density)
    w[n // 2] = 0.0                                  # an empty row
    ref = jacsr.encode(w, block=block)
    out = tacsr.encode(w, block=block)
    assert out.shape == ref.shape and out.nnz == ref.nnz
    assert out.nnz_pad == ref.nnz_pad
    for name, arr in ref.tree().items():
        got = getattr(out, name)
        assert got.dtype == {"values": torch.float32, "col_idx": torch.int32,
                             "row_flag": torch.uint8,
                             "seg_id": torch.int32}[name]
        np.testing.assert_array_equal(got.numpy(), np.asarray(arr), name)
    np.testing.assert_array_equal(tacsr.decode(out).numpy(), jacsr.decode(ref))
    np.testing.assert_array_equal(
        tacsr.seg_id_from_flags(out.row_flag, out.nnz, n).numpy(),
        jacsr.seg_id_from_flags(np.asarray(ref.row_flag), ref.nnz, n))
    assert out.nnz / (n * k) == ref.density()
    # the fullest row, as the reference's FCProblem counts it
    assert tacsr.max_row_nnz(w) == JFCProblem(
        w=w.astype(np.int64), b=np.zeros(k, np.int64)).max_row_nnz


@pytest.mark.parametrize("seed", SEEDS)
def test_acsr_spmv_ref_matches_reference(seed):
    w = _dense(seed, 13, 17, 0.3).astype(np.float32)
    b = np.random.default_rng(seed).normal(size=17).astype(np.float32)
    ref = np.asarray(jacsr.spmv_ref(jacsr.encode(w, block=8), b))
    out = tacsr.spmv_ref(tacsr.encode(w, block=8), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), w @ b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ FC layer
@pytest.fixture
def ref_aps(monkeypatch):
    """The APs the reference's FC drivers make (to read their final CAM
    image): its module's AP, wrapped to record each instance."""
    made = []

    class Recorded(jassoc.AP):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(jfc, "AP", Recorded)
    return made


def _same_result(ref, port, ref_ap, what):
    np.testing.assert_array_equal(port.out.numpy(), ref.out, err_msg=what)
    assert port.cycles == ref.cycles, what
    assert port.rounds == ref.rounds, what
    assert port.nnz_b == ref.nnz_b, what
    assert port.max_row_nnz == ref.max_row_nnz, what
    assert port.counters == ref.counters, what
    assert _same_layout(port.layout, ref.layout), what
    np.testing.assert_array_equal(port.ap.image(), ref_ap.cam, err_msg=what)


def _same_layout(a, b):
    return all((getattr(a, f).base, getattr(a, f).width)
               == (getattr(b, f).base, getattr(b, f).width)
               for f in ("flag", "alive", "pos", "col_idx", "w", "w_sign",
                         "b", "b_sign", "c", "mv", "mv_last", "t", "carry",
                         "scr", "scr_a", "psign")) \
        and a.total_bits == b.total_bits


def _bitserial_problem(seed, m, n, size=None):
    rng = np.random.default_rng(seed)
    rows, cols = size or (int(rng.integers(3, 15)), int(rng.integers(3, 15)))
    w = (rng.integers(-(2 ** m) + 1, 2 ** m, size=(rows, cols))
         * (rng.random((rows, cols)) < (0.3 if size else 0.5)))
    b = (rng.integers(-(2 ** n) + 1, 2 ** n, size=cols)
         * (rng.random(cols) < (0.35 if size else 0.7)))
    return w, b


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m,n", [(2, 2), (2, 4), (4, 2), (4, 4)])
@pytest.mark.parametrize("activation", ("relu", None))
def test_bitserial_layer_matches_reference(ref_aps, seed, m, n, activation):
    w, b = _bitserial_problem(seed, m, n)
    ref = jfc.aida_fc_layer(w, b, m, n, activation=activation)
    port = tfc.aida_fc_layer(w, b, m, n, activation=activation, device="cpu")
    _same_result(ref, port, ref_aps[-1], f"{w.shape} m {m} n {n}")
    np.testing.assert_array_equal(port.out.numpy(),
                                  tfc.fc_reference(w, b, activation))


def _coded_problem(seed, size=None):
    rng = np.random.default_rng(100 + seed)
    cents_w = np.concatenate([[0], rng.integers(-99, 100, 15)])
    cents_a = np.concatenate([[0], rng.integers(-99, 100, 15)])
    rows, cols = size or (int(rng.integers(3, 15)), int(rng.integers(3, 15)))
    wc = rng.integers(0, 16, size=(rows, cols)) \
        * (rng.random((rows, cols)) < (0.3 if size else 0.4))
    bc = rng.integers(0, 16, size=cols) \
        * (rng.random(cols) < (0.35 if size else 0.6))
    return wc, bc, cents_w, cents_a


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("activation", ("relu", None))
def test_coded_layer_matches_reference(ref_aps, seed, activation):
    wc, bc, cw, ca = _coded_problem(seed)
    ref = jfc.aida_fc_layer_coded(wc, bc, cw, ca, activation=activation)
    port = tfc.aida_fc_layer_coded(wc, bc, cw, ca, activation=activation,
                                   device="cpu")
    _same_result(ref, port, ref_aps[-1], f"coded {wc.shape}")
    np.testing.assert_array_equal(
        port.out.numpy(), tfc.fc_reference_coded(wc, bc, cw, ca, activation))


@pytest.mark.parametrize("coded", (False, True))
@pytest.mark.parametrize("seed", (0, 1))
def test_layer_at_96_by_200_matches_reference(ref_aps, coded, seed):
    """The size chip_smoke.py holds the card against the CPU at."""
    if coded:
        wc, bc, cw, ca = _coded_problem(seed, (96, 200))
        ref = jfc.aida_fc_layer_coded(wc, bc, cw, ca)
        port = tfc.aida_fc_layer_coded(wc, bc, cw, ca, device="cpu")
    else:
        w, b = _bitserial_problem(seed, 4, 4, (96, 200))
        ref = jfc.aida_fc_layer(w, b, 4, 4)
        port = tfc.aida_fc_layer(w, b, 4, 4, device="cpu")
    _same_result(ref, port, ref_aps[-1], f"96 x 200 coded={coded}")
    assert ref.rounds > 3 and ref.nnz_b > 40


@pytest.mark.parametrize("block", (1, 8))
def test_degenerate_layers_match_reference(ref_aps, block):
    """An all-zero weight matrix, an all-zero activation vector, a single
    populated row and a padded stream (block 8)."""
    rng = np.random.default_rng(block)
    cases = [(np.zeros((4, 5), np.int64), rng.integers(-3, 4, 5)),
             (rng.integers(-3, 4, (4, 5)), np.zeros(5, np.int64)),
             (np.pad(rng.integers(1, 4, (1, 6)), ((2, 2), (0, 0))),
              rng.integers(-3, 4, 6))]
    for w, b in cases:
        ref = jfc.aida_fc_layer(w, b, 2, 2, block=block)
        port = tfc.aida_fc_layer(w, b, 2, 2, block=block, device="cpu")
        _same_result(ref, port, ref_aps[-1], f"{w.tolist()} {b.tolist()}")


def test_layer_rejects_out_of_range_operands():
    with pytest.raises(ValueError):
        tfc.aida_fc_layer(np.full((2, 2), 4), np.ones(2), 2, 2, device="cpu")
    with pytest.raises(ValueError):
        tfc.aida_fc_layer(np.ones((2, 2)), np.full(2, -4), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="structural zero"):
        tfc.aida_fc_layer_coded(np.ones((2, 2)), np.ones(2), np.ones(4),
                                np.zeros(4), device="cpu")
