"""Port parity for the int8 and codebook4 FC modes: quantization, codebook
packing, compression, the K4 / K5 wrappers (CPU path = their plain
versions), model-level compression, the bridge and the serves, against the
JAX package on the same numpy inputs.  The JAX kernels run in Pallas
interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CompressionSpec as JSpec
from repro.api import Engine as JEngine
from repro.api import Request as JRequest
from repro.api.compress import compress_params as jcompress_params
from repro.configs import get as jget
from repro.configs import reduced as jreduced
from repro.core import codebook as jcb
from repro.core import quant as jquant
from repro.core import sparse_fc as jsfc
from repro.kernels import int8_matmul as jint8
from repro.kernels import lut_matmul as jlut
from repro.kernels import tune as jtune
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.api.compress import compress_params
from repro_torch.configs import get, reduced
from repro_torch.core import codebook as tcb
from repro_torch.core import quant as tquant
from repro_torch.core import sparse_fc as tsfc
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import lut_matmul as tlut

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
JCFG = jreduced(jget("llama3-8b"), **SMALL)
CFG = reduced(get("llama3-8b"), **SMALL)
MAX_LEN = 32


@pytest.mark.parametrize("n,k", [(37, 24), (1, 8), (64, 33), (5, 1)])
def test_quantize_int_bit_identical(n, k):
    """Per-output-channel int8, as the int8 FC mode quantizes: codes and
    scales bit-identical to the reference, the plain K4 product within
    rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[n // 2] = 0.0                           # an all-zero channel
    w[-1, :4] = [0.5, -0.5, 1.5, 2.5][:k]     # exact halves: ties to even
    ref = jquant.quantize_int(jnp.asarray(w), bits=8, axis=0)
    out = tquant.quantize_int(torch.from_numpy(w))
    assert out.q.dtype == torch.int8
    assert out.scale.shape == (n, 1)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(tquant.dequantize_int(out).numpy(),
                                  np.asarray(jquant.dequantize_int(ref)))
    x = rng.normal(size=(3, k)).astype(np.float32)
    np.testing.assert_allclose(
        tint8.int8_matmul_ref(torch.from_numpy(x), out.q, out.scale).numpy(),
        np.asarray(jquant.int8_matmul_ref(jnp.asarray(x), ref)),
        rtol=1e-5, atol=1e-5)


def test_pack4_unpack4_match_reference():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, size=(5, 12)).astype(np.uint8)
    packed = tcb.pack4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jcb.pack4(jnp.asarray(codes))))
    assert torch.equal(tcb.unpack4(packed), torch.from_numpy(codes))
    # low nibble first
    assert int(packed[0, 0]) == int(codes[0, 0]) | (int(codes[0, 1]) << 4)
    with pytest.raises(ValueError, match="even"):
        tcb.pack4(torch.zeros((2, 3), dtype=torch.uint8))


def test_assign_matches_reference_and_chunks(monkeypatch):
    """Nearest centroid, the first on a tie, identical to the reference;
    running it in small chunks changes nothing."""
    rng = np.random.default_rng(2)
    cents = np.sort(rng.normal(size=16)).astype(np.float32)
    x = rng.normal(size=(40, 30)).astype(np.float32)
    x[0, :3] = [cents[2], (cents[4] + cents[5]) / 2, cents[15] + 1.0]
    ref = np.asarray(jcb.assign(jnp.asarray(x), jnp.asarray(cents)))
    out = tcb.assign(torch.from_numpy(x), torch.from_numpy(cents))
    assert out.dtype == torch.uint8 and out.shape == x.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    monkeypatch.setattr(tcb, "ASSIGN_CHUNK", 7)
    assert torch.equal(tcb.assign(torch.from_numpy(x),
                                  torch.from_numpy(cents)), out)


def _near_midpoint(w, cents, tol=1e-5):
    """Weights within ``tol`` of the midpoint of two neighbouring
    centroids (where a 1e-7 centroid difference may flip the code)."""
    mids = (cents[1:] + cents[:-1]) / 2
    return (np.abs(w[..., None] - mids) < tol).any(-1)


def test_codebook4_compress_matches():
    """codebook4: centroids within 1e-5 of the reference's k-means; codes
    equal except where a weight lies within 1e-5 of a midpoint between two
    centroids; the dense equivalent within 1e-5 elsewhere."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    ref = jsfc.compress(w, mode="codebook4")
    out = tsfc.compress(torch.from_numpy(w), mode="codebook4")
    rc = np.asarray(ref.centroids)
    np.testing.assert_allclose(out.centroids.numpy(), rc, rtol=0, atol=1e-5)
    assert out.codes_packed.shape == (48, 20)
    assert out.codes_packed.dtype == torch.uint8
    codes_t = tcb.unpack4(out.codes_packed).numpy()
    codes_r = np.asarray(jcb.unpack4(ref.codes_packed))
    differ = codes_t != codes_r
    assert not (differ & ~_near_midpoint(w, rc)).any()
    np.testing.assert_allclose(tsfc.dense_equivalent(out).numpy()[~differ],
                               jsfc.dense_equivalent(ref)[~differ],
                               rtol=0, atol=1e-5)


def test_int8_compress_bit_identical():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    ref = jsfc.compress(w, mode="int8")
    out = tsfc.compress(torch.from_numpy(w).T.contiguous().T, mode="int8")
    np.testing.assert_array_equal(out.qt.q.numpy(), np.asarray(ref.qt.q))
    np.testing.assert_array_equal(out.qt.scale.numpy(),
                                  np.asarray(ref.qt.scale))
    assert out.qt.scale.shape == (48, 1)
    np.testing.assert_array_equal(tsfc.dense_equivalent(out).numpy(),
                                  jsfc.dense_equivalent(ref))


FC_CASES = [  # (m, n, k, activation, bias)
    (4, 96, 64, None, False),
    (4, 130, 200, "silu", True),
    (32, 64, 128, "gelu", False),
    (5, 33, 18, "relu", True),
]


@pytest.mark.parametrize("m,n,k,act,has_bias", FC_CASES)
def test_int8_matmul_matches_pallas(m, n, k, act, has_bias):
    """Same int8 codes, scales and x: the port's wrapper (plain version on
    the CPU) against the Pallas int8 kernel, ragged shapes included, with
    bias and activation: rtol 1e-5, atol 1e-5 (f32 sum order)."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(n, k)).astype(np.float32)
    qt = jquant.quantize_int(jnp.asarray(w), bits=8, axis=0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32) if has_bias else None
    ref = np.asarray(jint8.int8_matmul(
        jnp.asarray(x), qt.q, qt.scale,
        bias=None if bias is None else jnp.asarray(bias), activation=act,
        interpret=True))
    out = tint8.int8_matmul(
        torch.from_numpy(x), bridge.tensor(qt.q), bridge.tensor(qt.scale),
        bias=None if bias is None else torch.from_numpy(bias),
        activation=act).numpy()
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,k,act,has_bias", FC_CASES)
def test_lut_matmul_matches_pallas(m, n, k, act, has_bias):
    """Same packed codes, centroids and x: the port's wrapper (plain
    version on the CPU) against the Pallas LUT kernel: rtol 1e-5, atol
    1e-5 (f32 sum order)."""
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 16, size=(n, k)).astype(np.uint8)
    packed = np.array(jcb.pack4(jnp.asarray(codes)))
    cents = np.sort(rng.normal(size=16)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32) if has_bias else None
    ref = np.asarray(jlut.lut_matmul(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(cents),
        bias=None if bias is None else jnp.asarray(bias), activation=act,
        interpret=True))
    out = tlut.lut_matmul(
        torch.from_numpy(x), torch.from_numpy(packed),
        torch.from_numpy(cents),
        bias=None if bias is None else torch.from_numpy(bias),
        activation=act).numpy()
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.mark.parametrize("mode", ["int8", "codebook4"])
def test_compress_params_and_bridge(jparams, mode):
    """Model-level compression stacks the reference's shapes (q [L,N,K],
    scale [L,N,1]; codes [L,N,K/2], centroids [L,16]) and byte counts;
    the bridge carries the reference's containers over, and a layer view
    applies them as the reference does (rtol 1e-5, atol 1e-5)."""
    spec = dict(mode=mode)
    jp, jstats = jcompress_params(jparams, JSpec(**spec), verbose=None)
    raw = bridge.from_reference(jax.tree.map(np.asarray, jparams))
    tp, tstats = compress_params(raw, CompressionSpec(**spec), verbose=None)
    for key in ("n_compressed", "bytes_dense", "bytes_compressed", "ratio"):
        assert tstats[key] == pytest.approx(jstats[key], rel=1e-12), key
    jleaf = jp["layers"]["mlp"]["gate"]
    tleaf = tp["layers"]["mlp"]["gate"]
    carried = bridge.from_reference(jax.tree.map(np.asarray, jleaf))
    if mode == "int8":
        L, n, k = tleaf.qt.q.shape
        assert tleaf.qt.scale.shape == (L, n, 1)
        assert torch.equal(tleaf.qt.q, carried.qt.q)
        assert torch.equal(tleaf.qt.scale, carried.qt.scale)
    else:
        L, n, kb = tleaf.codes_packed.shape
        assert tleaf.centroids.shape == (L, 16) and carried.codes_packed \
            .shape == (L, n, kb)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, jleaf.shape[1])).astype(np.float32)
    for i in range(L):
        ref = np.asarray(jsfc.apply_fc(
            jax.tree.map(lambda a: a[i], jleaf), jnp.asarray(x),
            activation="silu"))
        out = tsfc.apply_fc(carried.layer(i), torch.from_numpy(x),
                            activation="silu").numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    moved = bridge.to_device(carried, "cpu")
    assert moved.mode == mode and moved.shape == carried.shape


@pytest.fixture
def pallas_paged():
    saved = dict(jtune._CACHE)

    def pin(batch, page_size, chunk):
        geo = (JCFG.n_kv, JCFG.n_heads // JCFG.n_kv, JCFG.head_dim,
               page_size, MAX_LEN // page_size, batch)
        jtune.record(jtune.paged_key(*geo, False, True),
                     jtune.KernelChoice("pallas", (("pb", 2),)))
        jtune.record(jtune.paged_chunk_key(*geo, chunk, False, True),
                     jtune.KernelChoice("pallas", (("pb", 2),
                                                   ("qt", chunk))))
    yield pin
    jtune._CACHE.clear()
    jtune._CACHE.update(saved)


@pytest.mark.parametrize("mode", ["int8", "codebook4"])
def test_fc_mode_serve_matches_reference_engine(jparams, pallas_paged,
                                                mode):
    """int8 and codebook4 serves at chunk 4 against the reference Engine
    on the same weights: int8 the port compresses itself (bit-identical
    codes); codebook4 it takes over through the bridge (k-means
    centroids agree only within 1e-5).  Tokens agree up to near-tie
    flips; no page leaks."""
    chunk = 4
    pallas_paged(2, 16, chunk)
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8], [9, 10, 11]]
    jeng = JEngine(JCFG, params=jparams).compress(JSpec(mode=mode))
    ref = jeng.serve([JRequest(prompt=p, max_new=5, rid=i)
                      for i, p in enumerate(prompts)], batch_slots=2,
                     max_len=MAX_LEN, scheduler={"chunk": chunk})
    if mode == "int8":
        raw = bridge.from_reference(jax.tree.map(np.asarray, jparams))
        eng = Engine(CFG, params=raw, device="cpu").compress(
            CompressionSpec(mode=mode))
    else:
        eng = Engine(CFG, params=bridge.from_reference(
            jax.tree.map(np.asarray, jeng.params)), device="cpu")
    sess = eng.session(batch_slots=2, max_len=MAX_LEN,
                       scheduler={"chunk": chunk})
    for i, p in enumerate(prompts):
        sess.submit(Request(prompt=p, max_new=5, rid=i))
    out = sess.run()
    assert [r.rid for r in out] == [r.rid for r in ref]
    for r, o in zip(ref, out):
        for j, (a, b) in enumerate(zip(r.tokens, o.tokens)):
            if a != b:
                assert sess.margins[o.rid][j] < 1e-2, (o.rid, j)
                break
    assert sess.alloc.in_use == 0
    assert sess.stats["nonfinite_logit_rows"] == 0
