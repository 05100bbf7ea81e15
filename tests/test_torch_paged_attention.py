"""Port parity: the paged KV pool update and the K2 paged-attention wrapper
(CPU path = its plain version) against the JAX package on the same numpy
inputs.  The JAX kernel runs in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kvstore as jkvs
from repro_torch import bridge
from repro_torch import kvstore as tkvs

B, HKV, G, DH, PS, NPP = 3, 2, 2, 16, 4, 5
_jupdate = jax.jit(jkvs.update)


def _table(holes: bool):
    """Row 0 owns pages 1..5; row 1 has -1 holes; row 2 owns nothing."""
    t = np.full((B, NPP), -1, np.int32)
    t[0] = np.arange(1, NPP + 1)
    t[1] = [6, -1, 7, 8, -1] if holes else [6, 9, 7, 8, 10]
    return t


def _fill(kv_dtype, table, steps, rng, grow=False):
    """Drive both pools through the same token writes; returns (jax pool,
    port pool) after ``steps`` tokens of every row."""
    jp = jkvs.init_pool(11, HKV, PS, DH, kv_dtype=kv_dtype)
    tp = tkvs.init_pool(11, HKV, PS, DH, kv_dtype=kv_dtype)
    tt = torch.from_numpy(table)
    for t in range(steps):
        mag = (1.0 + t) if grow else 1.0     # growing amax forces rescales
        k = (rng.normal(size=(B, HKV, DH)) * mag).astype(np.float32)
        v = (rng.normal(size=(B, HKV, DH)) * mag).astype(np.float32)
        pos = np.full((B,), t, np.int32)
        jp = _jupdate(jp, jnp.asarray(table), jnp.asarray(k),
                      jnp.asarray(v), jnp.asarray(pos))
        tkvs.update(tp, tt, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(pos))
    return jp, tp


@pytest.mark.parametrize("holes", [False, True])
def test_update_bf16_bit_identical(holes):
    rng = np.random.default_rng(0)
    jp, tp = _fill("bf16", _table(holes), 2 * PS + 3, rng)
    ref = bridge.from_reference(jax.tree.map(np.asarray, jp))
    # page 0 is the shared sink: several idle rows write it in one scatter,
    # and neither framework defines which write wins
    for name in ("k_pages", "v_pages"):
        a, b = getattr(ref, name)[1:], getattr(tp, name)[1:]
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b), name
    assert tp.k_scale is None


@pytest.mark.parametrize("grow", [False, True])
def test_update_int8_within_one_lsb(grow):
    rng = np.random.default_rng(1)
    jp, tp = _fill("int8", _table(True), 2 * PS + 3, rng, grow=grow)
    ref = bridge.from_reference(jax.tree.map(np.asarray, jp))
    for codes, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
        a = getattr(ref, codes)[1:].int()
        b = getattr(tp, codes)[1:].int()
        assert (a - b).abs().max() <= 1, codes
        np.testing.assert_allclose(getattr(tp, scale)[1:].numpy(),
                                   getattr(ref, scale)[1:].numpy(),
                                   rtol=1e-6)
    if grow:
        assert (tp.k_scale[1:4] > 0).all()


@pytest.mark.parametrize("window", [-1, 3])
def test_attention_mask_matches(window):
    table = _table(True)
    cur = np.array([13, 9, 0], np.int32)
    ref = np.asarray(jkvs.attention_mask(jnp.asarray(table),
                                         jnp.asarray(cur),
                                         jnp.int32(window), PS))
    out = tkvs.attention_mask(torch.from_numpy(table),
                              torch.from_numpy(cur), window, PS).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kv_dtype,window,cap", [
    ("bf16", -1, None), ("bf16", 5, 2.0), ("int8", 6, None),
    ("int8", -1, 30.0)])
def test_paged_attention_matches_pallas(kv_dtype, window, cap):
    """Same pool, table and q: the port agrees with the Pallas decode
    kernel within 1e-5 (both upcast pages to f32; only the softmax's
    blocking differs).  Row 1 has -1 holes, row 2 owns no page at all."""
    rng = np.random.default_rng(2)
    table = _table(True)
    steps = 4 * PS + 1
    jp, _ = _fill(kv_dtype, table, steps, rng)
    tp = bridge.from_reference(jax.tree.map(np.asarray, jp))
    q32 = rng.normal(size=(B, HKV * G, DH)).astype(np.float32)
    q = np.asarray(jnp.asarray(q32).astype(jnp.bfloat16))
    cur = np.array([steps - 1, steps - 1, 2], np.int32)
    ref = np.asarray(jkvs.paged_attention_pallas(
        jnp.asarray(q), jp, jnp.asarray(table), jnp.asarray(cur),
        jnp.int32(window), scale=DH ** -0.5, cap=cap, interpret=True))
    out = tkvs.paged_attention(bridge.tensor(q), tp,
                               torch.from_numpy(table),
                               torch.from_numpy(cur), window,
                               scale=DH ** -0.5, cap=cap).numpy()
    assert out.dtype == np.float32 and out.shape == (B, HKV * G, DH)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
