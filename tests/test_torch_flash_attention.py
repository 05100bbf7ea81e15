"""Port parity for K7 / K8: the plain versions of the flash kernels
against the JAX package's Pallas kernels (interpret mode), and the port's
``ops.attention(impl="flash")`` gradients against ``jax.grad`` of the
reference's ``ops.attention(impl="flash")``, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import module_compile_cache  # noqa: F401
from port_test_env import one_torch_thread  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from repro_torch import bridge
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

# the grid of tests/test_kernels.py:82-85
GRID = [(True, None, None, 4), (True, 64, None, 2), (True, None, 30.0, 4),
        (False, None, None, 1), (True, 128, 50.0, 2)]
# Plain version vs Pallas kernel: both f32 with the same mask and cap;
# only the summation order differs (whole rows vs 64-wide tiles).
TOL = dict(rtol=1e-5, atol=1e-5)
# gradients: dk / dv sum T * G products each, up to ~10 in size here
GRAD_TOL = dict(rtol=1e-5, atol=2e-5)


def _inputs(rng, b, h, hkv, t, d, dtype=np.float32):
    q = (rng.normal(size=(b, h, t, d)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, hkv, t, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, hkv, t, d)).astype(np.float32)
    do = rng.normal(size=(b, h, t, d)).astype(np.float32)
    if dtype != np.float32:
        q, k, v = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
        q, k, v = (np.asarray(x) for x in (q, k, v))
    return q, k, v, do


def _t(x):
    return bridge.tensor(x)


@pytest.mark.parametrize("causal,window,softcap,hkv", GRID)
def test_plain_fwd_matches_pallas(rng, causal, window, softcap, hkv):
    q, k, v, _ = _inputs(rng, 2, 4, hkv, 128, 32)
    o, lse = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, softcap=softcap, bq=64,
                                 bk=64)
    to, tlse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                      window=window, softcap=softcap)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **TOL)


@pytest.mark.parametrize("causal,window,softcap,hkv", GRID)
def test_plain_bwd_matches_pallas(rng, causal, window, softcap, hkv):
    q, k, v, do = _inputs(rng, 2, 4, hkv, 128, 32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_fwd(jq, jk, jv, bq=64, bk=64, **kw)
    want = flash_attention_bwd(jq, jk, jv, o, lse, jdo, bq=64, bk=64, **kw)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(np.asarray(o)),
                                 _t(np.asarray(lse)), _t(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_fwd_bwd_bf16_inputs(rng):
    """bf16 q / k / v as the model feeds them: both sides upcast the same
    bf16 values, so the f32 tolerance holds."""
    q, k, v, do = _inputs(rng, 1, 4, 2, 64, 64, dtype=jnp.bfloat16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = flash_attention_fwd(jq, jk, jv, bq=32, bk=32)
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert tq.dtype == torch.bfloat16
    to, tlse = fa.flash_attention_fwd(tq, tk, tv)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **TOL)
    want = flash_attention_bwd(jq, jk, jv, o, lse, jnp.asarray(do), bq=32,
                               bk=32)
    got = fa.flash_attention_bwd(tq, tk, tv, to, tlse, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 72, 30.0), (False, None, None)])
def test_plain_fwd_matches_pallas_at_the_training_head_dim(rng, causal,
                                                           window, softcap):
    """K7's shape on the training path: bf16 q / k / v, head dim 128, a
    query group of 4, and the 64 x 64 tiles K7 walks (here two, so one is
    cut by the causal diagonal and, windowed, one by the window's edge):
    the plain version against the Pallas kernel at bq = bk = 64."""
    q, k, v, _ = _inputs(rng, 1, 8, 2, 128, 128, dtype=jnp.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), bq=64, bk=64, **kw)
    to, tlse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **TOL)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 5, 20.0), (False, 7, None)])
def test_plain_ragged_t_matches_reference_oracle(rng, causal, window,
                                                  softcap):
    """T = 45 (the kernels mask a ragged tail; the Pallas kernel asserts T
    is a tile multiple, so the jnp oracle and its autodiff stand in):
    forward 1e-5, gradients 2e-4 as in tests/test_kernels.py."""
    q, k, v, do = _inputs(rng, 2, 4, 2, 45, 32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jref.attention_ref(jq, jk, jv, **kw)
    o, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        ref.attention_ref(_t(q), _t(k), _t(v), **kw).numpy(),
        np.asarray(want), **TOL)
    grads = jax.grad(lambda a, b, c: (jref.attention_ref(a, b, c, **kw)
                                      * jnp.asarray(do)).sum(),
                     argnums=(0, 1, 2))(jq, jk, jv)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype,causal,window,softcap,hkv", [
    (np.float32, True, None, None, 2), (np.float32, True, 32, 30.0, 1),
    (np.float32, False, None, None, 4), (jnp.bfloat16, True, None, None, 2)])
def test_ops_attention_grads_match_reference(rng, dtype, causal, window,
                                             softcap, hkv):
    """The port's ``_Flash`` autograd function against ``jax.grad`` of the
    reference's ``custom_vjp``: output and dq / dk / dv within 1e-5 in f32;
    in bf16 both round o and the gradients to bf16, so within 2 bf16 ulps
    (1.6e-2 relative) of each other."""
    q, k, v, w = _inputs(rng, 2, 4, hkv, 64, 32, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jloss(a, b, c):
        o = jops.attention(a, b, c, impl="flash", bq=32, bk=32, **kw)
        return (o.astype(jnp.float32) * jnp.asarray(w)).sum()

    jo = jops.attention(jq, jk, jv, impl="flash", bq=32, bk=32, **kw)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    to = ops.attention(tq, tk, tv, impl="flash", **kw)
    assert to.dtype == tq.dtype
    (to.float() * _t(w)).sum().backward()
    tol = TOL if dtype == np.float32 else dict(rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo, np.float32), **tol)
    for t, g in zip((tq, tk, tv), jg):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g, np.float32), **tol)


def test_ops_attention_ref_impl_matches_flash(rng):
    """impl="ref" (masked softmax, autograd) and impl="flash" agree."""
    q, k, v, w = _inputs(rng, 1, 4, 2, 48, 32)
    outs = []
    for impl in ("ref", "flash"):
        ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
        o = ops.attention(*ts, window=16, softcap=25.0, impl=impl)
        (o * _t(w)).sum().backward()
        outs.append([o.detach()] + [t.grad for t in ts])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    q, k, v, _ = _inputs(rng, 1, 4, 2, 16, 32)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd(_t(q), _t(k), _t(v), window=0)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(_t(q), _t(k), _t(v), impl="einsum")
    q3 = torch.zeros((1, 3, 16, 32))
    with pytest.raises(ValueError, match="do not fit"):
        fa._check(q3, _t(k), _t(v))
    with pytest.raises(ValueError, match="head dims"):
        fa._check(torch.zeros((1, 4, 16, 48)), torch.zeros((1, 2, 16, 48)),
                  torch.zeros((1, 2, 16, 48)))
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa._check(_t(q).half(), _t(k).half(), _t(v).half())
    rows = torch.zeros((1, 4, 16, 1))
    with pytest.raises(ValueError, match="do must be shaped"):
        fa._check(_t(q), _t(k), _t(v), _t(q), rows[..., 0], rows)
    with pytest.raises(TypeError, match="must be f32"):
        fa._check(_t(q), _t(k), _t(v), _t(q).double(), rows, rows)
