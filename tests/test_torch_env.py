"""The port's `REPRO_*` knobs (``repro_torch.api.env``) against the JAX
package's ``repro.api.env``: every knob parsed as the reference parses it,
and where the port honours them — the session's KV defaults, the full
cache's ``select`` update strategy (bit for bit ``scatter`` and the
reference's ``select``) and ``REPRO_BF16_PSUM`` in a raw projection."""
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_test_env import one_torch_thread  # noqa: F401
from repro.api import env as jenv
from repro.models import kvcache as jkvc
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.api import env as tenv
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as tlayers

VARS = ("REPRO_KV_CACHE", "REPRO_KV_DTYPE", "REPRO_KV_UPDATE",
        "REPRO_AUTOTUNE", "REPRO_TUNE_BLOCK_ROWS", "REPRO_BF16_PSUM",
        "REPRO_PALLAS_INTERPRET")
KNOBS = ("KV_CACHE", "KV_DTYPE", "KV_UPDATE", "AUTOTUNE", "TUNE_BLOCK_ROWS",
         "BF16_PSUM", "PALLAS_INTERPRET")
# per variable: (default, on, a stray value)
LEVELS = {"REPRO_KV_CACHE": ("auto", "full", "dense"),
          "REPRO_KV_DTYPE": ("bf16", "int8", "fp8"),
          "REPRO_KV_UPDATE": ("scatter", "select", "dynamic"),
          "REPRO_AUTOTUNE": ("1", "0", "false"),
          "REPRO_TUNE_BLOCK_ROWS": ("0", "1", "yes"),
          "REPRO_BF16_PSUM": ("0", "1", "True"),
          "REPRO_PALLAS_INTERPRET": ("1", "0", "False")}


@pytest.fixture
def reload_env(monkeypatch):
    """Reload both env modules after the test's settings; reload them again
    under the process's own environment afterwards."""
    def apply(settings):
        for var in VARS:
            if settings.get(var) is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, settings[var])
        importlib.reload(jenv)
        importlib.reload(tenv)
    yield apply
    monkeypatch.undo()
    importlib.reload(jenv)
    importlib.reload(tenv)


def _parsed(mod):
    return {k: getattr(mod, k) for k in KNOBS}


@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("level", ["unset", "default", "on", "stray"])
def test_each_knob_parses_as_the_reference(reload_env, var, level):
    """One variable at a time, unset or at its default, its "on" value or
    a stray one, the others unset: the port's seven parsed values equal the
    reference's."""
    value = None if level == "unset" else \
        LEVELS[var][("default", "on", "stray").index(level)]
    reload_env({var: value})
    assert _parsed(tenv) == _parsed(jenv)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_all_knobs_at_once_parse_as_the_reference(reload_env, level):
    """All seven set together (defaults, on, stray values)."""
    reload_env({var: LEVELS[var][level] for var in VARS})
    assert _parsed(tenv) == _parsed(jenv)


def test_session_defaults_follow_the_env():
    """A fresh process with REPRO_KV_CACHE=full and REPRO_KV_DTYPE=int8:
    the port session's defaults, and a session built without kv_cache= /
    kv_dtype=, take them."""
    code = (
        "import json, torch\n"
        "from repro_torch.api import Engine, session\n"
        "from repro_torch.configs import get, reduced\n"
        "cfg = reduced(get('llama3-8b'), n_layers=1, d_model=64, d_ff=128,"
        " vocab=256)\n"
        "sess = Engine(cfg, device='cpu').session(batch_slots=2, "
        "max_len=16)\n"
        "print(json.dumps([session.KV_CACHE_DEFAULT, "
        "session.KV_DTYPE_DEFAULT, sess.kv_cache, sess.kv_dtype]))\n")
    env = dict(os.environ, REPRO_KV_CACHE="full", REPRO_KV_DTYPE="int8",
               PYTHONPATH=os.pathsep.join(
                   p for p in ("src", os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        ["full", "int8", "full", "int8"]


# ------------------------------------------------------- KV update strategy
def _caches(rng, b, hkv, slots, dh):
    """The same random bf16 cache for the reference and twice for the
    port: every slot written below 2 * slots, some empty (-1)."""
    k = rng.normal(size=(b, hkv, slots, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, slots, dh)).astype(np.float32)
    pos = rng.integers(0, 2 * slots, size=(b, slots)).astype(np.int32)
    pos[rng.random((b, slots)) < 0.2] = -1
    jc = jkvc.KVCache(jnp.asarray(k).astype(jnp.bfloat16),
                      jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(pos))
    conv = [bridge.from_reference(np.asarray(a)) for a in jc]
    return jc, kvc.KVCache(*conv), kvc.KVCache(*(a.clone() for a in conv))


@pytest.mark.parametrize("ring", [False, True])
def test_select_equals_scatter_and_the_reference(ring):
    """Six tokens written one at a time into a full or a ring cache of 8
    slots (a full cache drops writes past its last slot): the port's
    select and scatter caches are torch.equal after every write, and equal
    the reference's select bit for bit."""
    rng = np.random.default_rng(0)
    jc, sel, sca = _caches(rng, 3, 2, 8, 16)
    for step in range(6):
        cur = np.array([step, 7 + step, 3 * step + 2], np.int32)
        kn = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
        vn = rng.normal(size=(3, 2, 1, 16)).astype(np.float32)
        jc = jkvc.update(jc, jnp.asarray(kn), jnp.asarray(vn),
                         jnp.asarray(cur), ring=ring, strategy="select")
        args = (torch.from_numpy(kn), torch.from_numpy(vn),
                torch.from_numpy(cur))
        assert kvc.update(sel, *args, ring=ring, strategy="select") is sel
        kvc.update(sca, *args, ring=ring, strategy="scatter")
        for name, a, b, r in zip(kvc.KVCache._fields, sel, sca, jc):
            assert torch.equal(a, b), name
            assert torch.equal(a, bridge.from_reference(np.asarray(r))), \
                name


@pytest.mark.parametrize("default,rewrites", [("select", 3),
                                              ("scatter", 0)])
def test_update_default_strategy_is_the_env_knob(monkeypatch, default,
                                                 rewrites):
    """``strategy=None`` takes KV_UPDATE_DEFAULT (REPRO_KV_UPDATE at
    import): on a ring cache, "select" rewrites k, v and pos through one
    ``torch.where`` each, "scatter" writes the slots with none."""
    assert kvc.KV_UPDATE_DEFAULT == tenv.KV_UPDATE
    calls = []
    where = torch.where

    def counting(*a, **k):
        calls.append(1)
        return where(*a, **k)
    rng = np.random.default_rng(1)
    _, cache, _ = _caches(rng, 2, 1, 4, 8)
    kn = torch.randn(2, 1, 1, 8)
    monkeypatch.setattr(kvc, "KV_UPDATE_DEFAULT", default)
    monkeypatch.setattr(torch, "where", counting)
    kvc.update(cache, kn, kn, torch.tensor([1, 6], dtype=torch.int32),
               ring=True)
    monkeypatch.undo()
    assert len(calls) == rewrites


# ------------------------------------------------------------ BF16_PSUM
def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (normal numbers)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("psum", [False, True])
def test_bf16_psum_raw_dense_matches_the_reference(monkeypatch, psum):
    """A raw projection at a reduced llama3-8b width (64 -> 128, bias,
    silu) under REPRO_BF16_PSUM off and on (each package's knob patched):
    the port's dense within one bf16 ulp of the reference's; with the
    knob on its product is rounded to bf16 before the bias, off it is the
    f32 product as before."""
    monkeypatch.setattr(jenv, "BF16_PSUM", psum)
    monkeypatch.setattr(tenv, "BF16_PSUM", psum)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 128)) / 8).astype(np.float32)
    bias = rng.normal(size=(128,)).astype(np.float32)
    ref = np.asarray(jlayers.dense(jnp.asarray(x), jnp.asarray(w),
                                   bias=jnp.asarray(bias)).astype(
                                       jnp.float32))
    tx, tw, tb = map(torch.from_numpy, (x, w, bias))
    out = tlayers.dense(tx, tw, bias=tb)
    prod = tlayers._bf16_matmul(tx, tw)
    if psum:
        prod = prod.to(torch.bfloat16).float()
    assert torch.equal(out, (prod + tb).to(torch.bfloat16))
    got = out.float().numpy()
    assert (np.abs(got - ref) <= _bf16_ulp(np.maximum(np.abs(got),
                                                      np.abs(ref)))).all()
    act = tlayers.dense(tx, tw, bias=tb, activation="silu").float().numpy()
    jact = np.asarray(jlayers.dense(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias),
        activation="silu").astype(jnp.float32))
    assert (np.abs(act - jact) <= 2 * _bf16_ulp(
        np.maximum(np.abs(act), np.abs(jact)))).all()
