"""GQA attention: training / prefill self-attention (einsum, chunked or
flash; causal or not) and one-token decode against the paged KV pool or
a dense KV cache (full or ring)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kvstore as kvs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import (COMPUTE_DTYPE, dense, dense_init,
                                       rope, softcap)


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              d_head: int, qkv_bias: bool = False, lead=()):
    p = {
        "wq": dense_init(gen, d, n_heads * d_head, lead=lead),
        "wk": dense_init(gen, d, n_kv * d_head, lead=lead),
        "wv": dense_init(gen, d, n_kv * d_head, lead=lead),
        "wo": dense_init(gen, n_heads * d_head, d, lead=lead),
    }
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(tuple(lead) + (n * d_head,),
                                  dtype=torch.float32, device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, d_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _qkv(p, x, n_heads, n_kv, d_head, positions, theta):
    q = dense(x, p["wq"], p.get("bq"))
    k = dense(x, p["wk"], p.get("bk"))
    v = dense(x, p["wv"], p.get("bv"))
    q = _split_heads(q, n_heads, d_head)
    k = _split_heads(k, n_kv, d_head)
    v = _split_heads(v, n_kv, d_head)
    if theta is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in f32: an f32 product of such operands
    is the JAX package's bf16 product with f32 accumulation."""
    return x.to(COMPUTE_DTYPE).float()


def _core(q, k, v, mask, cap: Optional[float], scale: float):
    """Masked softmax attention with the query heads grouped [B, Hkv, G,
    T, D] (k / v never repeated): bf16 operands, f32 scores and softmax,
    p rounded to bf16 for ``p @ v`` and the output in bf16, as in the JAX
    package.  mask [Tq, Tk] (or broadcastable to [B, Hkv, G, Tq, Tk])."""
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, tq, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", _bf16(qg), _bf16(k)) * scale
    s = softcap(s, cap)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", _bf16(p), _bf16(v))
    return o.to(COMPUTE_DTYPE).reshape(b, h, tq, d)


def _chunked_core(q, k, v, window: int, causal: bool, cap, scale,
                  chunk: int):
    """:func:`_core` over query chunks of ``chunk`` rows: O(T * chunk)
    scores live at a time instead of O(T^2)."""
    t = q.shape[2]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of chunk {chunk}")
    ki = torch.arange(t, device=q.device)[None, :]
    outs = []
    for c0 in range(0, t, chunk):
        qi = torch.arange(c0, c0 + chunk, device=q.device)[:, None]
        m = torch.ones((chunk, t), dtype=torch.bool, device=q.device)
        if causal:
            m = m & (ki <= qi)
        if window >= 0:
            m = m & (ki > qi - window)
        outs.append(_core(q[:, :, c0:c0 + chunk], k, v, m, cap, scale))
    return torch.cat(outs, dim=2)


def attn_apply(p, x, positions, *, n_heads: int, n_kv: int, d_head: int,
               window: int, causal: bool = True, cap: Optional[float] = None,
               theta: Optional[float] = 10000.0,
               scale: Optional[float] = None, impl: str = "einsum",
               chunk: int = 512) -> torch.Tensor:
    """Training / prefill self-attention, x [B, T, D] -> [B, T, D] bf16.
    ``window`` is the layer's static int (-1 = full).  ``impl``:
    "einsum" (one masked softmax), "chunked" (over query chunks) or
    "flash" (K7 forward, K8 backward)."""
    scale = (d_head ** -0.5) if scale is None else scale
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head, positions, theta)
    t = x.shape[1]
    if impl == "flash":
        o = ops.attention(q, k, v, causal=causal,
                          window=None if window < 0 else int(window),
                          softcap=cap, scale=scale, impl="flash")
    elif impl == "chunked":
        o = _chunked_core(q, k, v, window, causal, cap, scale, chunk)
    elif impl == "einsum":
        qi = torch.arange(t, device=x.device)[:, None]
        ki = torch.arange(t, device=x.device)[None, :]
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device)
        if causal:
            mask = mask & (ki <= qi)
        mask = mask & ((window < 0) | (ki > qi - window))
        o = _core(q, k, v, mask, cap, scale)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return dense(_merge_heads(o.to(COMPUTE_DTYPE)), p["wo"])


def decode_attend(cache: kvc.KVCache, q, k, v, cur_pos, *, window: int,
                  ring: bool = False, cap: Optional[float] = None,
                  scale: float = 1.0):
    """Write the token's k/v into its slot of the dense cache (in place),
    then the masked softmax over the slots (:func:`_core`, plain ops on
    every device, as in the JAX package).  q/k/v are [B, H(kv), 1, Dh]."""
    cache = kvc.update(cache, k, v, cur_pos, ring=ring)
    mask = kvc.attention_mask(cache, cur_pos, window)       # [B, S]
    o = _core(q, cache.k, cache.v, mask[:, None, None, None, :], cap, scale)
    return cache, o


def attn_decode(p, cache: kvc.KVCache, x, cur_pos, *, n_heads: int,
                n_kv: int, d_head: int, window: int, ring: bool = False,
                cap: Optional[float] = None,
                theta: Optional[float] = 10000.0,
                scale: Optional[float] = None):
    """One-token decode against a dense cache. x [B, 1, D], cur_pos [B]
    absolute positions."""
    scale = (d_head ** -0.5) if scale is None else scale
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head, cur_pos[:, None], theta)
    cache, o = decode_attend(cache, q, k, v, cur_pos, window=window,
                             ring=ring, cap=cap, scale=scale)
    return cache, dense(_merge_heads(o.to(COMPUTE_DTYPE)), p["wo"])


def decode_attend_paged(pool: kvs.PagedKV, table, q, k, v, cur_pos, *,
                        window: int, cap: Optional[float] = None,
                        scale: float = 1.0):
    """Write the token's k/v into its page (in place), then attend over the
    sequence's pages.  q/k/v are [B, H(kv), 1, Dh] as from _qkv."""
    pool = kvs.update(pool, table, k[:, :, 0].float(), v[:, :, 0].float(),
                      cur_pos)
    o = kvs.paged_attention(q[:, :, 0], pool, table, cur_pos, window,
                            scale=scale, cap=cap)
    return pool, o[:, :, None, :]


def attn_decode_paged(p, pool: kvs.PagedKV, table, x, cur_pos, *,
                      n_heads: int, n_kv: int, d_head: int, window: int,
                      cap: Optional[float] = None,
                      theta: Optional[float] = 10000.0,
                      scale: Optional[float] = None):
    """One-token decode against the paged KV pool. x [B, 1, D], cur_pos [B]
    absolute positions."""
    scale = (d_head ** -0.5) if scale is None else scale
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head, cur_pos[:, None], theta)
    pool, o = decode_attend_paged(pool, table, q, k, v, cur_pos,
                                  window=window, cap=cap, scale=scale)
    return pool, dense(_merge_heads(o.to(COMPUTE_DTYPE)), p["wo"])
