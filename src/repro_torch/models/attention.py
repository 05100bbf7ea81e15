"""GQA attention for one-token decode against the paged KV pool."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kvstore as kvs
from repro_torch.models.layers import (COMPUTE_DTYPE, dense, dense_init,
                                       rope)


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
