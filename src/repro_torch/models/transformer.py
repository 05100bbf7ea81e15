"""Dense-family block and the layer stack for paged decode.

Params and decode state are stacked over layers ([L, ...]); the JAX
package's scan over layers is a Python loop over layer views (indexing,
no copies).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import kvstore as kvs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_fc import CompressedFC
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_init, rms_norm, rms_norm_init


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.norm != "rms" or cfg.post_norms:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense rms-norm family so far; "
            "the other families land with a later slice")


def layer_init(cfg: ArchConfig, gen: torch.Generator, lead=()) -> Dict:
    """One layer's params (``lead=(L,)`` draws the whole stack at once)."""
    _check_family(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"ln1": rms_norm_init(d, lead, gen.device),
            "ln2": rms_norm_init(d, lead, gen.device),
            "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, cfg.qkv_bias, lead=lead),
            "mlp": mlp_init(gen, d, f, cfg.gated_mlp, lead=lead)}


def stack_init(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    return layer_init(cfg, gen, lead=(cfg.n_layers,))


def init_layer_state(cfg: ArchConfig, batch: int, slots_full: int,
                     page_size: int = 16,
                     kv_pool_pages: Optional[int] = None,
                     kv_dtype: str = "bf16", device=None,
                     n_layers: Optional[int] = None) -> Dict:
    """Paged decode state of one layer (``n_layers`` stacks [L] in front):
    a page pool indexed through the one shared page table."""
    _check_family(cfg)
    npp = -(-slots_full // page_size)
    n_pages = 1 + batch * npp if kv_pool_pages is None else kv_pool_pages
    return {"kv": kvs.init_pool(n_pages, cfg.n_kv, page_size, cfg.head_dim,
                                kv_dtype=kv_dtype, n_layers=n_layers,
                                device=device)}


def init_stack_state(cfg: ArchConfig, batch: int, slots_full: int,
                     **kv_kw) -> Dict:
    """The whole stack's paged decode state, allocated stacked ([L, ...])
    rather than stacked from per-layer copies."""
    return init_layer_state(cfg, batch, slots_full, n_layers=cfg.n_layers,
                            **kv_kw)


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked param / state tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, (CompressedFC, kvs.PagedKV)):
        return tree.layer(i)
    return tree[i]


def _attn_kwargs(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                cap=cfg.attn_softcap, theta=cfg.rope_theta,
                scale=cfg.attn_scale)


def block_decode(cfg: ArchConfig, p: Dict, st: Dict, x, cur_pos,
                 window: int, page_table):
    """One layer, one token, x [B, 1, D].  Writes the layer's pool in
    place and returns (state, x)."""
    pool, h = attn.attn_decode_paged(p["attn"], st["kv"], page_table,
                                     rms_norm(x, p["ln1"]), cur_pos,
                                     window=window, **_attn_kwargs(cfg))
    x = x + h
    h = mlp(rms_norm(x, p["ln2"]), p["mlp"], cfg.act)
    return {"kv": pool}, x + h


def stack_decode(cfg: ArchConfig, stacked: Dict, states: Dict, x, cur_pos,
                 page_table):
    """Every layer in turn over layer views of the stacked params and
    state; the pools are written in place, so the returned state is the
    one passed in."""
    for i, window in enumerate(cfg.layer_windows()):
        _, x = block_decode(cfg, layer_view(stacked, i),
                            layer_view(states, i), x, cur_pos, window,
                            page_table)
    return states, x
