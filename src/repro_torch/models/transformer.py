"""Blocks of the dense (rms-norm, with or without gemma2's post-norms),
moe and rwkv6 families and the layer stack, for training / prefill and
for decode (paged for the attention families, the recurrent state for
rwkv6).

Params and decode state are stacked over layers ([L, ...]); the JAX
package's scan over layers is a Python loop over layer views (indexing,
no copies), so each layer's attention window is a static int.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import kvstore as kvs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_fc import CompressedFC
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (COMPUTE_DTYPE, mlp, mlp_init,
                                       rms_norm, rms_norm_init)

REMAT = ("none", "dots", "full")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "rwkv6") or cfg.norm != "rms":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense, moe and rwkv6 rms-norm "
            "families so far; the others land with a later slice")


def layer_init(cfg: ArchConfig, gen: torch.Generator, lead=()) -> Dict:
    """One layer's params (``lead=(L,)`` draws the whole stack at once)."""
    _check_family(cfg)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "rwkv6":
        return {"ln1": rms_norm_init(d, lead, gen.device),
                "ln2": rms_norm_init(d, lead, gen.device),
                "tm": ssm.rwkv6_time_mix_init(gen, d, cfg.rwkv_head_dim,
                                              lead=lead),
                "cm": ssm.rwkv6_channel_mix_init(gen, d, f, lead=lead)}
    p = {"ln1": rms_norm_init(d, lead, gen.device),
         "ln2": rms_norm_init(d, lead, gen.device),
         "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim, cfg.qkv_bias, lead=lead)}
    if cfg.post_norms:
        p["ln1p"] = rms_norm_init(d, lead, gen.device)
        p["ln2p"] = rms_norm_init(d, lead, gen.device)
    if cfg.moe:
        p["moe"] = moe_mod.moe_init(gen, d, f, cfg.moe.n_experts, lead=lead)
    else:
        p["mlp"] = mlp_init(gen, d, f, cfg.gated_mlp, lead=lead)
    return p


def stack_init(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    return layer_init(cfg, gen, lead=(cfg.n_layers,))


def init_layer_state(cfg: ArchConfig, batch: int, slots_full: int,
                     page_size: int = 16,
                     kv_pool_pages: Optional[int] = None,
                     kv_dtype: str = "bf16", device=None,
                     n_layers: Optional[int] = None) -> Dict:
    """Decode state of one layer (``n_layers`` stacks [L] in front): for
    rwkv6 the previous token's normed inputs of the two mixes (bf16) and
    the WKV state (f32 [B, H, dh, dh]); otherwise a page pool indexed
    through the one shared page table."""
    _check_family(cfg)
    if cfg.family == "rwkv6":
        lead = () if n_layers is None else (n_layers,)
        h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"tm_prev": torch.zeros(lead + (batch, cfg.d_model),
                                       dtype=COMPUTE_DTYPE, device=device),
                "cm_prev": torch.zeros(lead + (batch, cfg.d_model),
                                       dtype=COMPUTE_DTYPE, device=device),
                "S": torch.zeros(lead + (batch, h, dh, dh),
                                 dtype=torch.float32, device=device)}
    npp = -(-slots_full // page_size)
    n_pages = 1 + batch * npp if kv_pool_pages is None else kv_pool_pages
    return {"kv": kvs.init_pool(n_pages, cfg.n_kv, page_size, cfg.head_dim,
                                kv_dtype=kv_dtype, n_layers=n_layers,
                                device=device)}


def init_stack_state(cfg: ArchConfig, batch: int, slots_full: int,
                     **kv_kw) -> Dict:
    """The whole stack's decode state, allocated stacked ([L, ...]) rather
    than stacked from per-layer copies."""
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


def ffn(cfg: ArchConfig, p: Dict, x, h):
    """The second half of an attention layer, from the residual ``x`` and
    the attention output ``h``: post-norm of h (gemma2), residual add, the
    MLP or MoE over the normed sum, its post-norm, residual add ->
    (x, aux): the MoE's load-balancing loss, None for an MLP (so a decode
    step makes no scalar it would throw away)."""
    if cfg.post_norms:
        h = rms_norm(h, p["ln1p"])
    x = x + h
    aux = None
    if cfg.moe:
        h, aux = moe_mod.moe_apply(
            p["moe"], rms_norm(x, p["ln2"]), n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, group_size=cfg.moe.group_size,
            capacity_factor=cfg.moe.capacity_factor)
    else:
        h = mlp(rms_norm(x, p["ln2"]), p["mlp"], cfg.act)
    if cfg.post_norms:
        h = rms_norm(h, p["ln2p"])
    return x + h, aux


def unstack(tree, n: int):
    """The ``n`` layers of a stacked raw-param tree as a list of trees of
    views; under autograd each leaf's gradient comes back as one stacked
    tensor (``unbind``), not as ``n`` full-size scatters."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


def block_forward(cfg: ArchConfig, p: Dict, x, positions, window: int,
                  attn_impl: str = "einsum"):
    """One layer, training / prefill, x [B, T, D] bf16 -> (x, aux); aux is
    the MoE's load-balancing loss, None elsewhere.  An rwkv6 layer starts
    from a zero token shift and a zero WKV state."""
    _check_family(cfg)
    if cfg.family == "rwkv6":
        zeros = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                            device=x.device)
        h, _ = ssm.rwkv6_time_mix(p["tm"], rms_norm(x, p["ln1"]), zeros,
                                  d_head=cfg.rwkv_head_dim)
        x = x + h
        h, _ = ssm.rwkv6_channel_mix(p["cm"], rms_norm(x, p["ln2"]), zeros)
        return x + h, None
    h = attn.attn_apply(p["attn"], rms_norm(x, p["ln1"]), positions,
                        window=window, causal=cfg.causal, impl=attn_impl,
                        **_attn_kwargs(cfg))
    return ffn(cfg, p, x, h)


# The reference's "dots" policy (``dots_with_no_batch_dims_saveable``):
# keep the outputs of products with no batch dims, recompute the rest.
# Every projection reaches ``aten.mm`` (``torch.matmul`` folds [B, T, D] @
# [D, N] to one), so those are what a layer keeps; norms, casts, batched
# attention products and the flash forward are recomputed in the backward.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_forward(cfg: ArchConfig, stacked: Dict, x, positions,
                  remat: str = "dots", attn_impl: str = "einsum"):
    """Every layer in turn -> (x, total aux).  ``remat="full"`` recomputes
    each layer in the backward (``torch.utils.checkpoint``); "dots" keeps
    each layer's projection outputs and recomputes the rest; "none" keeps
    every activation.  The three give the same numbers."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    windows = cfg.layer_windows()
    for p, window in zip(unstack(stacked, len(windows)), windows):
        if remat == "none":
            x, a = block_forward(cfg, p, x, positions, window, attn_impl)
        else:
            ctx = {} if remat == "full" else {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)}
            x, a = checkpoint(block_forward, cfg, p, x, positions, window,
                              attn_impl, use_reentrant=False, **ctx)
        if a is not None:
            aux = aux + a
    return x, aux


def block_decode(cfg: ArchConfig, p: Dict, st: Dict, x, cur_pos,
                 window: int, page_table):
    """One layer, one token, x [B, 1, D].  Writes the layer's pool (or its
    rwkv6 state) in place and returns (state, x)."""
    if cfg.family == "rwkv6":
        tm, h = ssm.rwkv6_time_mix_decode(
            p["tm"], {"prev": st["tm_prev"], "S": st["S"]},
            rms_norm(x, p["ln1"]), d_head=cfg.rwkv_head_dim)
        x = x + h
        cm_prev, h = ssm.rwkv6_channel_mix_decode(p["cm"], st["cm_prev"],
                                                  rms_norm(x, p["ln2"]))
        st["tm_prev"].copy_(tm["prev"])
        st["S"].copy_(tm["S"])
        st["cm_prev"].copy_(cm_prev)
        return st, x + h
    pool, h = attn.attn_decode_paged(p["attn"], st["kv"], page_table,
                                     rms_norm(x, p["ln1"]), cur_pos,
                                     window=window, **_attn_kwargs(cfg))
    x, _ = ffn(cfg, p, x, h)
    return {"kv": pool}, x


def stack_decode(cfg: ArchConfig, stacked: Dict, states: Dict, x, cur_pos,
                 page_table):
    """Every layer in turn over layer views of the stacked params and
    state; the pools (or rwkv6 states) are written in place, so the
    returned state is the one passed in.  ``page_table`` is None for
    rwkv6."""
    for i, window in enumerate(cfg.layer_windows()):
        _, x = block_decode(cfg, layer_view(stacked, i),
                            layer_view(states, i), x, cur_pos, window,
                            page_table)
    return states, x
