"""Blocks of every family (dense with or without gemma2's post-norms,
moe, hymba's parallel attention + mamba heads, rwkv6 and the non-causal
layer-norm encoder) and the layer stack, for training / prefill and for
decode (paged or dense KV cache for the attention families, the recurrent
state for rwkv6 and hymba's mamba heads).

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
from repro_torch.models import kvcache as kvc
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (COMPUTE_DTYPE, layer_norm,
                                       layer_norm_init, mlp, mlp_init,
                                       rms_norm, rms_norm_init)

REMAT = ("none", "dots", "full")
FAMILIES = ("dense", "moe", "hymba", "rwkv6", "encoder")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES or cfg.norm not in ("rms", "layer"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with norm {cfg.norm!r}; the "
            f"port runs the families {FAMILIES} with rms or layer norm")


def _norm(cfg: ArchConfig):
    return rms_norm if cfg.norm == "rms" else layer_norm


def _norm_init(cfg: ArchConfig, d: int, lead=(), device=None):
    init = rms_norm_init if cfg.norm == "rms" else layer_norm_init
    return init(d, lead, device)


def layer_init(cfg: ArchConfig, gen: torch.Generator, lead=()) -> Dict:
    """One layer's params (``lead=(L,)`` draws the whole stack at once)."""
    _check_family(cfg)
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    if cfg.family == "rwkv6":
        return {"ln1": _norm_init(cfg, d, lead, dev),
                "ln2": _norm_init(cfg, d, lead, dev),
                "tm": ssm.rwkv6_time_mix_init(gen, d, cfg.rwkv_head_dim,
                                              lead=lead),
                "cm": ssm.rwkv6_channel_mix_init(gen, d, f, lead=lead)}
    p = {"ln1": _norm_init(cfg, d, lead, dev),
         "ln2": _norm_init(cfg, d, lead, dev),
         "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim, cfg.qkv_bias, lead=lead)}
    if cfg.post_norms:
        p["ln1p"] = _norm_init(cfg, d, lead, dev)
        p["ln2p"] = _norm_init(cfg, d, lead, dev)
    if cfg.moe:
        p["moe"] = moe_mod.moe_init(gen, d, f, cfg.moe.n_experts, lead=lead)
    else:
        p["mlp"] = mlp_init(gen, d, f, cfg.gated_mlp, lead=lead)
    if cfg.family == "hymba":
        p["mamba"] = ssm.mamba_init(gen, d, cfg.ssm_state, lead=lead)
        p["ln_ssm"] = _norm_init(cfg, d, lead, dev)
    return p


def stack_init(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    return layer_init(cfg, gen, lead=(cfg.n_layers,))


def _any_global(cfg: ArchConfig) -> bool:
    return any(w < 0 for w in cfg.layer_windows())


def init_layer_state(cfg: ArchConfig, batch: int, slots_full: int,
                     kv_cache: str = "full", page_size: int = 16,
                     kv_pool_pages: Optional[int] = None,
                     kv_dtype: str = "bf16", device=None,
                     n_layers: Optional[int] = None) -> Dict:
    """Decode state of one layer (``n_layers`` stacks [L] in front): for
    rwkv6 the previous token's normed inputs of the two mixes (bf16) and
    the WKV state (f32 [B, H, dh, dh]), whatever ``kv_cache`` says;
    otherwise a page pool indexed through the one shared page table
    ("paged") or a dense cache ("full": ``slots_full`` slots where a layer
    is global, a ring of ``min(window, slots_full)`` where every layer is
    windowed), and for hymba the mamba heads' conv inputs [B, 3, D] and
    SSM state [B, D, N] (f32)."""
    _check_family(cfg)
    lead = () if n_layers is None else (n_layers,)
    if cfg.family == "rwkv6":
        h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"tm_prev": torch.zeros(lead + (batch, cfg.d_model),
                                       dtype=COMPUTE_DTYPE, device=device),
                "cm_prev": torch.zeros(lead + (batch, cfg.d_model),
                                       dtype=COMPUTE_DTYPE, device=device),
                "S": torch.zeros(lead + (batch, h, dh, dh),
                                 dtype=torch.float32, device=device)}
    if kv_cache == "paged":
        npp = -(-slots_full // page_size)
        n_pages = 1 + batch * npp if kv_pool_pages is None \
            else kv_pool_pages
        st = {"kv": kvs.init_pool(n_pages, cfg.n_kv, page_size,
                                  cfg.head_dim, kv_dtype=kv_dtype,
                                  n_layers=n_layers, device=device)}
    elif kv_cache == "full":
        # one slot count for every layer (the JAX package scans a
        # homogeneous stack): rings only where no layer is global
        slots = slots_full if _any_global(cfg) \
            else min(cfg.window, slots_full)
        st = {"kv": kvc.init_cache(batch, cfg.n_kv, slots, cfg.head_dim,
                                   n_layers=n_layers, device=device)}
    else:
        raise ValueError(f"unknown kv_cache {kv_cache!r}")
    if cfg.family == "hymba":
        st["mamba"] = {
            "conv": torch.zeros(lead + (batch, 3, cfg.d_model),
                                dtype=torch.float32, device=device),
            "h": torch.zeros(lead + (batch, cfg.d_model, cfg.ssm_state),
                             dtype=torch.float32, device=device)}
    return st


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
    if isinstance(tree, (CompressedFC, kvs.PagedKV, kvc.KVCache)):
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
    nrm = _norm(cfg)
    if cfg.post_norms:
        h = nrm(h, p["ln1p"])
    x = x + h
    aux = None
    if cfg.moe:
        h, aux = moe_mod.moe_apply(
            p["moe"], nrm(x, p["ln2"]), n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, group_size=cfg.moe.group_size,
            capacity_factor=cfg.moe.capacity_factor)
    else:
        h = mlp(nrm(x, p["ln2"]), p["mlp"], cfg.act)
    if cfg.post_norms:
        h = nrm(h, p["ln2p"])
    return x + h, aux


def _hybrid(cfg: ArchConfig, p: Dict, h, hs):
    """hymba: the attention and mamba heads' mean, 0.5 * (norm(attn) +
    mamba), in bf16."""
    return 0.5 * (_norm(cfg)(h, p["ln_ssm"]) + hs.to(COMPUTE_DTYPE))


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
    from a zero token shift and a zero WKV state, a hymba layer's mamba
    heads from a zero SSM state."""
    _check_family(cfg)
    nrm = _norm(cfg)
    if cfg.family == "rwkv6":
        zeros = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                            device=x.device)
        h, _ = ssm.rwkv6_time_mix(p["tm"], nrm(x, p["ln1"]), zeros,
                                  d_head=cfg.rwkv_head_dim)
        x = x + h
        h, _ = ssm.rwkv6_channel_mix(p["cm"], nrm(x, p["ln2"]), zeros)
        return x + h, None
    h = attn.attn_apply(p["attn"], nrm(x, p["ln1"]), positions,
                        window=window, causal=cfg.causal, impl=attn_impl,
                        **_attn_kwargs(cfg))
    if cfg.family == "hymba":
        h = _hybrid(cfg, p, h, ssm.mamba_apply(p["mamba"], nrm(x, p["ln1"]),
                                               state=cfg.ssm_state))
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
    """One layer, one token, x [B, 1, D].  Writes the layer's pool or
    dense cache (and hymba's mamba state, or the rwkv6 state) in place and
    returns (state, x).  ``page_table`` None takes the dense cache, a ring
    where no layer is global."""
    nrm = _norm(cfg)
    if cfg.family == "rwkv6":
        tm, h = ssm.rwkv6_time_mix_decode(
            p["tm"], {"prev": st["tm_prev"], "S": st["S"]},
            nrm(x, p["ln1"]), d_head=cfg.rwkv_head_dim)
        x = x + h
        cm_prev, h = ssm.rwkv6_channel_mix_decode(p["cm"], st["cm_prev"],
                                                  nrm(x, p["ln2"]))
        st["tm_prev"].copy_(tm["prev"])
        st["S"].copy_(tm["S"])
        st["cm_prev"].copy_(cm_prev)
        return st, x + h
    if page_table is not None:
        cache, h = attn.attn_decode_paged(p["attn"], st["kv"], page_table,
                                          nrm(x, p["ln1"]), cur_pos,
                                          window=window, **_attn_kwargs(cfg))
    else:
        cache, h = attn.attn_decode(p["attn"], st["kv"], nrm(x, p["ln1"]),
                                    cur_pos, window=window,
                                    ring=not _any_global(cfg),
                                    **_attn_kwargs(cfg))
    if cfg.family == "hymba":
        mst, hs = ssm.mamba_decode(p["mamba"], st["mamba"], nrm(x, p["ln1"]),
                                   state=cfg.ssm_state)
        st["mamba"]["conv"].copy_(mst["conv"])
        st["mamba"]["h"].copy_(mst["h"])
        h = _hybrid(cfg, p, h, hs)
    x, _ = ffn(cfg, p, x, h)
    return dict(st, kv=cache), x


def stack_decode(cfg: ArchConfig, stacked: Dict, states: Dict, x, cur_pos,
                 page_table):
    """Every layer in turn over layer views of the stacked params and
    state; the pools, caches and recurrent states are written in place, so
    the returned state is the one passed in.  ``page_table`` is None for
    rwkv6 and the dense cache."""
    for i, window in enumerate(cfg.layer_windows()):
        _, x = block_decode(cfg, layer_view(stacked, i),
                            layer_view(states, i), x, cur_pos, window,
                            page_table)
    return states, x
