"""Chunked prefill: C prompt tokens per model call, written straight into
KV pages.

The decode step moves one token per slot per call, so a P-token prompt
costs P model calls before the first generated token.  This step embeds a
[B, C] token block, runs the layer stack once over all C positions, and
writes each position's K/V into the page pool through the shared page
table: first-token latency drops from P calls to ceil(P / C).

Mixed prefill + decode batches fall out of the per-slot ``n_tok`` vector:
a prefilling slot carries up to C prompt tokens, a decoding slot 1 (its
next token), an idle slot 0.  Padding positions go to the garbage page
(``update_chunk(valid=...)``) and their logits are ignored, so one [B, C]
shape serves every step.

Within-chunk causality needs no extra machinery: all C tokens' K/V are
written (one scatter, ``kvstore.update_chunk``) before the chunk attends
(``kvstore.paged_attention_chunk``, the K3 kernel on the card), and the
page-table index is the absolute position, so each query's mask at its
own position sees in-chunk keys exactly like history.

Scope: the paged cache and the dense and moe families; families with
per-token recurrent state (rwkv6, hymba) would scan the chunk token by
token anyway, and an encoder has no decode.  A
MoE layer routes the whole [B, C] block as one token group, padding
positions included, as the JAX package's step does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import kvstore as kvs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (COMPUTE_DTYPE, _bf16_matmul, dense,
                                       embed, softcap, unembed)


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """Chunked prefill needs attention-only token mixing: families with a
    per-token recurrent state (rwkv6 time-mix, hymba's mamba branch)
    would have to scan the chunk token by token anyway."""
    return cfg.family not in ("encoder", "rwkv6", "hymba")


def _block_prefill(cfg: ArchConfig, p: Dict, st: Dict, x, positions,
                   valid, window: int, table) -> torch.Tensor:
    """One layer over a [B, C, D] chunk: write C tokens' K/V into the
    layer's pages (in place), then attend all C queries over the updated
    page table."""
    scale = (cfg.head_dim ** -0.5) if cfg.attn_scale is None \
        else cfg.attn_scale
    q, k, v = attn._qkv(p["attn"], tfm._norm(cfg)(x, p["ln1"]),
                        cfg.n_heads, cfg.n_kv, cfg.head_dim, positions,
                        cfg.rope_theta)
    pool = kvs.update_chunk(st["kv"], table, k.float(), v.float(),
                            positions, valid=valid)
    o = kvs.paged_attention_chunk(q, pool, table, positions, window,
                                  scale=scale, cap=cfg.attn_softcap)
    h = dense(attn._merge_heads(o.to(COMPUTE_DTYPE)), p["attn"]["wo"])
    return tfm.ffn(cfg, p, x, h)[0]


def _stack_prefill(cfg: ArchConfig, stacked: Dict, states: Dict, x,
                   positions, valid, table) -> torch.Tensor:
    """Every layer in turn over layer views of the stacked params and
    state (the JAX package's scan over layers); pools are written in
    place."""
    for i, window in enumerate(cfg.layer_windows()):
        x = _block_prefill(cfg, tfm.layer_view(stacked, i),
                           tfm.layer_view(states, i), x, positions, valid,
                           window, table)
    return x


def prefill_step(cfg: ArchConfig, params: Dict, state: Dict,
                 tokens: torch.Tensor, n_tok: torch.Tensor
                 ) -> Tuple[Dict, torch.Tensor]:
    """tokens [B, C], n_tok [B] (0 = idle slot) -> (state', logits
    [B, C, Vpad] f32).  Slot i's tokens occupy absolute positions
    ``state["pos"][i] .. + n_tok[i] - 1``; the caller makes sure those
    positions' pages exist in the table and samples from
    ``logits[i, n_tok[i] - 1]``.  The pools are written in place and
    ``pos`` advances by ``n_tok``."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"{cfg.name} ({cfg.family}) has per-token "
                         "recurrent state; chunked prefill unsupported")
    table = state["page_table"]
    b, c = tokens.shape
    offs = torch.arange(c, dtype=torch.int32, device=tokens.device)
    positions = state["pos"][:, None] + offs[None, :]        # [B, C]
    valid = offs[None, :] < n_tok[:, None]                   # [B, C]
    x = embed(tokens, params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x = _stack_prefill(cfg, params["layers"], state["layers"], x,
                       positions, valid, table)
    x = tfm._norm(cfg)(x, params["final_norm"])
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"])
    else:
        logits = _bf16_matmul(x, params["lm_head"])
    logits = softcap(logits, cfg.final_softcap)
    new_state = {"layers": state["layers"],
                 "pos": state["pos"] + n_tok.to(state["pos"].dtype),
                 "page_table": table}
    return new_state, logits
