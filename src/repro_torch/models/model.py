"""Top-level model API of the port: init, paged decode state, decode step."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import kvstore as kvs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (_bf16_matmul, dense_init, embed,
                                       embed_init, rms_norm, rms_norm_init,
                                       softcap, unembed)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    """Random params on the generator's device, in the JAX package's
    layout: projections [d_in, d_out], layers stacked [L, ...]."""
    p = {"embed": embed_init(gen, cfg.vocab_padded, cfg.d_model),
         "final_norm": rms_norm_init(cfg.d_model, device=gen.device),
         "layers": tfm.stack_init(cfg, gen)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded)
    return p


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      page_size: int = 16,
                      kv_pool_pages: Optional[int] = None,
                      kv_dtype: str = "bf16", device=None) -> Dict:
    """Paged decode state: the stacked page pools plus one per-sequence
    page table shared by every layer."""
    layers = tfm.init_stack_state(cfg, batch, max_len, page_size=page_size,
                                  kv_pool_pages=kv_pool_pages,
                                  kv_dtype=kv_dtype, device=device)
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "page_table": kvs.init_table(batch, max_len, page_size,
                                         device=device)}


def decode_step(cfg: ArchConfig, params: Dict, state: Dict,
                tokens: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] -> (state', logits [B, Vpad] f32).  The state's pools are
    written in place (the JAX step donates its state for the same reason:
    the pools are never copied); ``pos`` advances by one."""
    x = embed(tokens[:, None], params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    table = state["page_table"]
    layers, x = tfm.stack_decode(cfg, params["layers"], state["layers"], x,
                                 state["pos"], table)
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"])
    else:
        logits = _bf16_matmul(x, params["lm_head"])
    logits = softcap(logits, cfg.final_softcap)
    new_state = {"layers": layers, "pos": state["pos"] + 1,
                 "page_table": table}
    return new_state, logits[:, 0, :]
