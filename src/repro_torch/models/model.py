"""Top-level model API of the port: init, forward and loss for training
(token, vision-prefix and audio-frame inputs), decode state (a paged or
dense KV cache for attention, recurrent state for rwkv6 and hymba's
mamba heads) and decode step."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import kvstore as kvs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (COMPUTE_DTYPE, _bf16_matmul, dense,
                                       dense_init, embed, embed_init,
                                       softcap, unembed)
from repro_torch.models.transformer import _norm, _norm_init


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict:
    """Random params on the generator's device, in the JAX package's
    layout: projections [d_in, d_out], layers stacked [L, ...]; an audio
    model has a ``frontend`` projection of its frame features."""
    p = {"embed": embed_init(gen, cfg.vocab_padded, cfg.d_model),
         "final_norm": _norm_init(cfg, cfg.d_model, device=gen.device),
         "layers": tfm.stack_init(cfg, gen)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded)
    if cfg.frontend == "audio":
        p["frontend"] = dense_init(gen, cfg.audio_in_dim, cfg.d_model)
    return p


def _inputs(cfg: ArchConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """The first layer's input [B, S, D] bf16: projected frames (audio),
    the image rows then the embedded text (vision), or embedded tokens.
    The frontends themselves are stubs, as in the JAX package: ``frames``
    are frame features, ``img_embeds`` precomputed patch embeddings."""
    if cfg.frontend == "audio":
        return dense(batch["frames"].to(COMPUTE_DTYPE), params["frontend"])
    x = embed(batch["tokens"], params["embed"])
    if cfg.frontend == "vision":
        x = torch.cat([batch["img_embeds"].to(COMPUTE_DTYPE), x], dim=1)
    return x


def forward(cfg: ArchConfig, params: Dict, batch: Dict, *,
            remat: str = "dots", attn_impl: str = "einsum",
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens": [B, S]} (+ "img_embeds" [B, n_img, D] for vision,
    whose rows go first) or {"frames": [B, S, audio_in_dim]} (audio) ->
    (logits [B, S, Vpad] f32, aux), or the final-normed hidden state [B,
    S, D] bf16 with ``return_hidden``."""
    x = _inputs(cfg, params, batch)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = tfm.stack_forward(cfg, params["layers"], x, positions,
                               remat=remat, attn_impl=attn_impl)
    x = _norm(cfg)(x, params["final_norm"])
    if return_hidden:
        return x, aux
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"])
    else:
        logits = _bf16_matmul(x, params["lm_head"])
    return softcap(logits, cfg.final_softcap), aux


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         vocab: int) -> torch.Tensor:
    """Per-position -log softmax(logits)[label] with the padded vocab
    columns (vocab..Vpad) out of the logsumexp.  The JAX package picks the
    label's logit by a one-hot contraction; every other term of that sum
    is an exact zero, so a gather gives the same value."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab, logits, NEG_INF)
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + lmax[..., 0]
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0] + \
        lmax[..., 0]
    return lse - picked


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """Mean cross-entropy over the positions where mask is 1."""
    nll = _nll(logits, labels, vocab) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _xent_streamed(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   chunk: int = 512) -> torch.Tensor:
    """:func:`_xent` over sequence chunks of the hidden state: only [B,
    chunk, Vpad] logits exist at a time.  The sequence is padded to a
    chunk multiple, the padded positions masked out."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    table = params["embed"]["table"].T if cfg.tie_embeddings \
        else params["lm_head"]
    nll = []
    for c0 in range(0, s + pad, chunk):
        lg = softcap(_bf16_matmul(x[:, c0:c0 + chunk], table),
                     cfg.final_softcap)
        nll.append(_nll(lg, labels[:, c0:c0 + chunk], cfg.vocab))
    return (torch.cat(nll, dim=1) * mask).sum() / \
        torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *,
            remat: str = "dots", attn_impl: str = "einsum",
            streamed_loss: bool = False,
            loss_chunk: int = 512) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy + 0.01 * aux -> (loss, {"ce", "aux"}); negative
    labels are masked.  A causal model predicts the next token (its labels
    are the tokens shifted by one; a vision model's over the text tail
    only); an encoder (or any non-causal model) predicts
    ``batch["labels"]`` at every position.  ``streamed_loss`` (causal
    only, as in the JAX package) never forms the whole logits tensor."""
    encoder = cfg.family == "encoder" or not cfg.causal
    labels = batch["labels"] if encoder else batch["tokens"][:, 1:]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    n_txt = None if encoder else batch["tokens"].shape[1]
    if streamed_loss and not encoder:
        x, aux = forward(cfg, params, batch, remat=remat,
                         attn_impl=attn_impl, return_hidden=True)
        ce = _xent_streamed(cfg, params, x[:, -n_txt:][:, :-1], labels,
                            mask, chunk=loss_chunk)
    else:
        logits, aux = forward(cfg, params, batch, remat=remat,
                              attn_impl=attn_impl)
        if not encoder:
            logits = logits[:, -n_txt:][:, :-1]
        ce = _xent(logits, labels, mask, cfg.vocab)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      kv_cache: Optional[str] = None, page_size: int = 16,
                      kv_pool_pages: Optional[int] = None,
                      kv_dtype: str = "bf16", device=None) -> Dict:
    """Decode state.  ``kv_cache`` None takes the family's own: "full" for
    rwkv6 (the per-slot recurrent state, the same size at every length),
    "paged" elsewhere (the stacked page pools plus one per-sequence page
    table shared by every layer).  "full" gives attention families the
    dense per-slot cache (a ring where every layer is windowed).  As in
    the JAX package rwkv6 refuses "paged"."""
    if kv_cache is None:
        kv_cache = "full" if cfg.family == "rwkv6" else "paged"
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if kv_cache == "full":
        return {"layers": tfm.init_stack_state(cfg, batch, max_len,
                                               kv_cache="full",
                                               device=device),
                "pos": pos}
    if kv_cache != "paged":
        raise ValueError(f"unknown kv_cache {kv_cache!r}")
    if cfg.family == "rwkv6":
        raise ValueError("paged KV cache needs attention layers; "
                         f"{cfg.name} is attention-free")
    layers = tfm.init_stack_state(cfg, batch, max_len, kv_cache="paged",
                                  page_size=page_size,
                                  kv_pool_pages=kv_pool_pages,
                                  kv_dtype=kv_dtype, device=device)
    return {"layers": layers, "pos": pos,
            "page_table": kvs.init_table(batch, max_len, page_size,
                                         device=device)}


def lm_logits(cfg: ArchConfig, params: Dict, x: torch.Tensor
              ) -> torch.Tensor:
    """The head's f32 logits of the final-normed ``x`` (the tied
    embedding's or the lm_head's, whole on every rank of a mesh),
    soft-capped."""
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"])
    else:
        logits = _bf16_matmul(x, params["lm_head"])
    return softcap(logits, cfg.final_softcap)


def decode_step(cfg: ArchConfig, params: Dict, state: Dict,
                tokens: torch.Tensor, plan=None) -> Tuple[Dict, torch.Tensor]:
    """tokens [B] -> (state', logits [B, Vpad] f32).  The state's pools,
    caches and recurrent states are written in place (the JAX step donates
    its state for the same reason: they are never copied); ``pos``
    advances by one.  A vision model decodes text only, as the JAX
    package serves it.  ``plan``: the serving `shard.ShardingPlan`,
    threaded to every projection (None: one device)."""
    x = embed(tokens[:, None], params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    table = state.get("page_table")
    layers, x = tfm.stack_decode(cfg, params["layers"], state["layers"], x,
                                 state["pos"], table, plan=plan)
    logits = lm_logits(cfg, params, _norm(cfg)(x, params["final_norm"]))
    new_state = {"layers": layers, "pos": state["pos"] + 1}
    if table is not None:
        new_state["page_table"] = table
    return new_state, logits[:, 0, :]
