"""Foundational layers: dense projection, norms, rotary embedding, MLP,
embedding and initialisers.

Params are nested dicts of tensors (projections [d_in, d_out]).  Compute
follows the JAX package's mixed-precision policy and its cast order:
params f32, matmul operands bf16 with f32 accumulation, norms and softmax
in f32, activations carried in bf16 between layers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api import dispatch as _dispatch
from repro_torch.kernels.ref import apply_activation

COMPUTE_DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, lead=()) -> torch.Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    return torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                       device=gen.device, dtype=torch.float32).mul_(scale)


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to bf16 and the sum in f32 (the
    products of bf16 values are exact in f32).  x's f32 copy takes the
    standard strides: the CPU's product can sum in another order for x
    whose size-1 axes carry other strides, and a row's bits must not
    depend on how x's strides came about."""
    return torch.matmul(
        x.to(COMPUTE_DTYPE).to(torch.float32,
                               memory_format=torch.contiguous_format),
        w.to(COMPUTE_DTYPE).float())


def dense(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
          activation: Optional[str] = None, plan=None) -> torch.Tensor:
    """act(x @ w + bias).  ``w`` is a raw [d_in, d_out] matrix or a leaf
    registered with `repro_torch.api.dispatch` (a CompressedFC: the
    aida, acsr, int8, codebook4 and dense modes).  A compressed leaf takes
    x in f32, fuses bias and activation into its kernel's epilogue and
    casts the output to bf16; a raw matrix multiplies in bf16 with f32
    accumulation, adds the bias in f32, then casts to bf16 and applies the
    activation.

    ``plan`` (a `repro_torch.shard.ShardingPlan`) serves over a mesh: a
    compressed leaf, or this rank's `shard.Band` of one, runs its band
    through the same kernels and gathers the bands
    (`shard.apply_fc_sharded`); a raw band multiplies its columns and
    gathers them before the same bias and epilogue."""
    band = _band(w, plan)
    if band == "compressed":
        from repro_torch.shard import apply_fc_sharded
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        y = apply_fc_sharded(plan, w, x2, bias=bias, activation=activation)
        return y.reshape(*lead, y.shape[-1]).to(COMPUTE_DTYPE)
    apply = _dispatch.applier_for(w)
    if apply is not None:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        y = apply(w, x2, bias=bias, activation=activation)
        return y.reshape(*lead, y.shape[-1]).to(COMPUTE_DTYPE)
    if band == "raw":             # this rank's columns, then everyone's
        from repro_torch.shard.apply import gather
        y = gather(plan, _bf16_matmul(x, w.local), w.n_out)
    else:
        y = _bf16_matmul(x, w)
    if bias is not None:
        y = y + bias.float()
    y = y.to(COMPUTE_DTYPE)
    if activation is not None:
        y = apply_activation(activation, y.float()).to(COMPUTE_DTYPE)
    return y


def _band(w, plan) -> Optional[str]:
    """How ``dense`` runs ``w`` under ``plan``: "compressed" (a
    CompressedFC or its Band, over a mesh), "raw" (a raw matrix's Band) or
    None (the single-device path)."""
    from repro_torch.shard.partition import Band
    if isinstance(w, Band):
        if plan is None:
            raise ValueError("a banded projection runs over its mesh: pass "
                             "the session's plan")
        return "raw" if isinstance(w.local, torch.Tensor) else "compressed"
    if plan is not None and plan.tp > 1 and \
            _dispatch.applier_for(w) is not None:
        return "compressed"
    return None


def rms_norm_init(d: int, lead=(), device=None):
    # gemma-style (1 + scale)
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                                 device=device)}


def rms_norm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(COMPUTE_DTYPE)


def layer_norm_init(d: int, lead=(), device=None):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(COMPUTE_DTYPE)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half split. x [B, H, T, D], positions [B, T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None, :, None].float() * freqs    # [B,1,T,half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool = True,
             lead=()):
    p = {"up": dense_init(gen, d, f, lead=lead),
         "down": dense_init(gen, f, d, lead=lead)}
    if gated:
        p["gate"] = dense_init(gen, d, f, lead=lead)
    return p


def mlp(x: torch.Tensor, p, act: str = "silu", plan=None) -> torch.Tensor:
    if "gate" in p:
        # the activation fuses into the gate projection's kernel epilogue
        up = dense(x, p["gate"], activation=act, plan=plan) \
            * dense(x, p["up"], plan=plan)
    else:
        up = dense(x, p["up"], activation=act, plan=plan)
    return dense(up, p["down"], plan=plan)


def embed_init(gen: torch.Generator, vocab: int, d: int):
    return {"table": torch.randn((vocab, d), generator=gen,
                                 device=gen.device,
                                 dtype=torch.float32).mul_(d ** -0.5)}


def embed(tokens: torch.Tensor, p) -> torch.Tensor:
    return p["table"][tokens.long()].to(COMPUTE_DTYPE)


def unembed(x: torch.Tensor, p) -> torch.Tensor:
    """Tied head: logits = x @ table.T (f32 out)."""
    return _bf16_matmul(x, p["table"].T)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
