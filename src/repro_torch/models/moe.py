"""Mixture-of-Experts FFN (mixtral 8 experts / top-2, dbrx 16 / top-4).

GShard / Switch capacity-bounded dispatch, as in the JAX package's
``models/moe.py``: tokens are cut into groups of ``min(group_size, B*T)``,
each group sends at most ``capacity = max(1, int(gs * top_k * cf / E))``
tokens to an expert (a token's place in an expert's buffer is the running
count of that expert over the group's (token, choice) pairs, in order;
the overflow is dropped), the kept gates are renormalised over the top-k,
and the Switch load-balancing aux loss comes back beside the output.

The router runs in f32.  The expert FFNs are plain bf16 batched products
over the stacked expert weights [E, ...] (the reference leaves them to
XLA outside any Pallas kernel), with the one-hot dispatch and combine
tensors in bf16 as there, and summed in f32 throughout as there (cuBLAS
may otherwise add a bf16 product's split-K partials in bf16; see
:func:`_f32_sums`).  The reference casts the f32 expert stacks to
bf16 on every call; :func:`serving_copy` makes that cast once for serving,
which gives the same bits.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import COMPUTE_DTYPE, dense_init

EXPERTS = ("gate", "up", "down")


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int,
             lead=()) -> Dict:
    lead = tuple(lead)

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(scale)
    return {"router": dense_init(gen, d, n_experts, lead=lead),
            "gate": normal((n_experts, d, f), d ** -0.5),
            "up": normal((n_experts, d, f), d ** -0.5),
            "down": normal((n_experts, f, d), f ** -0.5)}


def serving_copy(p: Dict) -> Dict:
    """The MoE params with the expert stacks cast to bf16 once (the router
    stays f32)."""
    return {k: v.to(COMPUTE_DTYPE) if k in EXPERTS else v
            for k, v in p.items()}


@contextlib.contextmanager
def _f32_sums():
    """Keep cuBLAS from reducing bf16 products in bf16 for the block's
    duration, restoring the process's setting afterwards (no effect on the
    CPU; a backward through these products runs under the process's
    setting)."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def moe_apply(p: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              group_size: int = 1024, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D] bf16, aux loss f32 scalar)."""
    b, t, d = x.shape
    n_tok = b * t
    gs = min(group_size, n_tok)
    if n_tok % gs:
        raise ValueError(f"{n_tok} tokens do not split into groups of {gs}")
    groups = n_tok // gs
    xg = x.reshape(groups, gs, d)
    capacity = max(1, int(gs * top_k * capacity_factor / n_experts))

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                    # [g, s, e]
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)   # [g, s, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch aux loss: fraction of tokens x fraction of probability
    me = probs.mean(dim=(0, 1))
    first = torch.nn.functional.one_hot(gate_idx[..., 0], n_experts)
    aux = n_experts * torch.sum(me * first.float().mean(dim=(0, 1)))

    # place of each (token, choice) in its expert's capacity buffer
    sel = torch.nn.functional.one_hot(gate_idx, n_experts)   # [g,s,k,e]
    flat = sel.reshape(groups, gs * top_k, n_experts)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(
        groups, gs, top_k, n_experts)
    keep = (pos >= 0) & (pos < capacity)
    pos_oh = torch.nn.functional.one_hot(
        torch.clamp(pos, 0, capacity - 1), capacity).float() * keep[..., None]
    dispatch = pos_oh.sum(dim=2)                              # [g,s,e,c]
    combine = (pos_oh * gate_vals[..., None, None]).sum(dim=2)

    with _f32_sums():
        expert_in = torch.einsum("gsec,gsd->gecd",
                                 dispatch.to(COMPUTE_DTYPE),
                                 xg.to(COMPUTE_DTYPE))        # [g,e,c,d]
        gate_h = torch.einsum("gecd,edf->gecf", expert_in,
                              p["gate"].to(COMPUTE_DTYPE))
        up_h = torch.einsum("gecd,edf->gecf", expert_in,
                            p["up"].to(COMPUTE_DTYPE))
        h = torch.nn.functional.silu(gate_h.float()).to(COMPUTE_DTYPE) * up_h
        expert_out = torch.einsum("gecf,efd->gecd", h,
                                  p["down"].to(COMPUTE_DTYPE))
        y = torch.einsum("gsec,gecd->gsd", combine.to(COMPUTE_DTYPE),
                         expert_out)
    return y.reshape(b, t, d), aux.float()
