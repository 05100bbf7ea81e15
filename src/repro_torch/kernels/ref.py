"""Plain PyTorch versions of the port's hand-written kernels.

Each function repeats its kernel's arithmetic with whole-tensor ops and no
tiling.  A wrapper calls it for tensors that lie on the CPU; on the card
``chip_smoke.py`` holds each kernel against it on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def apply_activation(name: Optional[str], y: torch.Tensor) -> torch.Tensor:
    """The fused-epilogue activation table (relu / silu / tanh-gelu)."""
    if name is None or name == "none":
        return y
    if name == "relu":
        return torch.relu(y)
    if name == "silu":
        return torch.nn.functional.silu(y)
    if name == "gelu":
        return torch.nn.functional.gelu(y, approximate="tanh")
    raise ValueError(f"unknown fused activation {name!r}")


def blocked_acsr_spmv_ref(values: torch.Tensor, col_idx: torch.Tensor,
                          row_nnz: torch.Tensor, x: torch.Tensor,
                          centroids: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          activation: Optional[str] = None) -> torch.Tensor:
    """act(W @ x + bias) in the row-balanced slot layout, untiled.

    values / col_idx [nb, rmax, br] (uint8 codes when ``centroids`` [16]
    is given), row_nnz [nb, br], x [K, B] f32, bias [nb*br] f32.  Slot s
    of lane r is live while s < row_nnz[r]; the slot-axis sum is the row
    product.  Returns [nb*br, B] f32 (padded rows included)."""
    nb, rmax, br = values.shape
    if centroids is not None:
        vals = centroids.float()[values.long()]
    else:
        vals = values.float()
    slot = torch.arange(rmax, device=values.device)[None, :, None]
    live = slot < row_nnz[:, None, :]
    gathered = x.float()[col_idx.long()]                   # [nb,rmax,br,B]
    prod = torch.where(live, vals, 0.0)[..., None] * gathered
    y = prod.sum(dim=1).reshape(nb * br, -1)
    if bias is not None:
        y = y + bias.float()[:, None]
    return apply_activation(activation, y)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor,
                        k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor],
                        table: torch.Tensor, cur_pos: torch.Tensor,
                        window: int, scale: float,
                        cap: Optional[float]) -> torch.Tensor:
    """Decode attention through the page table, with the arithmetic of the
    Pallas decode kernel: q, K and V upcast to f32 (int8 pages times their
    per-(page, head) scale), scores scaled then soft-capped, masked to
    -1e30 where ``table < 0``, past ``cur_pos`` or outside the window,
    softmax, and ``acc / max(l, 1e-30)``.  -1 entries read page 0.
    q [B, H, Dh] -> [B, H, Dh] f32."""
    b, h, dh = q.shape
    _, hkv, ps, _ = k_pages.shape
    g = h // hkv
    npp = table.shape[1]
    safe = table.long().clamp(min=0)
    k = k_pages[safe].float()                       # [B, P, Hkv, ps, Dh]
    v = v_pages[safe].float()
    if k_scale is not None:
        k = k * k_scale[safe][..., None, None]
        v = v * v_scale[safe][..., None, None]
    qg = q.float().reshape(b, hkv, g, dh)
    s = torch.einsum("bkgd,bpkcd->bkgpc", qg, k) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(npp * ps, device=q.device).reshape(1, npp, ps)
    cur = cur_pos.long()[:, None, None]
    mask = (table >= 0)[:, :, None] & (pos <= cur)
    if window >= 0:
        mask = mask & (pos > cur - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    s = s.reshape(b, hkv, g, npp * ps)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vv = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, npp * ps, dh)
    o = torch.einsum("bkgc,bkcd->bkgd", p, vv) / torch.clamp(l, min=1e-30)
    return o.reshape(b, h, dh)
