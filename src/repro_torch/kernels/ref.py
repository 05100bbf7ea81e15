"""Plain PyTorch versions of the port's hand-written kernels.

Each function repeats its kernel's arithmetic with whole-tensor ops and no
tiling.  A wrapper calls it for tensors that lie on the CPU; on the card
``chip_smoke.py`` holds each kernel against it on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
#: activation codes of the CUDA kernels' fused epilogues
ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}


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


def paged_attention_chunk_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor],
                              table: torch.Tensor, q_pos: torch.Tensor,
                              window: int, scale: float,
                              cap: Optional[float]) -> torch.Tensor:
    """Chunk attention through the page table, with the arithmetic of the
    Pallas chunk kernel: q, K and V upcast to f32 (int8 pages times their
    per-(page, head) scale), scores scaled then soft-capped, masked to
    -1e30 per query where ``table < 0``, past its own ``q_pos`` or outside
    the window, softmax, and ``acc / max(l, 1e-30)``.  -1 entries read
    page 0.  One kv head (and its query group) at a time, so a head's bits
    never depend on the heads beside it: a mesh rank's band of the heads
    gets the bits of the same heads of the whole.  q [B, H, C, Dh], q_pos
    [B, C] -> [B, H, C, Dh] f32."""
    b, h, c, dh = q.shape
    _, hkv, ps, _ = k_pages.shape
    g = h // hkv
    npp = table.shape[1]
    safe = table.long().clamp(min=0)
    k = k_pages[safe].float()                       # [B, P, Hkv, ps, Dh]
    v = v_pages[safe].float()
    if k_scale is not None:
        k = k * k_scale[safe][..., None, None]
        v = v * v_scale[safe][..., None, None]
    pos = torch.arange(npp * ps, device=q.device).reshape(1, 1, npp, ps)
    cur = q_pos.long()[:, :, None, None]                  # [B, C, 1, 1]
    mask = (table >= 0)[:, None, :, None] & (pos <= cur)  # [B, C, P, ps]
    if window >= 0:
        mask = mask & (pos > cur - window)
    qg = q.float().reshape(b, hkv, g, c, dh)
    outs = []
    for i in range(hkv):
        # the products, exp and tanh on this head's own contiguous
        # tensors: the CPU sums a product and rounds a vectorised exp's
        # tail by the tensor's shape, which a head band must not change
        s = torch.einsum("bgqd,bpjd->bgqpj", qg[:, i].contiguous(),
                         k[:, :, i].contiguous()) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        s = torch.where(mask[:, None], s, NEG_INF).reshape(b, g, c,
                                                            npp * ps)
        m = s.max(dim=-1, keepdim=True).values
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        vv = v[:, :, i].reshape(b, npp * ps, dh)
        outs.append(torch.einsum("bgqj,bjd->bgqd", p, vv)
                    / torch.clamp(l, min=1e-30))
    return torch.stack(outs, dim=1).reshape(b, h, c, dh)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor,
                        k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor],
                        table: torch.Tensor, cur_pos: torch.Tensor,
                        window: int, scale: float,
                        cap: Optional[float]) -> torch.Tensor:
    """Decode attention through the page table: the chunk arithmetic of
    :func:`paged_attention_chunk_ref` with one query per sequence, at
    ``cur_pos`` [B].  q [B, H, Dh] -> [B, H, Dh] f32."""
    return paged_attention_chunk_ref(q[:, :, None], k_pages, v_pages,
                                     k_scale, v_scale, table,
                                     cur_pos[:, None], window, scale,
                                     cap)[:, :, 0]


# ------------------------------------------------------ flash attention
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention, the oracle of the JAX package's
    ``kernels/ref.py``: q [B, H, Tq, D], k/v [B, Hkv, Tk, D] (k/v repeated
    over the query group) -> [B, H, Tq, D] f32; the query positions are
    aligned to the end of the keys."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _attention_mask(tq, tk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float())


def _attention_mask(tq: int, tk: int, causal: bool, window: Optional[int],
                    device) -> torch.Tensor:
    qi = torch.arange(tq, device=device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def _flash_scores(q, k, causal, window, softcap, scale):
    """Scores of the flash kernels, GQA by folding the query group:
    s [B, Hkv, G, T, T] f32 (scaled, then soft-capped, not masked) and the
    [T, T] mask."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, t, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s, _attention_mask(t, t, causal, window, q.device)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """K7's arithmetic untiled: f32 scores scaled then soft-capped, masked
    to the finite -1e30 (causal ``ki <= qi``, window ``ki > qi - window``),
    ``o = (exp(s - m) @ v) / max(l, 1e-30)`` and ``lse = m + log(max(l,
    1e-30))``.  q [B, H, T, D], k/v [B, Hkv, T, D] -> (o [B, H, T, D] f32,
    lse [B, H, T, 1] f32)."""
    b, h, t, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    s, mask = _flash_scores(q, k, causal, window, softcap, scale)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float()) / l
    return o.reshape(b, h, t, d), (m + torch.log(l)).reshape(b, h, t, 1)


def _flash_grad_terms(q, k, v, do, lse, delta, causal, window, softcap,
                      scale):
    """p = exp(masked s - lse) and ds = p * (do @ v.T - delta), times the
    softcap's derivative ``1 - (s / cap)**2`` when capped; [B, Hkv, G, T,
    T] f32 each."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    s, mask = _flash_scores(q, k, causal, window, softcap, scale)
    p = torch.exp(torch.where(mask, s, NEG_INF)
                  - lse.float().reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bkgqd,bkcd->bkgqc",
                      do.float().reshape(b, hkv, g, t, d), v.float())
    ds = p * (dp - delta.float().reshape(b, hkv, g, t, 1))
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)
    return p, ds


def flash_attention_dq_ref(q, k, v, do, lse, delta, causal=True,
                           window=None, softcap=None, scale=None):
    """K8's dq untiled: ``ds @ k * scale`` -> [B, H, T, D] f32."""
    b, h, t, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    _, ds = _flash_grad_terms(q, k, v, do, lse, delta, causal, window,
                              softcap, scale)
    return torch.einsum("bkgqc,bkcd->bkgqd", ds,
                        k.float()).reshape(b, h, t, d) * scale


def flash_attention_dkv_ref(q, k, v, do, lse, delta, causal=True,
                            window=None, softcap=None, scale=None):
    """K8's dk / dv untiled, each summed over the query group:
    ``dk = ds.T @ q * scale``, ``dv = p.T @ do`` -> [B, Hkv, T, D] f32."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = (d ** -0.5) if scale is None else scale
    p, ds = _flash_grad_terms(q, k, v, do, lse, delta, causal, window,
                              softcap, scale)
    qg = q.float().reshape(b, hkv, g, t, d)
    dog = do.float().reshape(b, hkv, g, t, d)
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qg) * scale
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dog)
    return dk, dv


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=None,
                            softcap=None, scale=None):
    """The recompute backward untiled, with ``delta = rowsum(do * o)``:
    -> (dq [B, H, T, D], dk, dv [B, Hkv, T, D]) f32."""
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = flash_attention_dq_ref(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_dkv_ref(q, k, v, do, lse, delta, **kw))


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV6 (Finch) WKV recurrence, sequential over T in f32, as the JAX
    package's ``rwkv6_ref``:  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,
    o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t, S_0 = 0.

    r, k, w [B, H, T, Dk], v [B, H, T, Dv], u [H, Dk] -> o [B, H, T, Dv]
    f32.  Differentiable by autograd (the training path on the CPU)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()[None, :, :, None]                      # [1, H, Dk, 1]
    s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    out = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]   # [B, H, Dk, Dv]
        out.append(((s + u * kv) * r[:, :, i, :, None]).sum(dim=-2))
        s = w[:, :, i, :, None] * s + kv
    if not out:
        return torch.zeros((b, h, 0, dv), dtype=torch.float32,
                           device=r.device)
    return torch.stack(out, dim=2)


#: entries of the plain version's [B, rows, K] index tensor per slice of N
LUT_SLICE = 1 << 24


def lut_product_scale(lut: torch.Tensor) -> int:
    """s of the fully-coded product's fixed point: 29 - e, where max |lut|
    = f * 2^e with f in [0.5, 1) (frexp; e = 0 for an all-zero table), so
    every entry of lut * 2^s is below 2^29."""
    m = lut.float().abs().max().reshape(1).cpu()
    return 29 - int(torch.frexp(m).exponent[0])


def lut_product_matmul_ref(x_codes: torch.Tensor, codes_packed: torch.Tensor,
                           lut: torch.Tensor) -> torch.Tensor:
    """Fully-coded FC: out[b, n] = Σ_{k<K} lut[w[n, k], x[b, k]], both
    operands 4-bit codes (weights two per byte, low nibble first).

    x_codes [B, K] uint8, codes_packed [N, K/2] uint8, lut [nc, nc] ->
    [B, N] f32, in the kernel's arithmetic, bit for bit: the table scaled
    by 2^s (:func:`lut_product_scale`, exact); each weight byte's two
    products added in f32 (its pair); each run of four bytes 4q .. 4q + 3
    (zeros past K/2) added in f32, ((p0 + p1) + p2) + p3, and rounded to
    an integer (ties to even); the runs added in int64 (exact, so in any
    order); the total rounded to f32 and scaled by 2^-s.  N is taken in
    slices so the [B, slice, K/2] pair tensor stays near ``LUT_SLICE``
    entries (the whole of it at B 32, N 14336, K 4096 would be 0.9 G)."""
    b, kdim = x_codes.shape
    n, nc = codes_packed.shape[0], lut.shape[0]
    kb = kdim // 2
    s = lut_product_scale(lut)
    table = (lut.double() * 2.0 ** s).float()              # exact
    x0 = x_codes[:, 0::2].long()[:, None, :]               # [B, 1, K/2]
    x1 = x_codes[:, 1::2].long()[:, None, :]
    pad = -kb % 4
    step = max(1, LUT_SLICE // max(1, b * kb))
    out = []
    for n0 in range(0, n, step):
        w = codes_packed[n0:n0 + step].long()[None]        # [1, s, K/2]
        pairs = table[w & 15, x0] + table[w >> 4, x1]      # [B, s, K/2]
        runs = torch.nn.functional.pad(pairs, (0, pad)).reshape(
            b, pairs.shape[1], -1, 4)
        run = (runs[..., 0] + runs[..., 1]) + runs[..., 2]
        run = run + runs[..., 3]
        total = torch.round(run).long().sum(dim=-1)
        out.append((total.double().float().double()
                    * 2.0 ** -s).float())
    if not out:
        return torch.zeros((b, 0), dtype=torch.float32, device=lut.device)
    return torch.cat(out, dim=1)


def mamba_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Selective-SSM (Mamba) scan, sequential over T in f32, as the JAX
    package's ``mamba_ref`` (which no kernel replaces there either: the
    card runs this loop of plain ops too).

    x, dt [B, T, D], A [D, N] (negative), Bm, Cm [B, T, N] -> y [B, T, D]:
    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] x_t[d] B_t[n],
    y_t[d] = sum_n h_t[d, n] C_t[n], h_0 = 0.  Differentiable by
    autograd."""
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    b, t, d = x.shape
    h = torch.zeros((b,) + tuple(A.shape), dtype=torch.float32,
                    device=x.device)
    out = []
    for i in range(t):
        decay = torch.exp(dt[:, i, :, None] * A)          # [B, D, N]
        h = decay * h + (dt[:, i] * x[:, i])[:, :, None] * Bm[:, i, None, :]
        out.append((h @ Cm[:, i, :, None])[..., 0])
    if not out:
        return torch.zeros((b, 0, d), dtype=torch.float32, device=x.device)
    return torch.stack(out, dim=1)
