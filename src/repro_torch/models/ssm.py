"""Recurrent mixers: RWKV6 (Finch) time mix and channel mix, and Mamba
(hymba's SSM heads), for a whole sequence and for one decode token.  The
RWKV6 sequence path runs the WKV recurrence through ``ops.rwkv6`` (K9 on
the card); Mamba's selective scan is plain ops (``ops.mamba``), as in the
JAX package.  A decode token carries O(1) state: for RWKV6 the previous
token's normed input and the [H, dh, dh] WKV state, for Mamba the last
K - 1 conv inputs and the [D, N] SSM state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (COMPUTE_DTYPE, _bf16_matmul, dense,
                                       dense_init)


def rwkv6_time_mix_init(gen: torch.Generator, d: int, d_head: int = 64,
                        lora: int = 64, lead=()) -> Dict:
    h = d // d_head
    lead = tuple(lead)
    dev = gen.device
    return {
        "mu": torch.rand(lead + (5, d), generator=gen, device=dev),
        "w0": torch.full(lead + (d,), -4.0, device=dev),
        "w_A": dense_init(gen, d, lora, scale=0.01, lead=lead),
        "w_B": dense_init(gen, lora, d, scale=0.01, lead=lead),
        "wr": dense_init(gen, d, d, lead=lead),
        "wk": dense_init(gen, d, d, lead=lead),
        "wv": dense_init(gen, d, d, lead=lead),
        "wg": dense_init(gen, d, d, lead=lead),
        "u": torch.randn(lead + (h, d_head), generator=gen,
                         device=dev).mul_(0.1),
        "ln_scale": torch.ones(lead + (d,), device=dev),
        "ln_bias": torch.zeros(lead + (d,), device=dev),
        "wo": dense_init(gen, d, d, lead=lead),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` [B, D] before the first token."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _heads(x: torch.Tensor, d_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, d_head] (a view)."""
    b, t, d = x.shape
    return x.reshape(b, t, d // d_head, d_head).transpose(1, 2)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor, i: int):
    """x + (x_shifted - x) * mu[i] in the JAX package's cast order: the
    difference in bf16, the rest in f32, rounded to bf16."""
    return (x + (xs - x) * mu[i]).to(COMPUTE_DTYPE)


def _decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay exp(-exp(w0 + tanh(xw @ w_A) @ w_B)) in
    (0, 1), f32 (w_A and w_B are raw f32 products, as in the reference)."""
    wlog = p["w0"] + torch.tanh(xw.float() @ p["w_A"]) @ p["w_B"]
    return torch.exp(-torch.exp(wlog))


def rwkv6_time_mix(p: Dict, x: torch.Tensor, prev_x: torch.Tensor, *,
                   d_head: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] bf16, prev_x [B, D] (the token before this segment) ->
    (out [B, T, D] bf16, new prev [B, D])."""
    xs = _shift(x, prev_x)
    mu = p["mu"][:, None, None, :]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu, i) for i in range(5))
    r = dense(xr, p["wr"])
    k = dense(xk, p["wk"])
    v = dense(xv, p["wv"])
    g = dense(xg, p["wg"])
    w = _decay(p, xw)                                     # [B, T, D]
    o = ops.rwkv6(_heads(r, d_head), _heads(k, d_head), _heads(v, d_head),
                  _heads(w, d_head), p["u"])              # [B, H, T, dh]
    b, h, t, dh = o.shape
    o = o.transpose(1, 2).reshape(b, t, h * dh)
    o = _group_norm(o, p["ln_scale"], p["ln_bias"], h)
    o = o * torch.nn.functional.silu(g.float())
    return dense(o.to(COMPUTE_DTYPE), p["wo"]), x[:, -1, :]


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-5) -> torch.Tensor:
    b, t, d = x.shape
    xg = x.float().reshape(b, t, groups, d // groups)
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, t, d) * scale + bias


def rwkv6_time_mix_decode(p: Dict, state: Dict, x: torch.Tensor, *,
                          d_head: int = 64) -> Tuple[Dict, torch.Tensor]:
    """One token, x [B, 1, D]; state {"prev" [B, D], "S" [B, H, dh, dh]}
    -> (new state, out [B, 1, D])."""
    xs = state["prev"][:, None, :]
    mu = p["mu"][:, None, None, :]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu, i) for i in range(5))
    r = dense(xr, p["wr"])[:, 0]
    k = dense(xk, p["wk"])[:, 0]
    v = dense(xv, p["wv"])[:, 0]
    g = dense(xg, p["wg"])[:, 0]
    w = _decay(p, xw)[:, 0]
    b, d = r.shape
    h = d // d_head

    def hview(z):
        return z.reshape(b, h, d_head).float()
    s, o = ops.rwkv6_decode_step(state["S"], hview(r), hview(k), hview(v),
                                 hview(w), p["u"])
    o = _group_norm(o.reshape(b, 1, d), p["ln_scale"], p["ln_bias"], h)
    o = o * torch.nn.functional.silu(g.float())[:, None, :]
    out = dense(o.to(COMPUTE_DTYPE), p["wo"])
    return {"prev": x[:, 0, :], "S": s}, out


def rwkv6_channel_mix_init(gen: torch.Generator, d: int, f: int,
                           lead=()) -> Dict:
    lead = tuple(lead)
    return {"mu": torch.rand(lead + (2, d), generator=gen, device=gen.device),
            "wk": dense_init(gen, d, f, lead=lead),
            "wv": dense_init(gen, f, d, lead=lead),
            "wr": dense_init(gen, d, d, lead=lead)}


def _channel(p: Dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    mu = p["mu"][:, None, None, :]
    xk, xr = _mix(x, xs, mu, 0), _mix(x, xs, mu, 1)
    k = torch.square(torch.relu(dense(xk, p["wk"]).float()))
    out = torch.sigmoid(dense(xr, p["wr"]).float()) * \
        dense(k.to(COMPUTE_DTYPE), p["wv"]).float()
    return out.to(COMPUTE_DTYPE)


def rwkv6_channel_mix(p: Dict, x: torch.Tensor, prev_x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] bf16 -> (out [B, T, D] bf16, new prev [B, D])."""
    return _channel(p, x, _shift(x, prev_x)), x[:, -1, :]


def rwkv6_channel_mix_decode(p: Dict, prev: torch.Tensor, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token, x [B, 1, D] -> (new prev [B, D], out [B, 1, D])."""
    return x[:, 0, :], _channel(p, x, prev[:, None, :])


# ------------------------------------------------------------------ Mamba
def mamba_init(gen: torch.Generator, d: int, state: int = 16,
               conv_k: int = 4, dt_rank: int = None, lead=()) -> Dict:
    dt_rank = max(1, d // 16) if dt_rank is None else dt_rank
    lead = tuple(lead)
    dev = gen.device
    a = torch.arange(1, state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d, 2 * d, lead=lead),        # x, z
        "conv": torch.randn(lead + (conv_k, d), generator=gen,
                            device=dev).mul_(0.2),
        "x_db": dense_init(gen, d, dt_rank + 2 * state, lead=lead),
        "dt_proj": dense_init(gen, dt_rank, d, scale=dt_rank ** -0.5,
                              lead=lead),
        # softplus(-3) ~ 0.05
        "dt_bias": torch.full(lead + (d,), -3.0, device=dev),
        "A_log": torch.log(a).expand(lead + (d, state)).clone(),
        "D": torch.ones(lead + (d,), device=dev),
        "out_proj": dense_init(gen, d, d, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x [B, T, D], w [K, D], summed tap by tap
    in the JAX package's order."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(k))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` forms it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p: Dict, xi: torch.Tensor, state: int):
    """xi (post-conv, f32) -> (dt, A, B, C): the x_db product as a bf16
    product rounded to bf16, dt = softplus(dt_in @ dt_proj + dt_bias) in
    f32."""
    dt_rank = p["dt_proj"].shape[-2]
    dbc = _bf16_matmul(xi, p["x_db"]).to(COMPUTE_DTYPE).float()
    dt_in, bm, cm = torch.split(dbc, [dt_rank, state, state], dim=-1)
    dt = _softplus(dt_in @ p["dt_proj"] + p["dt_bias"])
    return dt, -torch.exp(p["A_log"]), bm, cm


def mamba_apply(p: Dict, x: torch.Tensor, *, state: int = 16
                ) -> torch.Tensor:
    """x [B, T, D] bf16 -> y [B, T, D] bf16 (training / prefill)."""
    xz = dense(x, p["in_proj"]).float()
    xi, z = xz.chunk(2, dim=-1)
    xi = torch.nn.functional.silu(_causal_conv(xi, p["conv"]))
    dt, a, bm, cm = _ssm_inputs(p, xi, state)
    y = ops.mamba(xi, dt, a, bm, cm) + xi * p["D"]
    y = y * torch.nn.functional.silu(z)
    return dense(y.to(COMPUTE_DTYPE), p["out_proj"])


def mamba_decode(p: Dict, st: Dict, x: torch.Tensor, *, state: int = 16
                 ) -> Tuple[Dict, torch.Tensor]:
    """One token, x [B, 1, D]; st {"conv" [B, K - 1, D], "h" [B, D, N]}
    (f32) -> (new state, out [B, 1, D])."""
    xz = dense(x, p["in_proj"]).float()
    xi, z = xz[:, 0].chunk(2, dim=-1)                      # [B, D]
    conv_buf = torch.cat([st["conv"], xi[:, None, :]], dim=1)
    xi = torch.nn.functional.silu((conv_buf * p["conv"][None]).sum(dim=1))
    dt, a, bm, cm = _ssm_inputs(p, xi, state)
    h, y = ops.mamba_decode_step(st["h"], xi, dt, a, bm, cm)
    y = (y + xi * p["D"]) * torch.nn.functional.silu(z)
    out = dense(y[:, None, :].to(COMPUTE_DTYPE), p["out_proj"])
    return {"conv": conv_buf[:, 1:], "h": h}, out
