"""Tensor-parallel compressed FC and paged attention, one rank's share.

`apply_fc_sharded` runs one compressed projection over the plan's model
axis: the rank holds a band of the compressed matrix (a contiguous run of
ACSR row blocks, or of int8 / codebook4 output channels) and runs the
existing hand-written kernel (K1, K4, K5) on its band only.  Combine
policy:

* ``"gather"`` (default, every mode): row partitioning.  Each output
  element is produced wholly on one rank, and the band's launch follows
  the split of the whole matrix (``split``: K1's row-block count, K4 /
  K5's channel count), so a band's rows carry the bits of the same rows
  of the whole launch; the bands are all-gathered along the feature axis
  and the padded rows sliced off.
* ``"psum"`` (int8 only): input partitioning.  A rank holds a band of q's
  columns, multiplies it with the same band of x (``torch.matmul``, as the
  JAX package does outside any kernel), the partial sums are all-reduced,
  and the per-channel scale, bias and activation run once on the sum.
  ACSR modes cannot split columns (col_idx addresses the whole input),
  which is why gather is the default everywhere.

A whole leaf that the model axis does not divide runs whole on every rank
(`partition.prepare_params` pads compressed leaves so that never happens
to them).

`paged_attention_sharded` / `paged_attention_chunk_sharded` do the same
for K2 / K3: where the pool is banded by KV heads, a rank runs the kernel
on its heads (and their query groups) and the head outputs are gathered.
K2 / K3 split a query's keys by its context alone (under the whole
geometry's tuned range, ``split_hkv``), so a head group gets the whole
launch's bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kvstore as kvs
from repro_torch.core import sparse_fc as sfc
from repro_torch.kernels import ref
from repro_torch.shard import comm, partition
from repro_torch.shard.partition import Band


def _band_bias(plan, bias: Optional[torch.Tensor],
               rows: int) -> Optional[torch.Tensor]:
    """This rank's slice of ``bias`` padded to ``rows * tp`` rows."""
    if bias is None:
        return None
    full = rows * plan.tp
    bias = torch.nn.functional.pad(bias.float(), (0, full - bias.shape[0]))
    return bias[plan.band(full)]


def apply_fc_sharded(plan, layer, x: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W.T + bias) over ``plan``'s model axis, for a
    single-layer leaf: a :class:`Band` (the session's prepared params) or
    a whole CompressedFC (cut to this rank's band here).  x [B, n_in];
    returns f32 [B, n_out], the same on every rank of the group."""
    if not isinstance(layer, Band):
        if plan.tp == 1 or not partition.shardable(layer, plan.tp):
            return sfc.apply_fc(layer, x, bias=bias, activation=activation)
        layer = partition.band_leaf(plan, layer)
    local = layer.local
    if layer.policy == "psum":
        cols = plan.band(x.shape[-1])
        acc = torch.matmul(x[:, cols].float(), local.qt.q.float().T)
        acc = comm.all_reduce_sum(acc, plan.group)
        n = layer.n_out
        y = acc[:, :n] * local.qt.scale.reshape(1, -1)[:, :n]
        if bias is not None:
            y = y + bias.float()
        return ref.apply_activation(activation, y)
    # the card's kernels apply the activation element by element in their
    # epilogue; on the CPU it runs after the gather (_whole_epilogue)
    cpu = x.device.type == "cpu"
    y = sfc.apply_fc(local, x,
                     bias=_band_bias(plan, bias, sfc.stored_rows(local)),
                     activation=None if cpu else activation,
                     split=layer.split)
    if cpu and activation is not None:
        return _whole_epilogue(plan, layer, y, activation)
    return gather(plan, y, layer.n_out)


def _whole_epilogue(plan, layer: Band, y: torch.Tensor,
                    activation: str) -> torch.Tensor:
    """The plain versions' activation on the gathered rows, in the layout
    and length the whole leaf's plain version applies it in ([rows, B]
    for K1's, [B, rows] for K4 / K5's and dense's).  torch's vectorised
    CPU activations round a tensor's last few elements by a scalar path,
    so a band's own tail would get other bits than the same elements
    inside the whole."""
    rows = layer.split * (layer.local.blocked.block_rows
                          if layer.local.mode in ("acsr", "aida") else 1)
    y = comm.all_gather_cat(y, plan.group, dim=-1)[:, :rows]
    if layer.local.mode in ("acsr", "aida"):
        y = ref.apply_activation(activation, y.T.contiguous()).T
    else:
        y = ref.apply_activation(activation, y.contiguous())
    return y[:, :layer.n_out]


def gather(plan, y: torch.Tensor, n_out: int) -> torch.Tensor:
    """The ranks' output bands ``y`` [..., band] joined along the feature
    axis and cut to ``n_out``."""
    return comm.all_gather_cat(y, plan.group, dim=-1)[..., :n_out]


# ------------------------------------------------- paged attention (kv)
def kv_heads(plan, n_kv: int, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's KV heads of ``t`` (every head along ``dim``) where the
    plan bands the pool, else ``t``."""
    if plan is None or not plan.kv_banded(n_kv):
        return t
    return t.narrow(dim, plan.band(n_kv).start, n_kv // plan.tp)


def _query_heads(plan, n_kv: int, q: torch.Tensor, pool) -> torch.Tensor:
    """The query heads of this rank's KV heads (GQA groups are contiguous
    per kv head); checks that ``pool`` holds exactly those."""
    hl = n_kv // plan.tp
    if pool.k_pages.shape[-3] != hl:
        raise ValueError(f"the pool holds {pool.k_pages.shape[-3]} kv "
                         f"heads, not this rank's {hl} of {n_kv}")
    g = q.shape[1] // n_kv
    return q.narrow(1, plan.rank * hl * g, hl * g).contiguous()


def paged_attention_sharded(plan, q: torch.Tensor, pool, table: torch.Tensor,
                            cur_pos: torch.Tensor, window: int, *,
                            n_kv: int, scale: Optional[float] = None,
                            cap: Optional[float] = None) -> torch.Tensor:
    """Decode paged attention (q [B, H, Dh], every head) over ``plan``'s
    model axis: where the ``n_kv`` heads divide tp, ``pool`` is this rank's
    head band, the rank runs K2 on its heads and the outputs are gathered
    along the head axis; otherwise ``pool`` is whole and every rank runs
    every head.  Returns [B, H, Dh] f32."""
    if plan is None or not plan.kv_banded(n_kv):
        return kvs.paged_attention(q, pool, table, cur_pos, window,
                                   scale=scale, cap=cap)
    o = kvs.paged_attention(_query_heads(plan, n_kv, q, pool), pool, table,
                            cur_pos, window, scale=scale, cap=cap,
                            split_hkv=n_kv)
    return comm.all_gather_cat(o, plan.group, dim=1)


def paged_attention_chunk_sharded(plan, q: torch.Tensor, pool,
                                  table: torch.Tensor, q_pos: torch.Tensor,
                                  window: int, *, n_kv: int,
                                  scale: Optional[float] = None,
                                  cap: Optional[float] = None
                                  ) -> torch.Tensor:
    """Chunked-prefill paged attention (q [B, H, C, Dh] at ``q_pos`` [B,
    C]) over the plan's model axis: the K3 twin of
    :func:`paged_attention_sharded`."""
    if plan is None or not plan.kv_banded(n_kv):
        return kvs.paged_attention_chunk(q, pool, table, q_pos, window,
                                         scale=scale, cap=cap)
    o = kvs.paged_attention_chunk(_query_heads(plan, n_kv, q, pool), pool,
                                  table, q_pos, window, scale=scale,
                                  cap=cap, split_hkv=n_kv)
    return comm.all_gather_cat(o, plan.group, dim=1)
