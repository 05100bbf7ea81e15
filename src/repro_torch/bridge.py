"""Carry the JAX package's parameters and decode state into the port.

The caller hands over the reference's trees with every array already
turned into a numpy array (``jax.tree.map(np.asarray, tree)`` keeps the
reference's containers and swaps their arrays); this module reads those
containers by their field names and never imports the reference.

Covered: raw param dicts of every family (the dense family's, gemma2's
post-norms ``ln1p`` / ``ln2p``, layer norms' ``scale`` / ``bias``, the
MoE family's ``moe`` router and [L, E, d, f] expert stacks, hymba's
``mamba`` / ``ln_ssm`` subtrees, the rwkv6 family's ``tm`` / ``cm`` trees
and an audio model's ``frontend``), ``CompressedFC`` in all five modes
(int8's ``QTensor`` codes and scales, codebook4's packed codes and
centroids), stacked or single ``BlockedACSR`` (int16 or int32 col_idx,
uint8 codes or f32 / bf16 values, [L, 16] centroids), the decode states
(``PagedKV`` pools, dense ``KVCache`` (k, v, pos), hymba's ``mamba``
conv / h, rwkv6's ``tm_prev`` / ``cm_prev`` / ``S``, ``pos``,
``page_table``) and the training state (``TrainState(params, OptState(
step, m, v))``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.core.sparse_fc import CompressedFC
from repro_torch.kernels.acsr_spmv import BlockedACSR
from repro_torch.kvstore.pool import PagedKV
from repro_torch.models.kvcache import KVCache
from repro_torch.optim.adamw import OptState
from repro_torch.train.trainer import TrainState


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.array(a, order="C", copy=True)     # a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _blocked(b, device) -> BlockedACSR:
    return BlockedACSR(
        values=tensor(b.values, device), col_idx=tensor(b.col_idx, device),
        row_nnz=tensor(b.row_nnz, device), shape=tuple(b.shape),
        block_rows=int(b.block_rows), nnz=int(b.nnz),
        centroids=None if b.centroids is None
        else tensor(b.centroids, device))


def _compressed(c, device) -> CompressedFC:
    return CompressedFC(
        mode=c.mode, shape=tuple(c.shape),
        dense=None if c.dense is None else tensor(c.dense, device),
        qt=None if c.qt is None else QTensor(
            tensor(c.qt.q, device), tensor(c.qt.scale, device)),
        codes_packed=None if c.codes_packed is None
        else tensor(c.codes_packed, device),
        centroids=None if c.centroids is None
        else tensor(c.centroids, device),
        blocked=None if c.blocked is None else _blocked(c.blocked, device))


def from_reference(tree: Any, device=None) -> Any:
    """Convert a numpy-leaved reference tree (params, paged decode state
    or training state) into the port's containers on ``device``."""
    name = type(tree).__name__
    if name == "CompressedFC":
        return _compressed(tree, device)
    if name == "BlockedACSR":
        return _blocked(tree, device)
    if name == "TrainState":
        return TrainState(from_reference(tree.params, device),
                          from_reference(tree.opt, device))
    if name == "OptState":
        return OptState(*(from_reference(a, device)
                          for a in (tree.step, tree.m, tree.v)))
    if name == "PagedKV":
        return PagedKV(*(None if a is None else tensor(a, device)
                         for a in (tree.k_pages, tree.v_pages, tree.k_scale,
                                   tree.v_scale)))
    if name == "KVCache":
        return KVCache(*(tensor(a, device) for a in (tree.k, tree.v,
                                                      tree.pos)))
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tensor(tree, device)


def to_device(tree: Any, device) -> Any:
    """Move a port param, decode-state or training-state tree to
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, CompressedFC):
        return CompressedFC(tree.mode, tree.shape,
                            dense=to_device(tree.dense, device),
                            qt=to_device(tree.qt, device),
                            codes_packed=to_device(tree.codes_packed, device),
                            centroids=to_device(tree.centroids, device),
                            blocked=to_device(tree.blocked, device))
    if isinstance(tree, QTensor):
        return QTensor(to_device(tree.q, device),
                       to_device(tree.scale, device))
    if isinstance(tree, BlockedACSR):
        return BlockedACSR(to_device(tree.values, device),
                           to_device(tree.col_idx, device),
                           to_device(tree.row_nnz, device), tree.shape,
                           tree.block_rows, tree.nnz,
                           to_device(tree.centroids, device),
                           to_device(tree.chunk_off, device))
    if isinstance(tree, (PagedKV, KVCache, OptState, TrainState)):
        return type(tree)(*(to_device(a, device) for a in tree))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree
